"""CLI entry point: ``python -m ont_tcrconsensus_tpu_torch <run_config.json> [--cpu]``.

Runs the pipeline on the CUDA card; ``--cpu``, or the environment
variable ``TCR_CONSENSUS_FORCE_CPU`` (as in the JAX package's CLI), puts it
on the CPU. The variable only ever selects the CPU: without it and without
``--cpu`` a host with no card raises, it never falls back. The run config
is the JAX package's (same keys, same checks). A non-empty
``TCR_CONSENSUS_DISTRIBUTED`` brings up the process group of a
``distributed`` run from torchrun's variables first. A run stopped by
SIGTERM/SIGINT (or a chaos ``preempt``) exits 143 with every committed
checkpoint intact; ``resume: true`` continues it.
``--report <workdir>`` renders a finished run's artifacts and
``--validate`` checks a run's config, graph, inputs and existing stage
manifests, both without loading torch, so they work on a host whose card
is wedged; ``--live-port`` arms the live plane for the run.

``python -m ont_tcrconsensus_tpu_torch serve <template.json> [--cpu]``
turns the CLI into the warm-serving daemon (:mod:`..serve.daemon`, its
own flags), dispatched ahead of the one-shot parser as in the JAX package.

SIGQUIT (``kill -QUIT``, Ctrl-\\) dumps every thread's stack to stderr
and the process keeps running, from the first thing :func:`main` does; a
run moves the dump into its ``stack_dumps_p<proc>.log`` while its output
tree exists and puts the stderr dump back when it ends.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import signal
import sys


def _install_stack_dump_signal() -> None:
    """SIGQUIT -> every thread's stack on stderr, without killing the
    process: the operator's hook for a wedged run or daemon, as in the JAX
    package's CLI."""
    if not hasattr(signal, "SIGQUIT"):
        return
    try:
        faulthandler.register(signal.SIGQUIT, all_threads=True)
    except (ValueError, OSError, AttributeError):
        pass  # a runtime without signal support: never fatal


def main(argv: list[str] | None = None) -> int:
    _install_stack_dump_signal()
    if argv is None:
        argv = sys.argv[1:]
    # subcommand dispatch ahead of the one-shot parser: `serve` is the
    # long-lived daemon with its own argument surface
    if argv and argv[0] == "serve":
        from ont_tcrconsensus_tpu_torch.serve.daemon import serve_main

        return serve_main(argv[1:])
    parser = argparse.ArgumentParser(
        description="Count unique TCR molecule nanopore consensus reads (PyTorch/CUDA)."
    )
    parser.add_argument(
        "json_config_file",
        help="Path to the analysis run JSON config file (with --report: a finished "
        "run's workdir: the fastq_pass dir, its nano_tcr subdir, or the run config)",
    )
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the CUDA card (so does a "
                        "non-empty TCR_CONSENSUS_FORCE_CPU)")
    parser.add_argument(
        "--report", action="store_true",
        help="Render a run summary from a finished run's artifacts (telemetry.json, "
        "robustness_report.json, stage_timing.tsv, logs/trace.json, history.jsonl); "
        "reads files only and never imports torch",
    )
    parser.add_argument("--json", action="store_true",
                        help="With --report or --validate: the machine-readable dump "
                        "instead of the text (the same exit codes)")
    parser.add_argument(
        "--critical-path", action="store_true",
        help="With --report: the critical path through the executed stage graph "
        "recorded in telemetry.json",
    )
    parser.add_argument(
        "--memory", action="store_true",
        help="With --report: reconcile the static per-node memory estimate with the "
        "measured node-boundary samples",
    )
    parser.add_argument(
        "--live-port", type=int, default=None, metavar="PORT",
        help="Arm the live plane for this run (overrides live_port): /healthz, "
        "/metrics and /progress on 127.0.0.1:PORT and the crash flight recorder; "
        "0 binds an ephemeral port",
    )
    parser.add_argument(
        "--validate", action="store_true",
        help="Dry run: parse the config, scan every input file with the tolerant "
        "parser (record counts and sizes, no device work, no torch import), run the "
        "graftcheck analysis of the declared stage graph, audit an existing workdir's "
        "stage manifests (torn or v1 manifests, full sha256 of completed artifacts), "
        "print a validation report and exit non-zero on any problem",
    )
    args = parser.parse_args(argv)

    if args.json and not (args.report or args.validate):
        parser.error("--json is a --report/--validate option")
    if args.critical_path and not args.report:
        parser.error("--critical-path is a --report option")
    if args.memory and not args.report:
        parser.error("--memory is a --report option")
    if args.live_port is not None and (args.report or args.validate):
        parser.error("--live-port is a run option (it arms a live endpoint for the "
                     "run's duration; --report/--validate exit at once)")

    if args.report:
        # never loads torch: works on a host whose card is wedged
        from ont_tcrconsensus_tpu_torch.obs import report as report_mod

        return report_mod.report_main(
            args.json_config_file, as_json=args.json,
            critical_path=args.critical_path, memory=args.memory,
        )

    if args.validate:
        # never loads torch either
        from ont_tcrconsensus_tpu_torch.io import validate as validate_mod

        return validate_mod.validate_inputs(args.json_config_file, as_json=args.json)

    if os.environ.get("TCR_CONSENSUS_DISTRIBUTED"):
        # the gloo process group from torchrun's MASTER_ADDR, MASTER_PORT,
        # RANK and WORLD_SIZE, before the pipeline is imported; a failed
        # bring-up raises
        from ont_tcrconsensus_tpu_torch.parallel import distributed

        distributed.initialize(required=True)

    from ont_tcrconsensus_tpu_torch.pipeline.run import run_pipeline
    from ont_tcrconsensus_tpu_torch.robustness import shutdown

    cpu = args.cpu or bool(os.environ.get("TCR_CONSENSUS_FORCE_CPU"))
    try:
        run_pipeline(args.json_config_file, device="cpu" if cpu else "cuda",
                     live_port=args.live_port)
    except shutdown.Preempted as p:
        # committed checkpoints are intact; 143 is the conventional SIGTERM
        # status, so an orchestrator reschedules the run
        print(f"preempted: {p}; rerun with resume=true to continue", file=sys.stderr)
        return 143
    return 0


if __name__ == "__main__":
    sys.exit(main())
