"""CLI entry point: ``python -m ont_tcrconsensus_tpu_torch <run_config.json> [--cpu]``.

Runs the pipeline on the CUDA card; ``--cpu`` is the only way onto the
CPU. The run config is the JAX package's (same keys, same checks).
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Count unique TCR molecule nanopore consensus reads (PyTorch/CUDA)."
    )
    parser.add_argument("json_config_file", help="Path to the analysis run JSON config file")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the CUDA card")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    from ont_tcrconsensus_tpu_torch.pipeline.run import run_pipeline

    run_pipeline(args.json_config_file, device="cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
