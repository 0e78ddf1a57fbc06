"""The end-to-end two-round UMI consensus pipeline, on one device.

The counterpart of the JAX package's ``pipeline/run.py`` one-shot run, in
its imperative stage order (which the JAX package pins byte-identical to
its graph executor, so ``executor`` "graph" and "imperative" both run it):

  PHASE A (once):  reference self-homology -> region clusters + precision bar
  PHASE B (per library): fused read pass (primer trim -> EE filter ->
                   align -> UMI locate) -> split by region cluster
  round 1:         UMI cluster @0.93 -> subread select -> batched consensus
                   -> bi-GRU polish (``polish_method: "rnn"``, the default)
  round 2:         consensus align + blast-id filter -> split by region ->
                   UMI cluster @0.97 -> select(min=1) -> counts CSV

Beside the counts it writes the JAX package's QC and report artifacts: the
read-stats, flagstat, split and consensus-filter logs and CSVs, both
error profiles (``error_profile_sample`` reads a round; under
``overlap_qc`` on a worker thread, committed on the main thread before
each round's checkpoint), ``logs/stage_timing.tsv`` (under the JAX graph
executor's stage names, the default executor's), the self-homology logs,
``robustness_report.json`` (retry policy and outcomes, contract counters)
and ``stack_dumps_p0.log`` (SIGQUIT dumps every thread's stack there).

The observation layer (:mod:`..obs`) is armed around the run as in the JAX
package: ``telemetry`` ``on`` (the default) writes ``telemetry.json`` and
appends to ``history.jsonl`` (and ``history_ledger``), ``full`` adds
``logs/trace.json`` and the memory sampler; ``live_port`` serves
``/healthz``, ``/metrics`` and ``/progress`` for the run's duration;
``profile_trace_dir`` records the whole run with ``torch.profiler`` (host
and CUDA activity) as a Chrome trace in that directory; ``stage_timeout_s``
arms the stage watchdog, whose stack dumps go to each library's
``logs/watchdog.log``. The kernels' build directory is the run's
``compile_cache_dir`` (recorded as ``analysis.compile_cache``).

Every device pass runs on ``device``: CUDA unless the caller asks for the
CPU, and a CUDA request without a card raises. Nothing falls back to the
CPU: a retry runs again on the same device.
"""

from __future__ import annotations

import atexit
import dataclasses
import faulthandler
import glob
import json
import os
import re
import shutil
import signal
import sys
import tempfile
import time

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.cluster import regions as regions_mod
from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.io import bucketing, fastx, layout
from ont_tcrconsensus_tpu_torch.obs import device as obs_device
from ont_tcrconsensus_tpu_torch.obs import history as obs_history
from ont_tcrconsensus_tpu_torch.obs import live as obs_live
from ont_tcrconsensus_tpu_torch.obs import metrics as obs_metrics
from ont_tcrconsensus_tpu_torch.obs import report as obs_report
from ont_tcrconsensus_tpu_torch.obs import trace as obs_trace
from ont_tcrconsensus_tpu_torch.ops import _build
from ont_tcrconsensus_tpu_torch.parallel import budget as budget_mod
from ont_tcrconsensus_tpu_torch.pipeline import overlap, stages
from ont_tcrconsensus_tpu_torch.pipeline.assign import AssignEngine, ReferencePanel, run_assign
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
from ont_tcrconsensus_tpu_torch.qc import artifacts, error_profile, umi_overlap
from ont_tcrconsensus_tpu_torch.qc.timing import StageTimer
from ont_tcrconsensus_tpu_torch.robustness import contracts, lockcheck, retry, watchdog

# fallback precision bar when no reference pair survives the homology filter
DEFAULT_BLAST_ID_BAR = 0.99

# knobs that change results and that later slices of the port implement
_NOT_YET = (
    ("mesh_shape", bool, "mesh_shape needs the multi-GPU mesh slice of the port"),
    ("distributed", bool, "distributed needs the multi-GPU mesh slice of the port"),
    ("resume", bool, "resume needs the robustness slice of the port"),
    ("chaos", bool, "chaos needs the robustness slice of the port"),
    ("on_bad_record", lambda v: v != "fail",
     "on_bad_record quarantine/drop needs the robustness slice of the port"),
)


def _log(*parts):
    print(*parts, file=sys.stderr)


def check_supported(cfg: RunConfig) -> None:
    """Raise NotImplementedError for knobs this slice does not implement."""
    for name, active, why in _NOT_YET:
        if active(getattr(cfg, name)):
            raise NotImplementedError(why)


@dataclasses.dataclass
class _RunContext:
    """What every library of a run shares."""

    cfg: RunConfig
    device: torch.device
    panel: ReferencePanel
    engine: AssignEngine
    engine_notrim: AssignEngine
    blast_id_threshold: float
    overlap_consensus: float
    read_batch: int
    budget: budget_mod.BudgetModel
    polisher: object


class _SigquitRunLog:
    """SIGQUIT -> every thread's stack into the run's
    ``stack_dumps_p<proc>.log``, without killing the run.

    ``restore()`` reinstates the pre-run state: a stderr dump if one was
    registered, otherwise the original SIGQUIT disposition, so a library
    caller never inherits a handler from one run.
    """

    def __init__(self):
        self.fh = None
        self.had_stderr_dump = False

    def register(self, nano_dir: str, proc_id: int) -> None:
        if not hasattr(signal, "SIGQUIT"):
            return
        try:
            self.fh = open(os.path.join(nano_dir, f"stack_dumps_p{proc_id}.log"), "a")
            # unregister first so this registration saves the true
            # pre-faulthandler handler; remember a stderr dump to restore
            self.had_stderr_dump = faulthandler.unregister(signal.SIGQUIT)
            # chain=False: chaining would fall through to SIG_DFL, which
            # terminates the process; a dump must never kill the run
            faulthandler.register(signal.SIGQUIT, file=self.fh, all_threads=True)
        except (OSError, ValueError, AttributeError) as exc:
            _log(f"stack-dump registration unavailable: {exc!r}")
            if self.fh is not None:
                self.fh.close()
            self.fh = None
            if self.had_stderr_dump:
                try:
                    faulthandler.register(signal.SIGQUIT, all_threads=True)
                except (OSError, ValueError, AttributeError):
                    pass

    def restore(self) -> None:
        if self.fh is None:
            return
        try:
            faulthandler.unregister(signal.SIGQUIT)
            if self.had_stderr_dump:
                faulthandler.register(signal.SIGQUIT, all_threads=True)
        except (OSError, ValueError, AttributeError):
            pass
        self.fh.close()
        self.fh = None


def enable_build_cache(cache_dir: str | None = None) -> dict:
    """Point the kernel builds at the run's ``compile_cache_dir``: None is
    the package's ``build/torch_kernels/``, ``"off"`` a fresh temporary
    directory (every kernel the process has not loaded yet is built
    anew), anything else that directory. Returns the ``{"armed", "dir"}``
    status recorded as ``analysis.compile_cache`` (the JAX package's
    persistent XLA cache has the same record)."""
    if cache_dir == "off":
        tmp = tempfile.mkdtemp(prefix="tcr_torch_kernels_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        _build.use_build_dir(tmp)
        return {"armed": False, "dir": None}
    resolved = cache_dir or _build.DEFAULT_BUILD_DIR
    _build.use_build_dir(resolved)
    return {"armed": True, "dir": resolved}


def run_pipeline(config_path: str, device: str | torch.device | None = None,
                 live_port: int | None = None):
    """Run the pipeline from a JSON config; {library: {region: count}}.
    ``live_port`` overrides the config's ``live_port``."""
    cfg = RunConfig.from_json(config_path)
    if live_port is not None:
        cfg = dataclasses.replace(cfg, live_port=live_port)
    return run_with_config(cfg, device=device)


def run_with_config(cfg: RunConfig, device: str | torch.device | None = None,
                    timings: dict[str, float] | None = None,
                    ) -> dict[str, dict[str, int]]:
    """Run the full pipeline; returns {library: {region: count}}.

    ``timings``, when given, receives each stage's wall seconds summed over
    the libraries, under the names of ``logs/stage_timing.tsv``, plus
    ``self_homology``: the same spans as that table.

    With ``profile_trace_dir`` set, the whole run is recorded by
    ``torch.profiler`` (CPU activity, and CUDA activity on the card) and
    written there as a Chrome trace, ``run_<time>_<pid>.pt.trace.json``:
    every kernel by name with its device time, the counterpart of the JAX
    package's ``jax.profiler`` capture. The trace grows with the launches
    (a full-size lane makes millions), so it is meant for small lanes.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    run_timer = StageTimer(dev)
    try:
        if cfg.profile_trace_dir:
            return _run_profiled(cfg, dev, run_timer)
        return _run_with_config(cfg, dev, run_timer)
    finally:
        if timings is not None:
            timings.update(run_timer.seconds)


def _run_profiled(cfg: RunConfig, dev: torch.device, run_timer: StageTimer):
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(cfg.profile_trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        return _run_with_config(cfg, dev, run_timer)
    finally:
        prof.stop()
        path = os.path.join(
            cfg.profile_trace_dir,
            f"run_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.pt.trace.json",
        )
        try:
            prof.export_chrome_trace(path)
            _log(f"profiler trace: {path}")
        except (OSError, RuntimeError) as exc:  # the trace must not mask the run's fate
            _log(f"WARNING: could not write the profiler trace: {exc!r}")


def _run_with_config(cfg: RunConfig, dev: torch.device, run_timer: StageTimer):
    """Arm the process-global observation state around the body and disarm
    all of it in one ``finally``, on every exit path, so an embedder's next
    run inherits none of it."""
    # lock checks first: the watchdog, registry and live plane below pick
    # their lock type when they are built
    lockcheck.arm_from_env()
    wd = None
    if cfg.stage_timeout_s:
        wd = watchdog.Watchdog(base_timeout_s=cfg.stage_timeout_s)
        watchdog.activate(wd)
        wd.start()
        _log(f"Watchdog armed: stage_timeout_s={cfg.stage_timeout_s} "
             f"(soft at {watchdog.SOFT_FRACTION:.0%}, auto-scaled by workload size)")
    sampler = None
    run_armed_live = False
    sigquit_log = _SigquitRunLog()
    live_usr1 = obs_live.Sigusr1Hook()
    try:
        if cfg.telemetry != "off":
            obs_metrics.arm()
            if cfg.telemetry == "full":
                obs_trace.arm()
                sampler = obs_device.start_sampler(
                    devices=[dev] if dev.type == "cuda" else [])
        # the live plane arms whatever the telemetry level: its flight ring
        # is the post-mortem context of runs without the trace collector.
        # A plane armed by the caller is left to the caller.
        if cfg.live_port is not None and obs_live.server() is None:
            srv = obs_live.arm(cfg.live_port)
            run_armed_live = True
            live_usr1.install()
            _log(f"Live observability plane on http://127.0.0.1:{srv.port} "
                 "(/healthz /metrics /progress; SIGUSR1 flushes the flight recorder)")
        try:
            return _run_with_config_body(cfg, dev, run_timer, sigquit_log)
        except BaseException as exc:
            # the flight recorder's reason to exist: flush the last events
            # while the process still can
            obs_live.flush_armed(f"crash:{type(exc).__name__}")
            raise
    finally:
        live_usr1.restore()
        if run_armed_live:
            obs_live.disarm()
        if sampler is not None:
            sampler.stop()
        obs_trace.disarm()
        obs_metrics.disarm()
        if wd is not None:
            watchdog.deactivate(wd)
            wd.stop()
        sigquit_log.restore()


def _run_with_config_body(cfg: RunConfig, dev: torch.device, run_timer: StageTimer,
                          sigquit_log: _SigquitRunLog) -> dict[str, dict[str, int]]:
    obs_metrics.analysis_set("compile_cache", enable_build_cache(cfg.compile_cache_dir))
    policy = retry.set_policy(retry.RetryPolicy(
        max_attempts=cfg.retry_max_attempts, base_delay_s=cfg.retry_base_delay_s,
    ))
    recorder = retry.recorder()
    recorder.reset()
    contracts.set_mode(cfg.contracts)
    contracts.reset()
    polisher = _rnn_polisher(cfg, dev) if cfg.polish_method == "rnn" else None
    reference = fastx.read_fasta_dict(cfg.reference_file)
    nano_dir = os.path.join(cfg.fastq_pass_dir, "nano_tcr")
    if os.path.exists(nano_dir):
        raise FileExistsError(f"{nano_dir} exists; remove it to rerun")
    os.makedirs(nano_dir)
    sigquit_log.register(nano_dir, 0)
    # crash and SIGUSR1 flight-recorder flushes land in the output tree
    # (a no-op when the live plane is disarmed)
    obs_live.set_flush_path(os.path.join(nano_dir, "logs", "flight_recorder.json"))

    # PHASE A: reference self-homology
    _log("Mapping reference self homology")
    # timed beside the stage table, not as a span: the JAX package's
    # telemetry has no self_homology stage
    t0 = time.perf_counter()
    homology = regions_mod.self_homology_map(reference, cfg.cluster_identity, device=dev)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    run_timer.add("self_homology", time.perf_counter() - t0)
    _write_homology_artifacts(homology, nano_dir)
    blast_id_threshold = cfg.blast_id_threshold
    overlap_consensus = cfg.minimal_region_overlap_consensus
    if blast_id_threshold is None:
        blast_id_threshold = (homology.max_blast_id if homology.max_blast_id is not None
                              else DEFAULT_BLAST_ID_BAR)
    if overlap_consensus is None:
        overlap_consensus = (homology.max_blast_id if homology.max_blast_id is not None
                             else cfg.minimal_region_overlap)
    if cfg.only_run_reference_self_homology:
        return {}

    panel = ReferencePanel.build(reference, homology.region_cluster, device=dev)
    budget = budget_mod.BudgetModel(
        cfg.hbm_budget_gb if cfg.hbm_budget_gb is not None
        else budget_mod.detect_hbm_gb(dev)
    )
    read_batch = cfg.read_batch_size or budget.read_batch(
        cfg.max_read_length, num_refs=max(len(panel.names), 1),
        band_width=cfg.sw_band_width,
    )
    _log(f"Device batching: read_batch={read_batch}, budget={budget.hbm_gb:.1f} GB on {dev}")
    ctx = _RunContext(
        cfg=cfg, device=dev, panel=panel,
        engine=AssignEngine(
            panel, cfg.umi_fwd, cfg.umi_rev, primers=cfg.primer_sequences(),
            primer_max_dist_frac=cfg.primer_max_dist_frac,
            a5=cfg.max_softclip_5_end, a3=cfg.max_softclip_3_end,
            trim_window=cfg.trim_window, band_width=cfg.sw_band_width,
            fast_denom=4 if cfg.round1_fast_assign else 0, device=dev,
        ),
        # round 2 aligns already-trimmed consensus sequences: no primer search
        engine_notrim=AssignEngine(
            panel, cfg.umi_fwd, cfg.umi_rev, primers=[],
            a5=cfg.max_softclip_5_end, a3=cfg.max_softclip_3_end,
            band_width=cfg.sw_band_width, device=dev,
        ),
        blast_id_threshold=blast_id_threshold, overlap_consensus=overlap_consensus,
        read_batch=read_batch, budget=budget, polisher=polisher,
    )

    fastq_list = sorted(glob.glob(os.path.join(cfg.fastq_pass_dir, "barcode*", "*fastq*")))
    if not fastq_list:
        fastq_list = sorted(glob.glob(os.path.join(cfg.fastq_pass_dir, "*.fastq*")))
    if not fastq_list:
        raise FileNotFoundError(f"no fastq files under {cfg.fastq_pass_dir}")
    # /progress denominators and ETA priors: per-node seconds from the
    # run's own ledger and the cross-run one, for this config fingerprint
    # (the ledger is read only when the plane is armed)
    obs_live.progress_totals(len(fastq_list))
    obs_live.configure_eta_priors(
        [os.path.join(nano_dir, obs_history.HISTORY_BASENAME)]
        + ([cfg.history_ledger] if cfg.history_ledger else []),
        obs_history.config_fingerprint(cfg),
    )
    results: dict[str, dict[str, int]] = {}
    try:
        for fastq in fastq_list:
            obs_live.progress_library(layout.library_name_from_fastq(fastq))
            try:
                lay = layout.init_library_dir(fastq, nano_dir)
                watchdog.set_log_path(os.path.join(lay.logs, "watchdog.log"))
                timer = StageTimer(dev)
                try:
                    results[lay.library] = _run_library(fastq, lay, ctx, timer)
                finally:
                    run_timer.merge(timer)
            finally:
                # a failed library still advances /progress
                obs_live.progress_library_done()
    finally:
        try:
            recorder.write(os.path.join(nano_dir, "robustness_report.json"),
                           policy=policy, contracts=contracts.summary())
        except OSError as exc:  # report trouble must never mask the run's fate
            _log(f"WARNING: could not write robustness report: {exc!r}")
        if cfg.telemetry != "off":
            # the roll-up next to the robustness report, on failing paths
            # too: memory peaks, telemetry.json (+ logs/trace.json at
            # "full"), then the run's ledger entry (which never fails the run)
            try:
                obs_device.finalize_memory([dev] if dev.type == "cuda" else [])
                obs_report.write_run_telemetry(nano_dir, cfg.telemetry)
            except OSError as exc:
                _log(f"WARNING: could not write telemetry artifacts: {exc!r}")
            obs_history.record_run(nano_dir, cfg, backend=dev.type)
    _log("Done running all barcodes!")
    return results


def _write_homology_artifacts(homology, nano_dir: str) -> None:
    with open(os.path.join(nano_dir, "region_cluster_dict.json"), "w") as fh:
        json.dump(homology.region_cluster, fh, indent=4)
    with open(os.path.join(nano_dir, "self_homology_stats.json"), "w") as fh:
        json.dump(homology.stats, fh, indent=4)
    # region -> blast ids of its most-similar partners (the analysis
    # layer's most-similar overlay input)
    most_similar: dict[str, list[float]] = {}
    for qname, tname, bid in homology.most_similar:
        most_similar.setdefault(qname, []).append(bid)
        most_similar.setdefault(tname, []).append(bid)
    with open(os.path.join(nano_dir, "ref_homology_out_most_similar_region_dict.json"),
              "w") as fh:
        json.dump(most_similar, fh, indent=4)
    artifacts.write_self_homology_log(
        homology.stats,
        os.path.join(nano_dir, "ref_homology_out_generate_region_split_dict.log"),
    )


def _rnn_polisher(cfg: RunConfig, dev: torch.device):
    """The bi-GRU polisher of ``polish_method: "rnn"``, or None (vote
    consensus only) when no weights are bundled."""
    from ont_tcrconsensus_tpu_torch.models import polisher as polisher_mod

    params = polisher_mod.load_default_params()
    if params is None:
        _log("polish_method=rnn but no bundled weights; using vote consensus only")
        return None
    # the depth-2 pass only where selection can emit 2-member clusters
    low_params = (
        polisher_mod.load_low_depth_params()
        if cfg.low_depth_polish and cfg.min_reads_per_cluster <= 2 else None
    )
    if cfg.polish_bf16:
        _log("polisher: serving float32 (bf16 serving needs an exactness A/B "
             "certificate for this card, which the port does not have yet)")
    return polisher_mod.make_pipeline_polisher(
        params, min_polish_depth=cfg.min_polish_depth,
        low_depth_params=low_params, device=dev,
    )


def _run_library(fastq, lay, ctx: _RunContext, timer: StageTimer) -> dict[str, int]:
    """One library; under ``overlap_qc`` its side stages run on worker
    threads, drained on a critical-path failure so none outlives it."""
    qc_exec = overlap.StageExecutor(device=ctx.device) if ctx.cfg.overlap_qc else None
    try:
        return _run_library_impl(fastq, lay, ctx, timer, qc_exec)
    except BaseException:
        if qc_exec is not None:
            for name, exc in qc_exec.wait_all():
                _log(f"WARNING: overlapped stage {name} also failed: {exc!r}")
        raise
    finally:
        # the pool's busy/idle split (drained by now on every path)
        if qc_exec is not None:
            qc_exec.record_pool_metrics()


def _side_stage(pending: list, qc_exec, timer: StageTimer, name: str, fn, *args,
                commit=None, units: int = 0, **kwargs) -> None:
    """A stage nothing on the critical path consumes: on a QC worker when
    there is one (``commit(result)`` then runs at the next commit point;
    ``units`` sizes the worker's watchdog deadline), else here, timed under
    ``name``."""
    if qc_exec is not None:
        pending.append((qc_exec.submit(name, fn, *args, units=units, **kwargs), commit))
        return
    with timer.stage(name):
        result = fn(*args, **kwargs)
        if commit is not None:
            commit(result)


def _profile_stage(pending, qc_exec, timer, name, store, ctx, log_path) -> None:
    _side_stage(
        pending, qc_exec, timer, name, error_profile.profile_store, store, ctx.panel,
        sample_size=ctx.cfg.error_profile_sample, device=ctx.device,
        commit=lambda counters: error_profile.write_error_profile_log(*counters, log_path),
        units=ctx.cfg.error_profile_sample,
    )


def _commit_pending_qc(qc_exec, pending: list, timer: StageTimer) -> None:
    """Commit overlapped stages (write their logs, surface their failures)
    in submission order on the main thread; clears the list. Every commit
    point sits before the checkpoint of the round that produced the stage.

    A worker that died of a non-fatal fault (transient, out of memory, a
    lost device) is recomputed here on the main thread, on the same device:
    the inputs are immutable, so the artifact is identical and only the
    overlap is lost. A fatal failure is recorded and raised."""
    for stage, commit in pending:
        try:
            result = qc_exec.commit(stage, timer)
        except Exception as exc:
            cls = retry.classify(exc)
            rec = retry.recorder()
            if cls == "fatal":
                rec.record("overlap.worker", classification=cls,
                           outcome="fatal", error=repr(exc))
                raise
            rec.record("overlap.worker", classification=cls,
                       outcome="retried", error=repr(exc))
            _log(f"WARNING: overlapped stage {stage.name} hit a {cls} "
                 f"fault ({exc!r}); recomputing on the main thread")
            with timer.stage(stage.name):
                result = stage.rerun_sync()
            rec.record("overlap.worker", classification=cls,
                       outcome="recovered", attempt=2)
        if commit is not None:
            commit(result)
        _log(f"qc: {stage.name} computed off the critical path "
             f"({stage.worker_seconds:.1f}s overlapped)")
    pending.clear()


def _run_library_impl(fastq, lay, ctx: _RunContext, timer: StageTimer,
                      qc_exec) -> dict[str, int]:
    cfg, panel, dev = ctx.cfg, ctx.panel, ctx.device
    library = lay.library
    merged_path = os.path.join(lay.fasta, "merged_consensus.fasta")

    # PHASE B + round-1 assignment: one fused pass per batch
    _log("Preprocessing, aligning and UMI-tagging nanopore reads:", library)
    # watchdog guard over per-batch heartbeats (assign.py): a hung dispatch
    # cancels into the transient retry below
    with timer.stage("round1_fused_assign"), watchdog.guard("round1_fused_assign"):
        # the pass is idempotent (it streams the fastq into a fresh store),
        # so a transient fault re-runs it whole
        store, astats = retry.call_with_retry("assign.round1", lambda: run_assign(
            fastq, ctx.engine,
            max_ee_rate=cfg.max_ee_rate_base,
            min_len=cfg.minimal_length,
            minimal_region_overlap=cfg.minimal_region_overlap,
            max_softclip_5_end=cfg.max_softclip_5_end,
            max_softclip_3_end=cfg.max_softclip_3_end,
            batch_size=ctx.read_batch,
            max_read_length=cfg.max_read_length,
            subsample=cfg.dorado_trim_subsample_fastq,
        ))
        with open(os.path.join(lay.logs, "ee_filter.log"), "w") as fh:
            fh.write(f"reads passing EE/length filter: {astats.n_total - astats.n_ee_fail}\n")
            fh.write(f"reads with primer trim: {astats.n_trimmed}\n")
        _write_align_log(astats, os.path.join(lay.logs, f"{library}_region_cluster_split.log"))
        artifacts.write_fastq_stats_log(
            astats, os.path.join(lay.logs, f"{library}_fastq_stats.log"))
        artifacts.write_flagstat_log(astats, os.path.join(lay.logs, f"{library}_flagstat.log"))

    pending: list = []
    if cfg.error_profile_sample:
        _profile_stage(pending, qc_exec, timer, "round1_error_profile", store, ctx,
                       os.path.join(lay.logs, f"{library}_align_error_profile.log"))
    with timer.stage("round1_region_split"):
        groups = stages.group_by_region_cluster(store, panel)
        artifacts.write_region_split_log(
            astats, groups, store, panel.names,
            {n: len(s) for n, s in panel.seqs.items()},
            regions_mod.NEGATIVE_CONTROL_SUFFIXES,
            os.path.join(lay.logs, f"{library}_filter_and_split_reads_by_region_cluster.err"),
        )
    if cfg.write_intermediate_fastas:
        _side_stage(pending, qc_exec, timer, "write_region_fastas", stages.write_region_fastas,
                    groups, store, lay.region_cluster_fasta, "region_cluster")

    # round 1: UMI records per region cluster, ONE batched clustering pass,
    # then ONE library-wide batched consensus polish
    with timer.stage("round1_umi_records"):
        records_by_group: list[tuple[str, list]] = []
        for cluster_key in sorted(groups):
            group_name = f"region_cluster{cluster_key}"
            umis = stages.build_umi_records(store, groups[cluster_key], cfg.max_pattern_dist)
            if not umis:
                continue
            if cfg.write_intermediate_fastas:
                stages.write_umi_fasta(
                    umis, store,
                    os.path.join(lay.umi_fasta, f"{group_name}_detected_umis.fasta"),
                )
            records_by_group.append((group_name, umis))
    with timer.stage("round1_umi_cluster"):
        # the guard makes a hung pass a transient: a hard cancel raises
        # StageTimeout into the retry wrapper (the pass is pure)
        with watchdog.guard("round1_umi_cluster",
                            units=sum(len(u) for _, u in records_by_group)):
            grouped = retry.call_with_retry(
                "cluster.batched_round1", lambda: stages.cluster_and_select_grouped(
                    records_by_group,
                    identity=cfg.vsearch_identity,
                    min_umi_length=cfg.min_umi_length,
                    max_umi_length=cfg.max_umi_length,
                    min_reads_per_cluster=cfg.min_reads_per_cluster,
                    max_reads_per_cluster=cfg.max_reads_per_cluster,
                    balance_strands=cfg.balance_strands,
                    device=dev,
                ))
        selected_by_group: list[tuple[str, list[stages.SelectedCluster]]] = []
        for group_name, _ in records_by_group:
            selected, stat_rows = grouped[group_name]
            cdir = os.path.join(lay.clustering, group_name)
            os.makedirs(cdir, exist_ok=True)
            stages.write_cluster_stats_tsv(
                stat_rows, os.path.join(cdir, "vsearch_cluster_stats.tsv"))
            if selected:
                selected_by_group.append((group_name, selected))
    n_clusters = sum(len(s) for _, s in selected_by_group)
    _log(f"Polishing clusters: {library} "
         f"({n_clusters} clusters over {len(selected_by_group)} region clusters)")
    # guard scaled by the cluster count; the chunk loop heartbeats per
    # dispatch, so only a chunk that stops progressing can expire
    with timer.stage("round1_polish"), watchdog.guard("round1_polish", units=n_clusters):
        by_group = stages.polish_clusters_all(
            selected_by_group, store, max_read_length=cfg.max_read_length,
            polisher=ctx.polisher, budget=ctx.budget, cluster_batch=cfg.cluster_batch_size,
            device=dev,
        )
    # round-1 QC commits before the round-1 checkpoint: once it is marked,
    # a later resume skips round 1, so its log must exist by then
    _commit_pending_qc(qc_exec, pending, timer)
    with timer.stage("round1_consensus"):
        merged_consensus: list[tuple[str, str]] = []
        for group_name, selected in selected_by_group:
            # every selected cluster produced exactly one consensus record
            contracts.check_equal(
                "consensus", f"{group_name} consensus records",
                len(by_group[group_name]), "selected clusters", len(selected),
                detail={"library": library, "group": group_name},
            )
            merged_consensus.extend(by_group[group_name])
        n_written = fastx.write_fasta(merged_path, merged_consensus)
        contracts.check_equal(
            "consensus", "merged_consensus.fasta records written", n_written,
            "in-memory consensus entries", len(merged_consensus),
            detail={"library": library},
        )
        lay.mark_stage_done("round1_consensus", artifacts=[merged_path])
    return _run_round2(lay, ctx, merged_consensus, timer, qc_exec)


_R2_HEADER = re.compile(r"^region_cluster(\d+)_cluster\d+_\d+$")


def _targeted_round2_dispatch(panel, engine, headers):
    """The round-2 targeted dispatcher: each consensus header carries its
    round-1 region cluster, so round 2 aligns it only against that
    cluster's references. ``(dispatch, None)``, or ``(None, reason)`` when
    the targeted pass is unavailable (then the full fused pass runs)."""
    cluster_refs: dict[int, np.ndarray] = {}
    for k in np.unique(panel.cluster_of_region):
        cluster_refs[int(k)] = np.where(panel.cluster_of_region == k)[0].astype(np.int32)

    def cluster_of(name: str) -> int | None:
        m = _R2_HEADER.match(name.partition(" ")[0])
        if m is None:
            return None
        k = int(m.group(1))
        return k if k in cluster_refs else None

    seen: set[int] = set()
    for h in headers:
        k = cluster_of(h)
        if k is None:
            return None, f"header {h.partition(' ')[0]!r} lacks cluster provenance"
        seen.add(k)
    if not seen:
        return None, "no consensus sequences"
    max_c = bucketing.pow2_ceil(max(len(cluster_refs[k]) for k in seen))
    if max_c > 8:
        return None, f"largest region cluster has >8 refs (max_c={max_c})"

    def dispatch(batch, max_ee_rate, min_len):
        cand = np.full((len(batch.ids), max_c), -1, np.int32)
        for row, (nm, v) in enumerate(zip(batch.ids, batch.valid)):
            if v:
                refs = cluster_refs[cluster_of(nm)]
                cand[row, : len(refs)] = refs
        return engine.run_batch_targeted_async(batch, cand, min_len=min_len)

    return dispatch, None


def _run_round2(lay, ctx: _RunContext, merged_consensus, timer: StageTimer,
                qc_exec) -> dict[str, int]:
    cfg, panel = ctx.cfg, ctx.panel
    library = lay.library
    _log("Aligning unique molecule consensus TCR sequences:", library)
    cons_records = [fastx.FastxRecord(h, "", s) for h, s in merged_consensus]
    dispatch = None
    if cfg.round2_targeted_assign:
        dispatch, why_not = _targeted_round2_dispatch(
            panel, ctx.engine_notrim, (h for h, _ in merged_consensus)
        )
        if dispatch is None:
            _log(f"round 2: targeted assign unavailable ({why_not}); "
                 "falling back to the full fused assign")
    qc_rows: list[dict] = []
    with timer.stage("round2_fused_assign"), \
            watchdog.guard("round2_fused_assign", units=len(cons_records)):
        # transient-retried like round 1; qc_rows is cleared before each
        # retry so a half-consumed attempt cannot duplicate QC rows
        cons_store, cstats = retry.call_with_retry("assign.round2", lambda: run_assign(
            cons_records, ctx.engine_notrim,
            max_ee_rate=1.0,  # no quality data on consensus sequences
            min_len=1,
            minimal_region_overlap=ctx.overlap_consensus,
            max_softclip_5_end=cfg.max_softclip_5_end,
            max_softclip_3_end=cfg.max_softclip_3_end,
            batch_size=ctx.read_batch,
            max_read_length=cfg.max_read_length,
            blast_id_threshold=ctx.blast_id_threshold,
            collect_qc=qc_rows,
            dispatch=dispatch,
        ), reset=qc_rows.clear)
        artifacts.write_consensus_filter_artifacts(
            qc_rows, {n: len(s) for n, s in panel.seqs.items()}, lay.logs,
            "merged_consensus", blast_id_threshold=ctx.blast_id_threshold,
            minimal_region_overlap=ctx.overlap_consensus,
        )
        artifacts.write_flagstat_log(
            cstats, os.path.join(lay.logs, "merged_consensus_flagstat.log"))
    pending: list = []
    if cfg.error_profile_sample:
        # overlapped with round-2 clustering; committed before the counts
        # checkpoint
        _profile_stage(pending, qc_exec, timer, "round2_error_profile", cons_store, ctx,
                       os.path.join(lay.logs, "merged_consensus_align_error_profile.log"))

    # round 2: UMI dedup at consensus identity, one batched pass
    with timer.stage("round2_umi_records"):
        region_groups = stages.group_by_region(cons_store, panel)
        if cfg.write_intermediate_fastas:
            stages.write_region_fastas(region_groups, cons_store, lay.region_fasta, "region_")
        region_records: list[tuple[str, list]] = []
        for region, parts in sorted(region_groups.items()):
            umis = stages.build_umi_records(cons_store, parts, cfg.max_pattern_dist)
            if not umis:
                continue
            if cfg.write_intermediate_fastas:
                stages.write_umi_fasta(
                    umis, cons_store,
                    os.path.join(lay.consensus_umi_fasta, f"region_{region}_detected_umis.fasta"),
                )
            region_records.append((region, umis))
    with timer.stage("round2_umi_cluster"), watchdog.guard(
            "round2_umi_cluster", units=sum(len(u) for _, u in region_records)):
        grouped2 = retry.call_with_retry(
            "cluster.batched_round2", lambda: stages.cluster_and_select_grouped(
                region_records,
                identity=cfg.vsearch_identity_consensus,
                min_umi_length=cfg.min_umi_length,
                max_umi_length=cfg.max_umi_length,
                min_reads_per_cluster=1,
                max_reads_per_cluster=cfg.max_reads_per_cluster,
                balance_strands=False,
                device=ctx.device,
            ))
    # round-2 QC commits before the counts checkpoint
    _commit_pending_qc(qc_exec, pending, timer)
    # the JAX graph's round2_counts node; the stage table is written inside
    # it, so (as in the JAX package) the TSV has no round2_counts row while
    # telemetry.json and the trace do
    region_counts: dict[str, int] = {}
    with timer.stage("round2_counts"):
        region_cluster_umis: dict[str, list[str]] = {}
        for region, _ in region_records:
            selected, stat_rows = grouped2[region]
            rdir = os.path.join(lay.clustering_consensus, f"region_{region}")
            os.makedirs(rdir, exist_ok=True)
            stages.write_cluster_stats_tsv(
                stat_rows, os.path.join(rdir, "vsearch_cluster_stats.tsv"))
            if cfg.write_intermediate_fastas:
                fastx.write_fasta(os.path.join(rdir, "smolecule_clusters.fa"), [
                    (str(cl.cluster_id), cons_store.blocks[m.block].decode_one(m.row))
                    for cl in selected for m in cl.members
                ])
            # count = round-2 clusters (unique molecules)
            region_counts[region] = len(selected)
            region_cluster_umis[region] = [cl.members[0].combined for cl in selected]

        counts_csv = stages.write_counts_csv(region_counts, lay.counts)
        # the CSV on disk reads back as the in-memory totals it was written from
        contracts.check_equal(
            "counts", "counts CSV readback", _read_counts_csv(counts_csv),
            "in-memory region counts", region_counts, detail={"library": library},
        )
        if cfg.compare_umi_overlap_between_regions:
            _log("Testing for consensus umi matches between regions:", library)
            umi_overlap.count_overlapping_umis(
                region_cluster_umis, lay.logs, cfg.overlapping_umi_edit_threshold
            )
        timer.write_tsv(os.path.join(lay.logs, "stage_timing.tsv"))
        lay.mark_stage_done("counts", artifacts=[counts_csv])
        if cfg.delete_tmp_files:
            for d in (lay.region_cluster_fasta, lay.clustering, lay.umi_fasta,
                      lay.fasta, lay.clustering_consensus, lay.region_fasta,
                      lay.consensus_umi_fasta):
                shutil.rmtree(d, ignore_errors=True)
    return region_counts


def _write_align_log(stats, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(f"Total # primary alignments: {stats.n_aligned}\n")
        fh.write(f"n_total: {stats.n_total}\n")
        fh.write(f"n_ee_fail: {stats.n_ee_fail}\n")
        fh.write(f"n_trimmed: {stats.n_trimmed}\n")
        fh.write(f"n_short: {stats.n_short}\n")
        fh.write(f"n_long: {stats.n_long}\n")
        fh.write(f"n_pass: {stats.n_pass}\n")


def _read_counts_csv(path: str) -> dict[str, int]:
    out: dict[str, int] = {}
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        next(fh, None)
        for line in fh:
            region, _, count = line.rstrip("\n").rpartition(",")
            if region:
                out[region] = int(count)
    return out
