"""The end-to-end two-round UMI consensus pipeline.

The counterpart of the JAX package's ``pipeline/run.py`` one-shot run:

  PHASE A (once):  reference self-homology -> region clusters + precision bar
  PHASE B (per library): fused read pass (primer trim -> EE filter ->
                   align -> UMI locate) -> split by region cluster
  round 1:         UMI cluster @0.93 -> subread select -> batched consensus
                   -> bi-GRU polish (``polish_method: "rnn"``, the default)
  round 2:         consensus align + blast-id filter -> split by region ->
                   UMI cluster @0.97 -> select(min=1) -> counts CSV

Each library runs through the graph executor (``executor: "graph"``, the
default: :mod:`..graph`, which derives overlap, checkpoints, resume and the
graph's telemetry from the node declarations) or in the imperative stage
order (``executor: "imperative"``); both write the same artifacts.

Beside the counts it writes the JAX package's QC and report artifacts: the
read-stats, flagstat, split and consensus-filter logs and CSVs, both
error profiles (``error_profile_sample`` reads a round; under
``overlap_qc`` on a worker thread, committed on the main thread before
each round's checkpoint), ``logs/stage_timing.tsv``, the self-homology
logs, ``robustness_report.json`` (retry policy and outcomes, the chaos
plan, contract counters) and ``stack_dumps_p0.log`` (SIGQUIT dumps every
thread's stack there).

Fault tolerance is the JAX package's: every run declares its chaos plan
(``chaos`` or ``TCR_CHAOS``, :mod:`..robustness.faults`); a failed library
is logged and skipped, the rest run, and the run ends with
``failed_libraries_p0.log`` and a ``RuntimeError``; a failed group or region
is skipped and reported, and its round is not checkpointed;
SIGTERM/SIGINT stop the run at the next stage boundary with
:class:`..robustness.shutdown.Preempted`; ``resume=True`` continues from the
stage manifest after verifying the checkpointed artifacts
(``verify_resume``). Malformed input records fail their library under
``on_bad_record: "fail"`` (the default); under ``"quarantine"`` they go to
the library's ``quarantine.fastq.gz``, under ``"drop"`` nowhere, and both
report them in ``robustness_report.json`` (:mod:`..io.validate`).

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
CPU, and nothing falls back from the graph executor to the imperative
order: a retry runs again on the same device and executor.

``mesh_shape`` (e.g. ``{"data": 2}``) splits every device batch (the
read passes, the UMI distances, the polish lanes) over the slices of a
data mesh (:mod:`..parallel.mesh`): the host's cards, or the slices
installed for the job; ``read_batch_size`` must divide the data axis.
Under the graph executor a lost slice re-runs its node on the surviving
slices (``mesh.degraded`` in the robustness report). ``distributed``
brings up a gloo process group (:mod:`..parallel.distributed`): each
process runs its round-robin share of the libraries, process 0 writes the
run-level files, every process writes ``robustness_report_p<i>.json``,
``telemetry_p<i>.json``, ``history_p<i>.jsonl`` and, on failures,
``failed_libraries_p<i>.log``, and every process returns the gathered
counts of all libraries.
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
from ont_tcrconsensus_tpu_torch.graph import check as graph_check
from ont_tcrconsensus_tpu_torch.graph import executor as graph_exec
from ont_tcrconsensus_tpu_torch.graph import pipeline as graph_pipeline
from ont_tcrconsensus_tpu_torch.io import bucketing, fastx, layout
from ont_tcrconsensus_tpu_torch.io import validate as validate_mod
from ont_tcrconsensus_tpu_torch.obs import device as obs_device
from ont_tcrconsensus_tpu_torch.obs import history as obs_history
from ont_tcrconsensus_tpu_torch.obs import live as obs_live
from ont_tcrconsensus_tpu_torch.obs import metrics as obs_metrics
from ont_tcrconsensus_tpu_torch.obs import report as obs_report
from ont_tcrconsensus_tpu_torch.obs import trace as obs_trace
from ont_tcrconsensus_tpu_torch.obs import transfers as obs_transfers
from ont_tcrconsensus_tpu_torch.ops import _build
from ont_tcrconsensus_tpu_torch.parallel import budget as budget_mod
from ont_tcrconsensus_tpu_torch.parallel import distributed as dist
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod
from ont_tcrconsensus_tpu_torch.pipeline import overlap, stages
from ont_tcrconsensus_tpu_torch.pipeline.assign import AssignEngine, ReferencePanel
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
from ont_tcrconsensus_tpu_torch.qc import artifacts, error_profile, umi_overlap
from ont_tcrconsensus_tpu_torch.qc.timing import StageTimer
from ont_tcrconsensus_tpu_torch.robustness import (
    contracts,
    faults,
    lockcheck,
    retry,
    shutdown,
    watchdog,
)

# fallback precision bar when no reference pair survives the homology filter
DEFAULT_BLAST_ID_BAR = 0.99


def _log(*parts):
    print(*parts, file=sys.stderr)


def ingest_guard(cfg: RunConfig, lay, fastq) -> validate_mod.IngestGuard | None:
    """The library's ingest guard under ``on_bad_record`` quarantine or
    drop (None under ``fail``): created after the input's chaos mutation,
    so it names the file the pass reads."""
    if cfg.on_bad_record == "fail":
        return None
    return validate_mod.IngestGuard(cfg.on_bad_record, source=os.fspath(fastq),
                                    quarantine_path=lay.quarantine_path)


def finalize_ingest_guard(guard, library: str) -> None:
    """Close the quarantine artifact and push the ingest events to the
    run's report; called in a ``finally``, so a failed library still gets
    both."""
    if guard is None:
        return
    qsummary = guard.finalize(retry.recorder())
    if qsummary["n_bad"]:
        verb = "quarantined" if guard.policy == "quarantine" else "dropped"
        _log(f"ingest: {qsummary['n_bad']} bad record(s) in "
             f"{library} {verb} ({qsummary['by_reason']})")


def make_mesh_from_config(cfg: RunConfig, device=None):
    """The data mesh named by ``cfg.mesh_shape`` for a run on ``device``
    (None: no mesh)."""
    if not cfg.mesh_shape:
        return None
    mesh = mesh_mod.make_mesh(dict(cfg.mesh_shape), device=device)
    if "data" not in mesh.axis_names:
        raise ValueError(f"mesh_shape {cfg.mesh_shape} needs a 'data' axis")
    n_data = mesh_mod.mesh_data_size(mesh)
    if cfg.read_batch_size is not None and cfg.read_batch_size % n_data:
        raise ValueError(
            f"read_batch_size={cfg.read_batch_size} must divide by the "
            f"data axis size {n_data}"
        )
    return mesh


def resolve_batching(cfg: RunConfig, num_refs: int, device, mesh=None):
    """(read_batch_size, BudgetModel) from the one memory knob (the card's
    memory when ``hbm_budget_gb`` is unset); explicit config values
    override the derived sizes. With a mesh the batch is a multiple of the
    data axis (each slice sees batch/n_data rows)."""
    budget = budget_mod.BudgetModel(
        cfg.hbm_budget_gb if cfg.hbm_budget_gb is not None
        else budget_mod.detect_hbm_gb(device)
    )
    read_batch = cfg.read_batch_size or budget.read_batch(
        cfg.max_read_length, num_refs=max(num_refs, 1), band_width=cfg.sw_band_width,
    )
    if mesh is not None:
        n_data = mesh_mod.mesh_data_size(mesh)
        read_batch = max(read_batch - read_batch % n_data, n_data)
    return read_batch, budget


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
    cards = [dev] if dev.type == "cuda" else []
    try:
        # the memory samples (the sampler, the graph's node boundaries, the
        # roll-up's peak) read only this run's card
        obs_device.set_run_devices(cards)
        if cfg.telemetry != "off":
            obs_metrics.arm()
            if cfg.telemetry == "full":
                obs_trace.arm()
                sampler = obs_device.start_sampler(devices=cards)
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
            # while the process still can (a SIGTERM drain is a
            # BaseException, so Exception alone would miss it)
            obs_live.flush_armed(
                "sigterm_drain" if isinstance(exc, shutdown.Preempted)
                else f"crash:{type(exc).__name__}"
            )
            raise
    finally:
        live_usr1.restore()
        if run_armed_live:
            obs_live.disarm()
        if sampler is not None:
            sampler.stop()
        obs_trace.disarm()
        obs_metrics.disarm()
        obs_device.set_run_devices(None)
        if wd is not None:
            watchdog.deactivate(wd)
            wd.stop()
        sigquit_log.restore()


def _run_with_config_body(cfg: RunConfig, dev: torch.device, run_timer: StageTimer,
                          sigquit_log: _SigquitRunLog) -> dict[str, dict[str, int]]:
    obs_metrics.analysis_set("compile_cache", enable_build_cache(cfg.compile_cache_dir))
    # every run declares its chaos state: the config key wins over the
    # TCR_CHAOS variable, and with neither a stale plan of an earlier
    # in-process run is disarmed
    if cfg.chaos:
        faults.arm(cfg.chaos, seed=cfg.chaos_seed)
    elif faults.arm_from_env() is None:
        faults.disarm()
    policy = retry.set_policy(retry.RetryPolicy(
        max_attempts=cfg.retry_max_attempts, base_delay_s=cfg.retry_base_delay_s,
    ))
    recorder = retry.recorder()
    recorder.reset()
    contracts.set_mode(cfg.contracts)
    contracts.reset()
    if cfg.distributed:
        # a no-op when already up (the CLI brings it up first); required:
        # a failed bring-up must abort, not run N racing single-process runs
        dist.initialize(required=True)
    n_proc, proc_id = dist.process_count(), dist.process_index()
    polisher = _rnn_polisher(cfg, dev) if cfg.polish_method == "rnn" else None
    reference = fastx.read_fasta_dict(cfg.reference_file)
    nano_dir = os.path.join(cfg.fastq_pass_dir, "nano_tcr")
    # every process checks before any creates the dir (the first barrier
    # orders the check before the mkdir), so a stale dir aborts them all
    exists = os.path.exists(nano_dir)
    dist.barrier("nano_dir_check")
    if exists and not cfg.resume:
        raise FileExistsError(f"{nano_dir} exists; set resume=true to continue or remove it")
    if proc_id == 0:
        os.makedirs(nano_dir, exist_ok=True)
    dist.barrier("nano_dir_init")  # the dir exists before any process goes on
    sigquit_log.register(nano_dir, proc_id)
    # crash and SIGUSR1 flight-recorder flushes land in the output tree
    # (a no-op when the live plane is disarmed)
    obs_live.set_flush_path(os.path.join(
        nano_dir, "logs",
        "flight_recorder.json" if n_proc == 1 else f"flight_recorder_p{proc_id}.json",
    ))

    # PHASE A: reference self-homology
    _log("Mapping reference self homology")
    # timed beside the stage table, not as a span: the JAX package's
    # telemetry has no self_homology stage
    t0 = time.perf_counter()
    homology = regions_mod.self_homology_map(reference, cfg.cluster_identity, device=dev)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    run_timer.add("self_homology", time.perf_counter() - t0)
    if proc_id == 0:  # run-level files: one writer across processes
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
    mesh = make_mesh_from_config(cfg, dev)
    if mesh is not None:
        _log("Sharding device batches over mesh:", dict(cfg.mesh_shape),
             [str(s.device) for s in mesh.devices.flat])
    read_batch, budget = resolve_batching(cfg, len(panel.names), dev, mesh)
    _log(f"Device batching: read_batch={read_batch}, budget={budget.hbm_gb:.1f} GB on {dev}")
    ctx = _RunContext(
        cfg=cfg, device=dev, panel=panel,
        engine=AssignEngine(
            panel, cfg.umi_fwd, cfg.umi_rev, primers=cfg.primer_sequences(),
            primer_max_dist_frac=cfg.primer_max_dist_frac,
            a5=cfg.max_softclip_5_end, a3=cfg.max_softclip_3_end,
            trim_window=cfg.trim_window, band_width=cfg.sw_band_width,
            fast_denom=4 if cfg.round1_fast_assign else 0, device=dev, mesh=mesh,
        ),
        # round 2 aligns already-trimmed consensus sequences: no primer search
        engine_notrim=AssignEngine(
            panel, cfg.umi_fwd, cfg.umi_rev, primers=[],
            a5=cfg.max_softclip_5_end, a3=cfg.max_softclip_3_end,
            band_width=cfg.sw_band_width, device=dev, mesh=mesh,
        ),
        blast_id_threshold=blast_id_threshold, overlap_consensus=overlap_consensus,
        read_batch=read_batch, budget=budget, polisher=polisher,
    )

    fastq_list = sorted(glob.glob(os.path.join(cfg.fastq_pass_dir, "barcode*", "*fastq*")))
    if not fastq_list:
        fastq_list = sorted(glob.glob(os.path.join(cfg.fastq_pass_dir, "*.fastq*")))
    if not fastq_list:
        raise FileNotFoundError(f"no fastq files under {cfg.fastq_pass_dir}")
    if n_proc > 1:
        # each process owns a round-robin share of the libraries
        fastq_list = dist.shard_libraries(fastq_list)
        _log(f"Process {proc_id}/{n_proc} owns {len(fastq_list)} libraries")
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
    failed_libraries: list[tuple[str, str]] = []
    preempted: shutdown.Preempted | None = None
    # the first SIGTERM/SIGINT requests a stop; the loop raises Preempted
    # at the next stage boundary, the library's guard drains its workers,
    # and the run exits with every committed checkpoint intact
    coord = shutdown.ShutdownCoordinator()
    coord.install()  # False off the main thread: cooperative stops only
    shutdown.activate(coord)
    try:
        for fastq in fastq_list:
            shutdown.checkpoint("run.library_start")
            obs_live.progress_library(layout.library_name_from_fastq(fastq))
            # the whole library is guarded (its dir and resume included): a
            # failed library is reported and skipped, and resume retries it
            # (no stage marked); Preempted is a BaseException and passes
            try:
                lay = layout.init_library_dir(fastq, nano_dir, resume=cfg.resume)
                watchdog.set_log_path(os.path.join(lay.logs, "watchdog.log"))
                if cfg.resume and lay.stage_done("counts"):
                    counts_csv = os.path.join(lay.counts, "umi_consensus_counts.csv")
                    # chaos site: corruption of a completed artifact between
                    # the run and this resume
                    faults.corrupt_artifact("resume.verify", counts_csv)
                    if graph_exec.verify_resume_stage(lay, "counts", cfg):
                        _log("Library already complete:", lay.library)
                        results[lay.library] = _read_counts_csv(counts_csv)
                        continue
                timer = StageTimer(dev)
                try:
                    results[lay.library] = _run_library(fastq, lay, ctx, timer)
                finally:
                    run_timer.merge(timer)
            except Exception as exc:
                library = layout.library_name_from_fastq(fastq)
                failed_libraries.append((library, repr(exc)))
                _log(f"WARNING: library {library} failed and is skipped: {exc!r}")
            finally:
                # a failed library still advances /progress
                obs_live.progress_library_done()
    except shutdown.Preempted as p:
        preempted = p
        _log(f"PREEMPTED: {p}; every committed stage checkpoint is "
             "resume-safe — rerun with resume=true to continue")
    finally:
        coord.uninstall()
        shutdown.deactivate(coord)
        try:
            recorder.write(os.path.join(
                nano_dir, "robustness_report.json" if n_proc == 1
                else f"robustness_report_p{proc_id}.json",
            ), policy=policy, contracts=contracts.summary())
        except OSError as exc:  # report trouble must never mask the run's fate
            _log(f"WARNING: could not write robustness report: {exc!r}")
        if cfg.telemetry != "off":
            # the roll-up next to the robustness report, on failing and
            # preempted paths too: memory peaks, telemetry.json (+
            # logs/trace.json at "full"), then the run's ledger entry
            # (which never fails the run)
            suffix = "" if n_proc == 1 else f"_p{proc_id}"
            try:
                obs_device.finalize_memory(obs_device.run_devices())
                obs_report.write_run_telemetry(nano_dir, cfg.telemetry, suffix=suffix)
            except OSError as exc:
                _log(f"WARNING: could not write telemetry artifacts: {exc!r}")
            obs_history.record_run(nano_dir, cfg, suffix=suffix, backend=dev.type)
    if failed_libraries:
        with open(os.path.join(nano_dir, f"failed_libraries_p{proc_id}.log"), "w") as fh:
            for library, err in failed_libraries:
                fh.write(f"{library}\t{err}\n")
    if preempted is not None:
        # the peers get the same signal; no process parks in the gather
        raise preempted
    if n_proc > 1:
        # counts AND failures from every process, so a failed library on
        # one process fails the run on all of them
        merged: dict[str, dict[str, int]] = {}
        all_failed: list[tuple[str, str]] = []
        for part in dist.allgather_object({"results": results, "failed": failed_libraries}):
            merged.update(part["results"])
            all_failed.extend(tuple(f) for f in part["failed"])
        results, failed_libraries = merged, all_failed
    if failed_libraries:
        raise RuntimeError(
            f"{len(failed_libraries)} library(ies) failed: "
            f"{sorted(lib for lib, _ in failed_libraries)} — see "
            "failed_libraries_*.log; rerun with resume=true to retry"
        )
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
    # bf16 only behind the exactness A/B certificate for this kind of card
    # (scripts/torch_bf16_ab.py writes it); never on the CPU
    use_bf16 = cfg.polish_bf16 and polisher_mod.bf16_serving_certified(
        min_polish_depth=cfg.min_polish_depth, device=dev)
    if use_bf16:
        _log("polisher: bf16 serving enabled (exactness A/B certified)")
    return polisher_mod.make_pipeline_polisher(
        params, min_polish_depth=cfg.min_polish_depth,
        low_depth_params=low_params, bf16=use_bf16, device=dev,
    )


def _run_library(fastq, lay, ctx: _RunContext, timer: StageTimer) -> dict[str, int]:
    """One library, through the graph executor or the imperative order;
    under ``overlap_qc`` its side stages run on worker threads, drained on
    a critical-path failure so none outlives it."""
    qc_exec = overlap.StageExecutor(device=ctx.device) if ctx.cfg.overlap_qc else None
    try:
        if ctx.cfg.executor == "graph":
            return _run_library_graph(fastq, lay, ctx, timer, qc_exec)
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


def _run_library_graph(fastq, lay, ctx: _RunContext, timer: StageTimer,
                       qc_exec) -> dict[str, int]:
    """Declare the library graph and hand it to the graph executor, which
    derives overlap submissions, commit points, resume, per-node timers and
    watchdog guards from the node/edge declarations (graph/pipeline.py);
    this function only supplies the per-library context."""
    lctx = graph_pipeline.LibraryContext(
        cfg=ctx.cfg, lay=lay, timer=timer, device=ctx.device, panel=ctx.panel,
        engine=ctx.engine, engine_notrim=ctx.engine_notrim,
        blast_id_threshold=ctx.blast_id_threshold,
        overlap_consensus=ctx.overlap_consensus, polisher=ctx.polisher,
        read_batch=ctx.read_batch, budget=ctx.budget,
    )
    if ctx.engine.mesh is not None:
        lctx.remesh = _make_remesh(lctx)
    spec = graph_pipeline.build_library_graph(ctx.cfg)
    try:
        # graftcheck's static verdict rides telemetry.json and the history
        # ledger, and its per-node memory estimate goes into the registry
        # for --report --memory. Analysis, not the run: it never fails it.
        report = graph_check.analyze(spec, graph_check.production_byte_model(ctx.cfg))
        obs_metrics.analysis_set("graftcheck", report.summary())
        for step in report.liveness:
            obs_transfers.static_hbm(step["node"], step["hbm_bytes_est"])
    except Exception as exc:
        _log(f"WARNING: graftcheck analysis failed: {exc!r}")
    executor = graph_exec.GraphExecutor(spec, lctx, side_exec=qc_exec)
    return executor.run({"library_fastq": fastq})["region_counts"]


def _make_remesh(lctx):
    """The degraded-mesh hook the graph executor calls when a
    ``device_lost`` escapes a node body: both engines move onto the
    surviving slices (:func:`..parallel.mesh.degrade_mesh`; ``set_mesh``
    drops every replica placed on the old slices), the library's memory
    budget scales by the survival fraction (``degraded_budget``) and its
    read batch re-quantizes to the new data axis. Returns the
    degradation's detail, or None when the data axis is already 1."""

    def remesh(node_name, exc):
        old = lctx.engine.mesh
        degraded = mesh_mod.degrade_mesh(old)
        if degraded is None:
            return None
        old_n, new_n = mesh_mod.mesh_data_size(old), mesh_mod.mesh_data_size(degraded)
        for eng in (lctx.engine, lctx.engine_notrim):
            if eng.mesh is not None:
                eng.set_mesh(degraded)
        if lctx.budget is not None:
            lctx.budget = budget_mod.degraded_budget(lctx.budget, new_n, old_n)
        if lctx.read_batch:
            rb = lctx.read_batch
            lctx.read_batch = max(rb - rb % new_n, new_n)
        return {"data_from": old_n, "data_to": new_n}

    return remesh


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

    # stage-level resume: a completed round 1 is reloaded from its artifact
    # after verification (verify_resume): a torn or rotted consensus fasta
    # re-runs round 1 instead of seeding round 2
    if cfg.resume and lay.stage_done("round1_consensus") and os.path.exists(merged_path):
        faults.corrupt_artifact("resume.verify", merged_path)
        if graph_exec.verify_resume_stage(lay, "round1_consensus", cfg):
            _log("Resuming from round-1 consensus:", library)
            merged_consensus = [
                (rec.header, rec.sequence) for rec in fastx.read_fastx(merged_path)
            ]
            return _run_round2(lay, ctx, merged_consensus, timer, qc_exec,
                               round1_complete=True)

    # PHASE B + round-1 assignment: one fused pass per batch
    _log("Preprocessing, aligning and UMI-tagging nanopore reads:", library)
    # chaos site for file-level data faults: a mutated sibling copy of the
    # input is read instead (the original is never touched)
    fastq = faults.mutate_input("ingest.library_fastq", fastq)
    # under on_bad_record quarantine/drop the damage goes to the guard while
    # the clean records flow through untouched
    guard = ingest_guard(cfg, lay, fastq)
    try:
        # watchdog guard over per-batch heartbeats (assign.py): a hung
        # dispatch cancels into the transient retry below
        with timer.stage("round1_fused_assign"), watchdog.guard("round1_fused_assign"):
            # the pass is idempotent (it streams the fastq into a fresh
            # store), so a transient fault re-runs it whole; the guard
            # resets with it, so a retry cannot count a bad record twice
            store, astats = retry.call_with_retry("assign.round1", lambda: stages.run_assign(
                fastq, ctx.engine,
                max_ee_rate=cfg.max_ee_rate_base,
                min_len=cfg.minimal_length,
                minimal_region_overlap=cfg.minimal_region_overlap,
                max_softclip_5_end=cfg.max_softclip_5_end,
                max_softclip_3_end=cfg.max_softclip_3_end,
                batch_size=ctx.read_batch,
                max_read_length=cfg.max_read_length,
                subsample=cfg.dorado_trim_subsample_fastq,
                guard=guard,
            ), reset=guard.reset if guard is not None else None)
    finally:
        finalize_ingest_guard(guard, library)
    _write_assign_logs(astats, lay)

    pending: list = []
    if cfg.error_profile_sample:
        # off the critical path under overlap_qc: computed while polish
        # runs, committed before the round-1 checkpoint below
        _profile_stage(pending, qc_exec, timer, "round1_error_profile", store, ctx,
                       os.path.join(lay.logs, f"{library}_align_error_profile.log"))
    groups = stages.group_by_region_cluster(store, panel)
    if cfg.write_intermediate_fastas:
        with timer.stage("write_region_fastas"):
            stages.write_region_fastas(groups, store, lay.region_cluster_fasta,
                                       "region_cluster")
    artifacts.write_region_split_log(
        astats, groups, store, panel.names,
        {n: len(s) for n, s in panel.seqs.items()},
        regions_mod.NEGATIVE_CONTROL_SUFFIXES,
        os.path.join(lay.logs, f"{library}_filter_and_split_reads_by_region_cluster.err"),
    )

    # round 1: UMI records per region cluster, one library-wide batched
    # clustering pass, then one library-wide batched consensus polish. A
    # poisoned group is skipped and reported and the rest complete; if the
    # batched pass itself fails its retries, every group clusters on its
    # own so one bad group cannot poison its peers.
    selected_by_group: list[tuple[str, list[stages.SelectedCluster]]] = []
    failed_groups: list[tuple[str, str]] = []
    records_by_group: list[tuple[str, list]] = []
    for cluster_key in sorted(groups):
        group_name = f"region_cluster{cluster_key}"
        try:
            with timer.stage("round1_umi_records"):
                umis = stages.build_umi_records(store, groups[cluster_key],
                                                cfg.max_pattern_dist)
            if not umis:
                continue
            if cfg.write_intermediate_fastas:
                stages.write_umi_fasta(
                    umis, store,
                    os.path.join(lay.umi_fasta, f"{group_name}_detected_umis.fasta"),
                )
            records_by_group.append((group_name, umis))
        except Exception as exc:
            failed_groups.append((group_name, repr(exc)))
            _log(f"WARNING: {group_name} failed and is skipped: {exc!r}")

    select = stages.umi_cluster_selector(cfg, records_by_group, 1, dev, timer,
                                         mesh=ctx.engine.mesh)
    for group_name, umis in records_by_group:
        try:
            selected, stat_rows = select(group_name, umis)
            cdir = os.path.join(lay.clustering, group_name)
            os.makedirs(cdir, exist_ok=True)
            stages.write_cluster_stats_tsv(
                stat_rows, os.path.join(cdir, "vsearch_cluster_stats.tsv"))
            if selected:
                selected_by_group.append((group_name, selected))
        except Exception as exc:
            failed_groups.append((group_name, repr(exc)))
            _log(f"WARNING: {group_name} failed and is skipped: {exc!r}")
    n_clusters = sum(len(s) for _, s in selected_by_group)
    _log(f"Polishing clusters: {library} "
         f"({n_clusters} clusters over {len(selected_by_group)} region clusters)")
    # guard scaled by the cluster count; the chunk loop heartbeats per
    # dispatch, so only a chunk that stops progressing can expire
    with timer.stage("round1_polish"), watchdog.guard("round1_polish", units=n_clusters):
        by_group, polish_failed = stages.polish_clusters_all(
            selected_by_group, store, max_read_length=cfg.max_read_length,
            polisher=ctx.polisher, budget=ctx.budget, cluster_batch=cfg.cluster_batch_size,
            device=dev, mesh=ctx.engine.mesh,
        )
    merged_consensus: list[tuple[str, str]] = []
    for group_name, selected in selected_by_group:
        if group_name in polish_failed:
            failed_groups.append((group_name, polish_failed[group_name]))
            _log(f"WARNING: {group_name} polish failed and is skipped: "
                 f"{polish_failed[group_name]}")
        else:
            # every selected cluster of a non-failed group produced exactly
            # one consensus record
            contracts.check_equal(
                "consensus", f"{group_name} consensus records",
                len(by_group[group_name]), "selected clusters", len(selected),
                detail={"library": library, "group": group_name},
            )
            merged_consensus.extend(by_group[group_name])
    if failed_groups:
        _log("Not all umi cluster region fastas were successfully polished! "
             f"Incomplete: {[g for g, _ in failed_groups]}")
        with open(os.path.join(lay.logs, "incomplete_region_clusters.log"), "w") as fh:
            for group_name, err in failed_groups:
                fh.write(f"{group_name}\t{err}\n")

    # round-1 QC commits before the round-1 checkpoint: once it is marked,
    # a later resume skips round 1, so its log must exist by then
    _commit_pending_qc(qc_exec, pending, timer)
    n_written = fastx.write_fasta(merged_path, merged_consensus)
    contracts.check_equal(
        "consensus", "merged_consensus.fasta records written", n_written,
        "in-memory consensus entries", len(merged_consensus),
        detail={"library": library},
    )
    if not failed_groups:
        # an incomplete round 1 is not checkpointed: resume retries the
        # failed groups instead of reusing a consensus missing them
        lay.mark_stage_done("round1_consensus", artifacts=[merged_path])
    # chaos site + preemption checkpoint at the round-1 commit: the
    # manifest just committed, so a kill here resumes into round 2 only
    faults.inject("run.round1_checkpoint")
    shutdown.checkpoint("run.round1_checkpoint")
    return _run_round2(lay, ctx, merged_consensus, timer, qc_exec,
                       round1_complete=not failed_groups)


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
                qc_exec, round1_complete: bool) -> dict[str, int]:
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
        cons_store, cstats = retry.call_with_retry("assign.round2", lambda: stages.run_assign(
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
    _write_round2_assign_logs(qc_rows, cstats, lay, panel, ctx.blast_id_threshold,
                              ctx.overlap_consensus)
    pending: list = []
    if cfg.error_profile_sample:
        # overlapped with round-2 clustering; committed before the counts
        # checkpoint
        _profile_stage(pending, qc_exec, timer, "round2_error_profile", cons_store, ctx,
                       os.path.join(lay.logs, "merged_consensus_align_error_profile.log"))
    region_groups = stages.group_by_region(cons_store, panel)
    if cfg.write_intermediate_fastas:
        stages.write_region_fastas(region_groups, cons_store, lay.region_fasta, "region_")

    # round 2: UMI dedup at consensus identity, one batched pass; a failed
    # region is skipped and reported, a failed batched pass retries per
    # region
    region_counts: dict[str, int] = {}
    region_cluster_umis: dict[str, list[str]] = {}
    failed_regions: list[tuple[str, str]] = []
    region_records: list[tuple[str, list]] = []
    for region, parts in sorted(region_groups.items()):
        try:
            with timer.stage("round2_umi_records"):
                umis = stages.build_umi_records(cons_store, parts, cfg.max_pattern_dist)
            if not umis:
                continue
            if cfg.write_intermediate_fastas:
                stages.write_umi_fasta(
                    umis, cons_store,
                    os.path.join(lay.consensus_umi_fasta, f"region_{region}_detected_umis.fasta"),
                )
            region_records.append((region, umis))
        except Exception as exc:
            failed_regions.append((region, repr(exc)))
            _log(f"WARNING: round-2 region {region} failed and is skipped: {exc!r}")

    select = stages.umi_cluster_selector(cfg, region_records, 2, ctx.device, timer,
                                         mesh=ctx.engine_notrim.mesh)
    for region, umis in region_records:
        try:
            selected, stat_rows = select(region, umis)
            _finish_round2_region(region, selected, stat_rows, cons_store, lay, cfg,
                                  region_counts, region_cluster_umis)
        except Exception as exc:
            failed_regions.append((region, repr(exc)))
            _log(f"WARNING: round-2 region {region} failed and is skipped: {exc!r}")
    # round-2 QC commits before the stage table and the counts checkpoint
    _commit_pending_qc(qc_exec, pending, timer)
    _write_counts(lay, cfg, region_counts, region_cluster_umis, failed_regions, timer,
                  complete=round1_complete and not failed_regions)
    return region_counts


def _write_assign_logs(astats, lay) -> None:
    """Round 1's read-pass logs: EE filter, region split, read stats,
    flagstat."""
    library = lay.library
    with open(os.path.join(lay.logs, "ee_filter.log"), "w") as fh:
        fh.write(f"reads passing EE/length filter: {astats.n_total - astats.n_ee_fail}\n")
        fh.write(f"reads with primer trim: {astats.n_trimmed}\n")
    _write_align_log(astats, os.path.join(lay.logs, f"{library}_region_cluster_split.log"))
    artifacts.write_fastq_stats_log(astats, os.path.join(lay.logs, f"{library}_fastq_stats.log"))
    artifacts.write_flagstat_log(astats, os.path.join(lay.logs, f"{library}_flagstat.log"))


def _write_round2_assign_logs(qc_rows, cstats, lay, panel, blast_id_threshold,
                              overlap_consensus) -> None:
    """Round 2's consensus-filter artifacts and flagstat."""
    artifacts.write_consensus_filter_artifacts(
        qc_rows, {n: len(s) for n, s in panel.seqs.items()}, lay.logs,
        "merged_consensus", blast_id_threshold=blast_id_threshold,
        minimal_region_overlap=overlap_consensus,
    )
    artifacts.write_flagstat_log(cstats, os.path.join(lay.logs, "merged_consensus_flagstat.log"))


def _finish_round2_region(region, selected, stat_rows, cons_store, lay, cfg,
                          region_counts, region_cluster_umis) -> None:
    """Round-2 artifacts + counting for one exact region."""
    rdir = os.path.join(lay.clustering_consensus, f"region_{region}")
    os.makedirs(rdir, exist_ok=True)
    stages.write_cluster_stats_tsv(stat_rows, os.path.join(rdir, "vsearch_cluster_stats.tsv"))
    if cfg.write_intermediate_fastas:
        fastx.write_fasta(os.path.join(rdir, "smolecule_clusters.fa"), [
            (str(cl.cluster_id), cons_store.blocks[m.block].decode_one(m.row))
            for cl in selected for m in cl.members
        ])
    # count = round-2 clusters (unique molecules)
    region_counts[region] = len(selected)
    region_cluster_umis[region] = [cl.members[0].combined for cl in selected]


def _write_counts(lay, cfg, region_counts, region_cluster_umis, failed_regions,
                  timer: StageTimer, complete: bool) -> str:
    """The library's tail, shared by both executors: the incomplete-region
    log, the counts CSV (checked against the in-memory totals), the UMI
    overlap test, the stage table, the counts checkpoint (only when the
    library is complete, so resume retries what failed) and the tmp-file
    cleanup. Returns the CSV's path."""
    if failed_regions:
        with open(os.path.join(lay.logs, "incomplete_regions.log"), "w") as fh:
            for region, err in failed_regions:
                fh.write(f"{region}\t{err}\n")
    counts_csv = stages.write_counts_csv(region_counts, lay.counts)
    contracts.check_equal(
        "counts", "counts CSV readback", _read_counts_csv(counts_csv),
        "in-memory region counts", region_counts, detail={"library": lay.library},
    )
    if cfg.compare_umi_overlap_between_regions:
        _log("Testing for consensus umi matches between regions:", lay.library)
        umi_overlap.count_overlapping_umis(
            region_cluster_umis, lay.logs, cfg.overlapping_umi_edit_threshold
        )
    # the stage table lands before the counts mark: a crash in between
    # leaves counts unmarked and resume regenerates both
    timer.write_tsv(os.path.join(lay.logs, "stage_timing.tsv"))
    if complete:
        lay.mark_stage_done("counts", artifacts=[counts_csv])
    if cfg.delete_tmp_files:
        for d in (lay.region_cluster_fasta, lay.clustering, lay.umi_fasta,
                  lay.fasta, lay.clustering_consensus, lay.region_fasta,
                  lay.consensus_umi_fasta):
            shutil.rmtree(d, ignore_errors=True)
    return counts_csv


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
