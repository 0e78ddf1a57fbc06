"""The warm-serving daemon loop and its loopback HTTP control plane.

The counterpart of the JAX package's ``serve/daemon.py``. One process arms
everything once: the kernel build cache (``compile_cache_dir``), the
daemon-scope metrics registry and the live plane with the ``/jobs``
routes. Then every accepted job runs through the unchanged
:func:`~..pipeline.run.run_with_config` on the daemon's device, an
explicit ``torch.device`` handed to every job: the card unless the CPU is
asked for (``--cpu``, ``TCR_CONSENSUS_FORCE_CPU``, or ``device="cpu"``
for an embedder), and a host with no card raises instead of falling back.
The artifacts equal the one-shot CLI's because jobs run the same code;
the daemon only decides when, and keeps the process, with its CUDA
context, its loaded kernel libraries and cuDNN's handles, alive between
jobs. After the prewarm no job builds or loads a kernel library: each
job's ``telemetry.json`` counts its kernel builds.

Lifecycle:

- start: template config validated -> kernel build cache armed -> live
  plane and jobs controller up (``serve_info.json`` in the state dir holds
  the resolved port and pid) -> drain journal resumed -> prewarm
  (serve/prewarm.py: warm-up launches) -> accept loop, serial when
  ``serve_workers`` is 1, the packed runner pool when it is more.
- job: its overrides merged onto the template and revalidated,
  ``live_port`` forced off (the daemon owns the plane), admission, the
  dispatch-to-first-stage latency measured through the live plane's
  node-start hook, the retry/poison ladder on a failure, and a
  ``source: "serve"`` ledger entry beside the run's own (``warmup_s`` on
  the first job, ``steady_s``, ``wait_s`` and
  ``dispatch_first_stage_s`` on every job).
- SIGTERM: the in-flight job drains at its next stage boundary through the
  shutdown coordinator (its committed stages resume), every unfinished
  job is journaled to ``serve_journal.json``, the flight recorder is
  flushed (``serve_drain``, or ``serve_crash:<Type>`` when the loop
  crashed) and the exit code is 143; a restarted daemon loads the journal
  and resumes the jobs with ``resume=true`` through verified resume.
  Signal handlers exist only on the main thread: a daemon run on another
  thread (the tests, ``chip_smoke.py``) stops cooperatively
  (:meth:`Daemon.request_stop`, or a request on its coordinator).

Packed mode runs each job on its slice's first device (the slice's
devices are the job's mesh); the card's allocator and its peak-memory
statistic are shared by the residents, so a packed job's
``device.hbm_bytes_in_use`` includes its neighbour's allocations. A
serial job's peak is its own: the daemon resets the card's peak
statistic before each serial job, as a fresh one-shot process starts
with none.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.obs import history as obs_history
from ont_tcrconsensus_tpu_torch.obs import live as obs_live
from ont_tcrconsensus_tpu_torch.obs import metrics as obs_metrics
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
from ont_tcrconsensus_tpu_torch.robustness import faults
from ont_tcrconsensus_tpu_torch.robustness import jobscope
from ont_tcrconsensus_tpu_torch.robustness import lockcheck
from ont_tcrconsensus_tpu_torch.robustness import retry as retry_mod
from ont_tcrconsensus_tpu_torch.robustness import shutdown
from ont_tcrconsensus_tpu_torch.robustness import watchdog as watchdog_mod
from ont_tcrconsensus_tpu_torch.serve import prewarm as prewarm_mod
from ont_tcrconsensus_tpu_torch.serve import queue as queue_mod
from ont_tcrconsensus_tpu_torch.serve import slices as slices_mod

SERVE_INFO_BASENAME = "serve_info.json"


def _log(*parts):
    print("serve:", *parts, file=sys.stderr)


@dataclasses.dataclass
class _JobOutcome:
    state: str
    error: str | None = None
    result: dict | None = None


class Daemon:
    """The long-lived serving loop; also the live plane's jobs controller
    (duck type behind ``POST /jobs`` — :meth:`submit`,
    :meth:`jobs_snapshot`, :meth:`job_snapshot`)."""

    def __init__(self, template: dict, *, port: int, state_dir: str,
                 queue_max: int | None = None, do_prewarm: bool | None = None,
                 prewarm_widths: list[int] | None = None,
                 workers: int | None = None,
                 device: str | torch.device | None = None,
                 devices: list | None = None):
        # runtime lockset twin: arm before the JobQueue (and later the
        # daemon-owned metrics/live registries) pick their lock type
        lockcheck.arm_from_env()
        self.template = dict(template)
        # the template must itself be a complete, valid run config: every
        # job inherits it, so a broken template fails at daemon start, not
        # on the first tenant's submit
        self.template_cfg = RunConfig.from_dict(dict(template))
        # every job runs on this device (the card unless the CPU is asked
        # for); a CUDA request without a card raises here, at start
        self.device = resolve_device(device)
        self.port = port
        self.state_dir = state_dir
        self.prewarm_widths = prewarm_widths
        self.do_prewarm = (self.template_cfg.serve_prewarm
                           if do_prewarm is None else do_prewarm)
        from ont_tcrconsensus_tpu_torch.parallel import budget as budget_mod

        self.budget = budget_mod.BudgetModel(
            self.template_cfg.hbm_budget_gb
            if self.template_cfg.hbm_budget_gb is not None
            else budget_mod.detect_hbm_gb(self.device)
        )
        self.queue = queue_mod.JobQueue(
            queue_max if queue_max is not None
            else self.template_cfg.serve_queue_max,
            self.budget,
        )
        # bounded per-job retry, from the SAME config knobs the batch
        # path's stage retries use — transient failures requeue with
        # backoff, anything else (or exhaustion) poison-quarantines
        self.retry_policy = retry_mod.RetryPolicy(
            max_attempts=self.template_cfg.retry_max_attempts,
            base_delay_s=self.template_cfg.retry_base_delay_s,
            max_delay_s=2.0, seed=0,
        )
        self.prewarm_report: dict | None = None
        self.warmup_s: float | None = None
        self.jobs_done = 0
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._coord = shutdown.ShutdownCoordinator()
        # slice-packed runner pool (serve/slices.py): with workers > 1 the
        # host's devices of the daemon's platform (or ``devices``) become a
        # pool of disjoint pow2 slices and up to `workers` jobs run
        # concurrently, each on its own slice in its own job scope.
        # workers == 1 keeps the serial loop byte-for-byte.
        self.workers = (workers if workers is not None
                        else self.template_cfg.serve_workers)
        self.allocator: slices_mod.SliceAllocator | None = None
        if self.workers > 1:
            from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

            self.allocator = slices_mod.SliceAllocator(
                devices if devices is not None
                else mesh_mod._host_devices(self.device), self.budget)
            # admission control turns per-slice: a submit is judged
            # against the largest grantable slice's allowance, not the
            # whole mesh (re-swapped as quarantines shrink the pool)
            self.queue.budget = self.allocator.admission_budget()
        self._done_lock = threading.Lock()
        self._preempt_exit = threading.Event()

    # --- jobs controller (HTTP handler threads) ----------------------------

    def submit(self, overrides: dict) -> tuple[int, dict]:
        if (self._draining.is_set() or self._stop.is_set()
                or self._coord.requested()):
            # the SIGTERM window counts too: between the signal and the
            # loop's exit the in-flight job is still draining, and a job
            # accepted now would only journal — refuse it honestly
            err = self.queue.reject(
                "draining", "daemon is draining; resubmit after restart "
                            "(queued jobs are journaled)")
            return 503, {"error": err.reason, "detail": err.detail}
        merged = dict(self.template)
        merged.update(overrides)
        # the daemon owns the live plane; a job must not re-point it
        merged["live_port"] = None
        try:
            cfg = RunConfig.from_dict(merged)
        except Exception as exc:
            err = self.queue.reject("invalid_config", str(exc))
            return 400, {"error": err.reason, "detail": err.detail}
        try:
            job = self.queue.submit(merged, cfg)
        except queue_mod.AdmissionError as exc:
            status = 429 if exc.reason == "queue_full" else 409
            return status, {"error": exc.reason, "detail": exc.detail}
        obs_live.ring_event("serve.job", {"id": job.id, "event": "queued"})
        snap = job.snapshot()
        snap["queue_depth"] = self.queue.depth()
        return 202, snap

    def jobs_snapshot(self) -> dict:
        snap = {
            "jobs": self.queue.snapshot(),
            "queue_depth": self.queue.depth(),
            "draining": self._draining.is_set(),
            "jobs_done": self.jobs_done,
            "warmup_s": self.warmup_s,
            "prewarm": self.prewarm_report,
        }
        if self.allocator is not None:
            # packed serving: tenants can watch residency + the pool map
            # (who holds which slice, what's quarantined) over GET /jobs
            snap["resident_jobs"] = self.allocator.resident()
            snap["slices"] = self.allocator.snapshot()
        return snap

    def job_snapshot(self, job_id: str) -> dict | None:
        job = self.queue.job(job_id)
        return job.snapshot() if job is not None else None

    def request_stop(self) -> None:
        """Programmatic drain (tests / embedders): same path as SIGTERM
        minus the signal, exit code 0."""
        self._stop.set()

    # --- lifecycle ----------------------------------------------------------

    def _write_info(self, srv_port: int) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        path = os.path.join(self.state_dir, SERVE_INFO_BASENAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"port": srv_port, "pid": os.getpid(),
                       "t_wall": round(time.time(), 3)}, fh, indent=1)
        os.replace(tmp, path)

    def _resume_journal(self) -> None:
        for rec in queue_mod.load_journal(self.state_dir):
            raw = dict(rec["raw"])
            # committed stages of a drained job must resume, not refuse
            # on the existing output tree
            raw["resume"] = True
            raw["live_port"] = None
            try:
                cfg = RunConfig.from_dict(raw)
                self.queue.submit(raw, cfg)
                _log(f"journal: resumed {rec.get('id')} as a fresh job")
            except Exception as exc:
                _log(f"journal: dropped {rec.get('id')}: {exc!r}")

    def _prewarm(self) -> None:
        if not self.do_prewarm:
            self.prewarm_report = {"skipped": "serve_prewarm off",
                                   "entries": [], "seconds": 0.0}
            return
        try:
            faults.inject("serve.prewarm")
            self._prewarm_inner()
        except Exception as exc:
            # prewarm is an optimization, never a gate: a failure leaves
            # the cold costs to the first job and the daemon stays up
            self.prewarm_report = {"error": repr(exc), "entries": [],
                                   "seconds": 0.0, "failed": 1}
            obs_metrics.analysis_set("serve_prewarm", self.prewarm_report)
            _log(f"WARNING: prewarm failed ({exc!r}); the first job pays "
                 "the kernel builds and the card's warm-up")

    def _prewarm_inner(self) -> None:
        from ont_tcrconsensus_tpu_torch.cluster import regions as regions_mod
        from ont_tcrconsensus_tpu_torch.io import fastx
        from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod
        from ont_tcrconsensus_tpu_torch.pipeline.assign import (
            AssignEngine,
            ReferencePanel,
        )

        cfg = self.template_cfg
        dev = self.device
        reference = fastx.read_fasta_dict(cfg.reference_file)
        homology = regions_mod.self_homology_map(
            reference, cfg.cluster_identity, device=dev)
        panel = ReferencePanel.build(
            reference, homology.region_cluster, device=dev)
        read_batch, budget = run_mod.resolve_batching(
            cfg, len(panel.names), dev)
        engine = AssignEngine(
            panel, cfg.umi_fwd, cfg.umi_rev,
            primers=cfg.primer_sequences(),
            primer_max_dist_frac=cfg.primer_max_dist_frac,
            a5=cfg.max_softclip_5_end, a3=cfg.max_softclip_3_end,
            trim_window=cfg.trim_window, band_width=cfg.sw_band_width,
            fast_denom=4 if cfg.round1_fast_assign else 0, device=dev,
        )
        self.prewarm_report = prewarm_mod.prewarm(
            cfg, engine, read_batch, budget, widths=self.prewarm_widths)
        obs_metrics.analysis_set("serve_prewarm", self.prewarm_report)
        _log(f"prewarm: {self.prewarm_report.get('compiled', 0)} warm-up "
             f"launch(es) on {dev} in {self.prewarm_report.get('seconds', 0.0)}s")

    def serve_forever(self) -> int:
        """Arm, prewarm, loop until drained; returns the exit code (143
        for a signal-initiated drain, 0 for a programmatic stop)."""
        from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod

        cache_state = run_mod.enable_build_cache(
            self.template_cfg.compile_cache_dir)
        # serve-scope chaos: TCR_CHAOS arms drills that fire in the daemon
        # loop itself (each job's run re-declares its own chaos state, so
        # a per-run env plan still fires inside jobs as before)
        faults.arm_from_env()
        obs_metrics.arm()
        obs_metrics.analysis_set("compile_cache", cache_state)
        srv = obs_live.arm(self.port)
        obs_live.set_flush_path(os.path.join(
            self.state_dir, "logs", "flight_recorder.json"))
        obs_live.set_jobs_controller(self)
        self._write_info(srv.port)
        installed = self._coord.install()
        shutdown.activate(self._coord)
        _log(f"daemon up on http://127.0.0.1:{srv.port} on {self.device} "
             f"(/jobs /healthz /metrics /progress; pid {os.getpid()}"
             f"{'' if installed else '; cooperative stop only'})")
        exit_code = 0
        crash: BaseException | None = None
        try:
            self._resume_journal()
            self._prewarm()
            self.warmup_s = round(time.monotonic() - self._t0, 3)
            _log(f"warm after {self.warmup_s}s; accepting jobs"
                 + (f" ({self.workers} packed workers)"
                    if self.allocator is not None else ""))
            if self.allocator is not None:
                exit_code = self._packed_loop()
            else:
                while True:
                    if self._coord.requested():
                        exit_code = 143
                        break
                    if self._stop.is_set():
                        break
                    job = self.queue.pop(timeout=0.25)
                    if job is None:
                        continue
                    try:
                        # loop-crash drill: the popped job must not vanish
                        # — requeue it so the drain journal in `finally`
                        # (and a restarted daemon) still carries it
                        faults.inject("serve.daemon_loop")
                    except BaseException:
                        self.queue.requeue_front(job)
                        raise
                    if self._coord.requested() or self._stop.is_set():
                        # drained between pop and dispatch: back on head
                        self.queue.requeue_front(job)
                        exit_code = 143 if self._coord.requested() else 0
                        break
                    if not self._run_job(job):
                        exit_code = 143
                        break
        except BaseException as exc:
            crash = exc
            raise
        finally:
            self._draining.set()
            drained = self.queue.drain_jobs()
            path = queue_mod.write_journal(self.state_dir, drained)
            if path:
                _log(f"drain: journaled {len(drained)} job(s) to {path}")
            # a crash flushes the flight recorder under a reason naming
            # the exception type, so the black box says WHY it died; each
            # job's run re-pointed the flush path into its own output
            # tree, so re-claim the daemon's before flushing
            obs_live.set_flush_path(os.path.join(
                self.state_dir, "logs", "flight_recorder.json"))
            obs_live.flush_armed(
                "serve_drain" if crash is None
                else f"serve_crash:{type(crash).__name__}")
            obs_live.set_jobs_controller(None)
            obs_live.disarm()
            obs_metrics.disarm()
            faults.disarm()
            shutdown.deactivate(self._coord)
            self._coord.uninstall()
        return exit_code

    # --- the packed (multi-tenant) loop --------------------------------------

    def _packed_loop(self) -> int:
        """The runner-pool accept loop: up to ``serve_workers`` jobs run
        concurrently, each on a disjoint device slice in its own job
        scope. Same drain contract as the serial loop (exit 143 on a
        signal, 0 on a programmatic stop), extended to N residents: a
        SIGTERM preempts EVERY resident job at its next stage boundary
        (each scoped checkpoint also polls the daemon's coordinator) and
        all of them requeue before the caller journals."""
        slots = threading.Semaphore(self.workers)
        workers: list[threading.Thread] = []
        exit_code = 0
        while True:
            if self._coord.requested() or self._preempt_exit.is_set():
                exit_code = 143
                break
            if self._stop.is_set():
                break
            # slot BEFORE pop: a popped job must never sit slotless in
            # dispatcher limbo where a drain would miss it
            if not slots.acquire(timeout=0.25):
                continue
            dispatched = False
            try:
                job = self.queue.pop(timeout=0.25)
                if job is None:
                    continue
                try:
                    # same loop-crash drill as the serial path: the popped
                    # job must not vanish on a dispatcher fault
                    faults.inject("serve.daemon_loop")
                except BaseException:
                    self.queue.requeue_front(job)
                    raise
                if self._coord.requested() or self._stop.is_set():
                    self.queue.requeue_front(job)
                    exit_code = 143 if self._coord.requested() else 0
                    break
                raw = dict(job.raw)
                cfg = RunConfig.from_dict(raw)
                size, detail = self.allocator.size_for(cfg)
                if size is None:
                    # admitted once, but the pool shrank underneath it
                    # (quarantines): fail loudly, never queue forever
                    self._poison_capacity(job, detail)
                    continue
                try:
                    lease = self.allocator.try_assign(job.id, size)
                except Exception as exc:
                    # serve.slice_assign chaos fires before any pool
                    # mutation; the failure rides the normal ladder
                    self._finish_if_terminal(
                        job, self._failure_outcome(job, exc))
                    continue
                if lease is None:
                    if not self.allocator.can_ever_fit(size):
                        self._poison_capacity(
                            job, f"no aligned {size}-device run survives "
                                 f"quarantine")
                        continue
                    # fragmentation or full residency: free slices may
                    # exist but no aligned run this big is free RIGHT NOW
                    # — the job stays queued (not rejected) and the
                    # dispatcher waits for a release
                    self.queue.requeue_front(job)
                    self.allocator.wait_for_release(0.25)
                    continue
                if not raw.get("mesh_shape"):
                    # packed jobs shard over exactly their slice; a
                    # tenant-pinned mesh_shape is honored as-is (the
                    # lease was sized to cover it)
                    raw["mesh_shape"] = {"data": lease.size}
                    cfg = RunConfig.from_dict(raw)
                t = threading.Thread(
                    target=self._slice_worker,
                    args=(job, cfg, lease, slots),
                    name=f"serve-worker-{job.id}", daemon=True)
                workers.append(t)
                dispatched = True
                t.start()
                obs_metrics.gauge_set(
                    "serve.resident_jobs",
                    float(self.allocator.resident()))
            finally:
                if not dispatched:
                    slots.release()
        # stop dispatching, then wait for the residents: they finish
        # (programmatic stop) or preempt at the next stage boundary
        # (signal), and their requeues must land before the drain journal
        for t in workers:
            t.join()
        if self._preempt_exit.is_set():
            exit_code = 143
        return exit_code

    def _slice_worker(self, job: queue_mod.Job, cfg: RunConfig,
                      lease: slices_mod.SliceLease,
                      slots: threading.Semaphore) -> None:
        """One runner-pool worker: run the job on its slice, then return
        the slice to the pool (quarantined devices stay out) and free the
        slot. A drain mid-run (False from _run_job) stops the
        dispatcher."""
        ok = True
        try:
            ok = self._run_job(job, cfg=cfg, lease=lease)
        except BaseException as exc:
            # _run_job owns job failures; anything escaping it is
            # daemon-plane plumbing — log it, keep the pool consistent
            _log(f"{job.id}: worker crashed outside the job ladder: "
                 f"{exc!r}")
        finally:
            try:
                self.allocator.release(job.id)
            except Exception as exc:
                # serve.pack chaos fires AFTER the devices are freed: the
                # pool is consistent, the fault is observability only
                _log(f"{job.id}: pack fault after release: {exc!r}")
            slots.release()
            obs_metrics.gauge_set(
                "serve.resident_jobs", float(self.allocator.resident()))
            if not ok:
                self._preempt_exit.set()

    def _on_slice_degrade(self, job: queue_mod.Job,
                          lease: slices_mod.SliceLease, lost) -> None:
        """Degrade-hook for a packed job's mesh (parallel/mesh.py calls it
        from degrade_mesh, on the job's own thread): the run survived a
        device loss by remeshing WITHIN its slice, so only the dead
        devices leave the pool — no later tenant can land on them, and
        admission shrinks to the surviving capacity. Tenant isolation is
        structural: the hook only ever touches this job's lease."""
        labels = self.allocator.quarantine(job.id, lost_devices=lost)
        self.queue.budget = self.allocator.admission_budget()
        _log(f"{job.id}: degraded within slice {lease.slice_id}; "
             f"quarantined {labels}")

    def _poison_capacity(self, job: queue_mod.Job, detail: str) -> None:
        """No surviving slice can EVER admit this job (quarantines ate
        the capacity it was admitted against): quarantine it durably and
        loudly instead of letting it wait for a release that cannot
        help."""
        path = queue_mod.append_poison(
            self.state_dir, job, classification="capacity_lost",
            error=detail)
        self.queue.mark(job, "poisoned", error=f"capacity_lost: {detail}")
        with self._done_lock:
            self.jobs_done += 1
        obs_live.ring_event("serve.job", {"id": job.id, "event": "poisoned"})
        _log(f"{job.id}: poisoned (capacity_lost): {detail}; -> {path}")

    def _finish_if_terminal(self, job: queue_mod.Job,
                            outcome: _JobOutcome) -> None:
        """Record a terminal outcome produced outside _run_job (dispatch-
        time failures); a "retry" outcome already requeued the job."""
        if outcome.state == "retry":
            return
        self.queue.mark(job, outcome.state, error=outcome.error,
                        result=outcome.result)
        with self._done_lock:
            self.jobs_done += 1
        obs_live.ring_event("serve.job", {"id": job.id,
                                          "event": outcome.state})
        _log(f"{job.id}: {outcome.state}: {outcome.error}")

    # --- one job -------------------------------------------------------------

    def _run_job(self, job: queue_mod.Job, cfg: RunConfig | None = None,
                 lease: slices_mod.SliceLease | None = None) -> bool:
        """Run one job through the unchanged pipeline; False = drained
        mid-job (the job is requeued + the caller exits the loop).

        With ``lease`` (packed serving) the run executes inside its own
        job scope: chaos plans, telemetry registries, watchdog guards,
        contracts and the run's shutdown coordinator bind to this worker
        thread's store, and the mesh comes up over the lease's devices —
        so nothing the job arms or disarms can perturb the daemon plane
        or a neighbor tenant. Daemon bookkeeping (requeue/mark/ledger)
        runs OUTSIDE the scope so it lands in the daemon registries.

        The run's device is the daemon's, or in packed mode the lease's
        first device (its mesh's first slice)."""
        from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod

        obs_live.ring_event("serve.job", {"id": job.id, "event": "start"})
        _log(f"{job.id}: starting (waited {job.wait_s:.3f}s)")
        if cfg is None:
            cfg = RunConfig.from_dict(dict(job.raw))
        device = lease.devices[0] if lease is not None else self.device
        if lease is None and device.type == "cuda":
            # the job's device high-water is its own, as in a fresh
            # one-shot process (a packed neighbour's would be reset too)
            torch.cuda.reset_peak_memory_stats(device)
        t_dispatch = time.monotonic()

        def first_stage_hook(name: str) -> None:
            job.first_stage_s = time.monotonic() - t_dispatch
            obs_live.set_node_start_hook(None)
            obs_metrics.observe("serve.first_stage_s", job.first_stage_s)

        outcome = _JobOutcome("done")
        try:
            try:
                if lease is not None:
                    from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

                    # everything from here to the inner finally runs in
                    # THIS job's scope; the daemon plane and the other
                    # residents never see it
                    jobscope.enter()
                    mesh_mod.install_slice_devices(lease.devices)
                    mesh_mod.install_degrade_hook(
                        lambda lost: self._on_slice_degrade(
                            job, lease, lost))
                obs_live.set_node_start_hook(first_stage_hook)
                self._inject_job_chaos(job, cfg)
                if lease is not None:
                    # slice-loss drill: the raise classifies as
                    # device_lost below, quarantining only THIS tenant's
                    # slice and requeuing only this job
                    faults.inject("serve.slice_lost")
                results = run_mod.run_with_config(cfg, device=device)
            finally:
                obs_live.set_node_start_hook(None)
                if lease is not None:
                    jobscope.exit()
            outcome.result = {
                "libraries": {
                    lib: sum(regions.values())
                    for lib, regions in sorted(results.items())
                },
            }
        except shutdown.Preempted as preempted:
            # not swallowed: the caller exits the serve loop with code 143
            # on False; finished stages are committed and the restarted
            # daemon resumes the rest through verified resume
            job.raw["resume"] = True
            self.queue.requeue_front(job)
            obs_live.ring_event(
                "serve.drain", {"id": job.id, "reason": str(preempted)})
            _log(f"{job.id}: drained mid-run ({preempted}); requeued with "
                 f"resume=true")
            return False
        except Exception as exc:
            outcome = self._failure_outcome(job, exc, lease=lease)
        finally:
            if lease is None:
                # serial mode: the job's run disarmed the global registry
                # on exit; re-arm a fresh daemon-scope one so between-job
                # /metrics scrapes stay live. A scoped (packed) run
                # disarmed only its OWN registry — re-arming here would
                # instead wipe the daemon's counters mid-flight.
                obs_metrics.arm()
            obs_metrics.gauge_set("serve.queue_depth", self.queue.depth())
        if outcome.state == "retry":
            # back in the queue with backoff — not terminal, not counted
            return True
        job_s = time.monotonic() - t_dispatch
        self.queue.mark(job, outcome.state, error=outcome.error,
                        result=outcome.result)
        with self._done_lock:
            self.jobs_done += 1
        obs_live.ring_event("serve.job", {
            "id": job.id, "event": outcome.state,
        })
        if outcome.state == "done":
            self._record_ledger(job, cfg, job_s)
            _log(f"{job.id}: done in {job_s:.3f}s "
                 f"(first stage after {job.first_stage_s:.3f}s)"
                 if job.first_stage_s is not None else
                 f"{job.id}: done in {job_s:.3f}s")
        else:
            _log(f"{job.id}: {outcome.state}: {outcome.error}")
        return True

    def _inject_job_chaos(self, job: queue_mod.Job, cfg: RunConfig) -> None:
        """Serve-plane chaos plants, free no-ops when disarmed.

        ``serve.job_run`` raises a seeded failure before dispatch (the
        retry/poison ladder's entry point); ``serve.job_slow`` stalls
        under a short-lived serve-scope watchdog armed only for the drill
        (``stage_timeout_s`` template knob), so cancel -> StageTimeout ->
        transient classification -> requeue is exercised end to end.
        """
        if not faults.active():
            return
        faults.inject("serve.job_run")
        if cfg.stage_timeout_s:
            wd = watchdog_mod.Watchdog(cfg.stage_timeout_s)
            wd.start()
            watchdog_mod.activate(wd)
            try:
                with wd.guard(f"serve:{job.id}"):
                    faults.inject("serve.job_slow")
            finally:
                watchdog_mod.deactivate(wd)
                wd.stop()
        else:
            faults.inject("serve.job_slow")

    def _failure_outcome(self, job: queue_mod.Job, exc: Exception,
                         lease: slices_mod.SliceLease | None = None,
                         ) -> _JobOutcome:
        """The retry/poison ladder. Transient failures requeue with
        seeded backoff up to ``retry_max_attempts``; anything fatal — or
        a transient that exhausts its attempts — is quarantined durably
        to ``serve_poison.json`` with a machine-readable reason, so one
        bad tenant job can never wedge the loop.

        Packed serving adds a rung: a ``device_lost`` that ESCAPED a
        leased run (the mesh could not degrade within the slice) means
        the slice is gone but the job is fine — the slice's devices are
        quarantined, admission shrinks to the surviving pool, and the job
        requeues for a fresh slice with ``resume=true`` (its committed
        stages carry over)."""
        job.attempts += 1
        cls = retry_mod.classify(exc)
        if (lease is not None and cls == "device_lost"
                and job.attempts < self.retry_policy.max_attempts):
            labels = self.allocator.quarantine(job.id)
            self.queue.budget = self.allocator.admission_budget()
            delay = self.retry_policy.delay(job.attempts)
            retry_mod.recorder().record(
                "serve.slice_lost", classification=cls,
                outcome="slice_quarantined", attempt=job.attempts,
                error=repr(exc), detail={"devices": labels})
            job.raw["resume"] = True
            self.queue.requeue_back(job, delay_s=delay)
            obs_live.ring_event("serve.job", {
                "id": job.id, "event": "retry", "attempt": job.attempts})
            _log(f"{job.id}: lost slice {lease.slice_id} "
                 f"({len(labels)} device(s) quarantined): {exc!r}; "
                 f"requeued for a fresh slice")
            return _JobOutcome("retry")
        if (cls == "transient"
                and job.attempts < self.retry_policy.max_attempts):
            delay = self.retry_policy.delay(job.attempts)
            retry_mod.recorder().record(
                "serve.job_run", classification=cls, outcome="retry",
                attempt=job.attempts, error=repr(exc))
            self.queue.requeue_back(job, delay_s=delay)
            obs_live.ring_event("serve.job", {
                "id": job.id, "event": "retry", "attempt": job.attempts})
            _log(f"{job.id}: transient failure (attempt {job.attempts}/"
                 f"{self.retry_policy.max_attempts}): {exc!r}; requeued "
                 f"with {delay:.2f}s backoff")
            return _JobOutcome("retry")
        reason = "retry_exhausted" if cls == "transient" else cls
        retry_mod.recorder().record(
            "serve.job_run", classification=cls, outcome="poisoned",
            attempt=job.attempts, error=repr(exc))
        path = queue_mod.append_poison(
            self.state_dir, job, classification=reason, error=repr(exc))
        _log(f"{job.id}: poisoned ({reason}) after {job.attempts} "
             f"attempt(s): {exc!r}; quarantined to {path}")
        return _JobOutcome("poisoned", error=f"{reason}: {exc!r}")

    def _record_ledger(self, job: queue_mod.Job, cfg: RunConfig,
                       job_s: float) -> None:
        """Append the ``source: "serve"`` entry: the dispatch-to-first-
        stage latency and warm/steady split, next to the run's own entry
        (same never-fail contract as every telemetry path)."""
        try:
            entry = obs_history.build_entry(
                "serve",
                fingerprint=obs_history.config_fingerprint(cfg),
                sha=obs_history.git_sha(),
                backend=self.device.type,
                warmup_s=self.warmup_s if self.jobs_done == 1 else None,
                steady_s=job_s,
                extra={
                    "job_id": job.id,
                    "wait_s": round(job.wait_s or 0.0, 3),
                    "dispatch_first_stage_s": (
                        round(job.first_stage_s, 3)
                        if job.first_stage_s is not None else None),
                },
            )
            nano_dir = os.path.join(cfg.fastq_pass_dir, "nano_tcr")
            obs_history.append_entry(
                os.path.join(nano_dir, obs_history.HISTORY_BASENAME), entry)
            if cfg.history_ledger:
                obs_history.append_entry(cfg.history_ledger, entry)
        except Exception as exc:
            _log(f"WARNING: could not append serve ledger entry: {exc!r}")


def serve_main(argv: list[str] | None = None) -> int:
    """``python -m ont_tcrconsensus_tpu_torch serve <template.json>``: the
    daemon on the card, or on the CPU with ``--cpu`` or a non-empty
    ``TCR_CONSENSUS_FORCE_CPU``; returns the exit code (143 after a SIGTERM
    drain)."""
    parser = argparse.ArgumentParser(
        prog="python -m ont_tcrconsensus_tpu_torch serve",
        description="Warm-serving daemon: accepts pipeline jobs over a "
                    "loopback-only HTTP control plane (POST /jobs) and "
                    "runs them through one long-lived, prewarmed process "
                    "on the CUDA card.",
    )
    parser.add_argument("template", help="template run-config JSON every "
                                         "job's overrides merge onto")
    parser.add_argument("--port", type=int, default=8765,
                        help="loopback control-plane port (0 = ephemeral; "
                             "resolved port lands in serve_info.json)")
    parser.add_argument("--state-dir", default=None,
                        help="daemon state dir (serve_info.json + drain "
                             "journal); default: serve_state/ next to the "
                             "template")
    parser.add_argument("--queue-max", type=int, default=None,
                        help="override the template's serve_queue_max")
    parser.add_argument("--workers", type=int, default=None,
                        help="override the template's serve_workers "
                             "(>1 = slice-packed runner pool: concurrent "
                             "tenants on disjoint device slices)")
    parser.add_argument("--no-prewarm", action="store_true",
                        help="skip the warm-up launches (the first job "
                             "pays the kernel builds and the card's warm-up)")
    parser.add_argument("--cpu", action="store_true",
                        help="serve on the CPU instead of the CUDA card (so "
                             "does a non-empty TCR_CONSENSUS_FORCE_CPU)")
    args = parser.parse_args(argv)
    cpu = args.cpu or bool(os.environ.get("TCR_CONSENSUS_FORCE_CPU"))
    with open(args.template) as fh:
        template = json.load(fh)
    state_dir = args.state_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.template)), "serve_state")
    daemon = Daemon(
        template, port=args.port, state_dir=state_dir,
        queue_max=args.queue_max,
        do_prewarm=False if args.no_prewarm else None,
        workers=args.workers, device="cpu" if cpu else "cuda",
    )
    return daemon.serve_forever()
