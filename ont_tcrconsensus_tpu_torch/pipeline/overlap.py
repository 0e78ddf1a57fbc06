"""Off-critical-path stage execution with ordered artifact commits.

The JAX package's ``pipeline/overlap.py``. Stages whose artifacts nothing
on the critical path consumes (the error profiles, the intermediate region
FASTAs) run on bounded worker threads, overlapped with the critical path
(round-1 polish, round-2 clustering), and every artifact stays the serial
run's byte for byte:

- COMPUTE happens on a worker thread, which reads only the immutable
  columnar blocks and makes its own device copies. On CUDA it runs on its
  own ``torch.cuda.Stream`` and synchronizes that stream before it hands
  its result over, so the main thread never waits on its kernels, nor it
  on the main thread's.
- COMMIT (file writes + failure propagation) happens on the MAIN thread,
  in submission order, at fixed points before the library's checkpoints.
  A worker's failure is re-raised there.
- In-flight work is bounded by a permit semaphore: each deferred stage
  pins its inputs (a library's read store) until committed.

Timing is split the same way: a stage's own entry records only the
critical-path cost (the wait at its commit, ~0 when the overlap worked),
and the worker's wall clock is recorded under ``<stage>_bg``. That clock
is an :mod:`..obs.trace` span opened on the worker thread, so at
``telemetry: full`` the same measurement is the worker's own row on the
trace timeline. Each worker runs under its own watchdog guard, and the
pool's busy/idle split goes to telemetry (``overlap.pool``).
"""

from __future__ import annotations

import threading
import time

import torch

from ont_tcrconsensus_tpu_torch.obs import metrics as obs_metrics
from ont_tcrconsensus_tpu_torch.obs import trace
from ont_tcrconsensus_tpu_torch.robustness import faults, jobscope, lockcheck, watchdog


class DeferredStage:
    """One background stage: compute on a worker, result at commit time."""

    def __init__(self, name: str, permits: threading.Semaphore,
                 device: torch.device | None = None, units: int = 0, on_done=None):
        self.name = name
        self.units = units
        self._permits = permits
        self._device = device
        self._on_done = on_done
        self._done = threading.Event()
        self._result = None
        self._exc: BaseException | None = None
        self._call: tuple | None = None  # (fn, args, kwargs) for rerun_sync
        self._scope: dict | None = None  # the submitter's job scope
        self.worker_seconds = 0.0

    def _run(self, fn, args, kwargs) -> None:
        # the worker joins its submitter's job scope (a no-op unscoped)
        jobscope.adopt(self._scope)
        # one clock read at the span's exit is both `<name>_bg` and the
        # worker's row on the trace timeline
        sp = trace.span(f"{self.name}_bg", cat="overlap")
        try:
            with sp:
                # the worker's own watchdog scope (guards are per thread),
                # its deadline scaled by the caller's workload hint: a
                # stalled worker is cancelled with a StageTimeout that
                # surfaces at commit and is recomputed there
                with watchdog.guard(f"overlap.{self.name}", units=self.units):
                    # chaos site: a worker dying mid-stage (the injected
                    # exception surfaces at commit, like any worker failure)
                    faults.inject("overlap.worker")
                    watchdog.heartbeat("overlap.worker")
                    if self._device is not None and self._device.type == "cuda":
                        stream = torch.cuda.Stream(self._device)
                        try:
                            with torch.cuda.stream(stream):
                                self._result = fn(*args, **kwargs)
                        finally:
                            stream.synchronize()
                    else:
                        self._result = fn(*args, **kwargs)
        except BaseException as exc:  # re-raised on the main thread at commit
            self._exc = exc
        finally:
            self.worker_seconds = sp.dur_s
            if self._on_done is not None:
                self._on_done(self.worker_seconds)
            self._done.set()
            self._permits.release()

    def rerun_sync(self):
        """Re-execute the stage's callable on the calling thread: the retry
        path for a worker that died of a transient fault. The inputs are
        immutable, so the artifact is identical; only the overlap is lost."""
        fn, args, kwargs = self._call
        return fn(*args, **kwargs)

    def wait(self):
        """Block until the worker finishes; re-raise its failure here."""
        self._done.wait()
        if self._exc is not None:
            raise self._exc
        return self._result


class StageExecutor:
    """Bounded-worker scheduler for stages whose artifacts nothing on the
    critical path consumes. ``max_in_flight`` bounds the live background
    stages (a permit is taken at submit and released when the worker
    finishes): a memory bound, not just a thread bound. ``device`` is the
    run's device: on CUDA each worker gets its own stream."""

    def __init__(self, max_in_flight: int = 2, device: torch.device | None = None):
        self._permits = threading.Semaphore(max_in_flight)
        self._pending: list[DeferredStage] = []
        self._device = device
        self._slots = max_in_flight
        # the pool's busy/idle split: window = first submit .. last worker
        # completion, busy = summed worker clocks, idle = window * slots - busy
        self._stats_lock = lockcheck.make_lock()
        self._t_first_submit: float | None = None
        self._t_last_done: float | None = None
        self._busy_s = 0.0
        self._pool_recorded = False

    def _note_done(self, worker_seconds: float) -> None:
        with self._stats_lock:
            self._busy_s += worker_seconds
            self._t_last_done = time.monotonic()

    def record_pool_metrics(self) -> None:
        """Roll this pool's busy/idle split into the armed registry (once;
        a no-op when nothing was submitted). Call after the pool drained."""
        with self._stats_lock:
            if self._pool_recorded or self._t_first_submit is None:
                return
            self._pool_recorded = True
            end = self._t_last_done or self._t_first_submit
            window = max(end - self._t_first_submit, 0.0)
            busy = self._busy_s
        obs_metrics.pool_add(
            "overlap.pool", busy_s=busy,
            idle_s=max(window * self._slots - busy, 0.0),
            window_s=window, slots=self._slots,
        )

    def submit(self, name: str, fn, /, *args, units: int = 0, **kwargs) -> DeferredStage:
        """Start ``fn(*args, **kwargs)`` on a worker thread; blocks only
        when ``max_in_flight`` stages are already live. ``units`` sizes the
        worker's watchdog deadline (``watchdog.scaled_timeout``)."""
        self._permits.acquire()
        with self._stats_lock:
            if self._t_first_submit is None:
                self._t_first_submit = time.monotonic()
        stage = DeferredStage(name, self._permits, device=self._device, units=units,
                              on_done=self._note_done)
        stage._call = (fn, args, kwargs)
        stage._scope = jobscope.current()
        threading.Thread(
            target=stage._run, args=(fn, args, kwargs),
            name=f"stage-{name}", daemon=True,
        ).start()
        self._pending.append(stage)
        return stage

    def commit(self, stage: DeferredStage, timer=None):
        """Block until ``stage`` finishes and return its result, re-raising
        any worker failure on this (the main) thread.

        With ``timer``, the blocking wait is recorded under the stage's own
        name (the critical-path cost) and the worker's wall clock under
        ``<name>_bg``, even when the stage failed.
        """
        try:
            if timer is not None:
                try:
                    with timer.stage(stage.name):
                        result = stage.wait()
                finally:
                    timer.add(stage.name + "_bg", stage.worker_seconds)
            else:
                result = stage.wait()
        finally:
            # a failed commit still retires the stage, so wait_all() on the
            # failure path does not report it a second time
            if stage in self._pending:
                self._pending.remove(stage)
        return result

    def wait_all(self) -> list[tuple[str, BaseException]]:
        """Wait for every pending stage without raising; returns the
        failures as (name, exception) pairs. The failure-path cleanup: a
        library that died on the critical path leaves no worker running
        into the next library."""
        failures: list[tuple[str, BaseException]] = []
        for stage in list(self._pending):
            try:
                stage.wait()
            except BaseException as exc:
                failures.append((stage.name, exc))
            self._pending.remove(stage)
        return failures
