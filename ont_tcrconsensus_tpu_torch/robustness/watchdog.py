"""Liveness watchdog: per-stage soft/hard deadlines over a heartbeat API.

A copy of the JAX package's ``robustness/watchdog.py``. Some failures
raise nothing: a wedged dispatch, a stalled overlapped worker, a prefetch
thread stuck on a dead filesystem. The run just stops. This module finds
such a stage and cancels it:

- Long-running loops call :func:`heartbeat` (one module-attribute check
  when disarmed). A heartbeat resets the watched stage's stall clock, so
  steady progress never fires, however long the stage.
- Stage scopes register through :func:`guard` (a context manager).
  Deadlines derive from the config base (``stage_timeout_s``) through
  :func:`scaled_timeout`, so a 10x workload gets a 10x deadline.
- **Soft deadline** (``SOFT_FRACTION`` of the hard one): a
  ``watchdog.stall`` event in ``robustness_report.json`` and an
  all-thread stack dump to the library's ``logs/watchdog.log``.
- **Hard deadline**: the monitor raises :class:`StageTimeout` in the
  stalled thread through ``PyThreadState_SetAsyncExc``. The retry
  classifier (robustness/retry.py) treats it as transient, so the stage
  re-enters its bounded retry on the same device. The stall clock resets
  at the cancel, so the retry gets a fresh deadline.

The limit: an async exception lands between Python bytecodes. A thread
stalled in a Python loop is cancelled at once; a thread blocked inside
one C call (``cudaStreamSynchronize``, a cuDNN GRU, a ctypes kernel
launch) is detected and dumped on time, but cancelled only when the call
returns. Nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import faulthandler
import os
import sys
import threading
import time

from ont_tcrconsensus_tpu_torch.robustness import jobscope, lockcheck

#: soft deadline (stall REPORT) as a fraction of the hard deadline (CANCEL)
SOFT_FRACTION = 0.5

#: workload units one ``stage_timeout_s`` base covers; larger workloads
#: scale the deadline linearly (see :func:`scaled_timeout`)
UNITS_PER_BASE = 1000


class StageTimeout(RuntimeError):
    """A stage exceeded its hard deadline and was cancelled.

    The default message carries ``DEADLINE_EXCEEDED`` so
    ``retry.classify`` marks it transient even when the instance is
    constructed argument-less by the async-exc machinery (which can only
    deliver a TYPE, not an instance).
    """

    def __init__(self, message: str = "DEADLINE_EXCEEDED: stage hard "
                 "deadline expired (watchdog cancelled a stalled stage)"):
        super().__init__(message)


def scaled_timeout(base_s: float, units: int = 0,
                   units_per_base: int = UNITS_PER_BASE) -> float:
    """Hard deadline for a stage processing ``units`` work items.

    The configured base covers up to ``units_per_base`` units (and all
    fixed overhead — compiles, cache warmup), so tiny workloads keep the
    full base as headroom; beyond that the deadline scales linearly.
    Monotone in ``units``, never below ``base_s``.
    """
    if units <= units_per_base:
        return float(base_s)
    return float(base_s) * (units / float(units_per_base))


class _StageEntry:
    """One guarded stage scope on one thread."""

    __slots__ = ("name", "ident", "thread_name", "hard_s", "soft_s",
                 "last_beat", "last_site", "soft_fired", "cancel_count",
                 "prev")

    def __init__(self, name: str, ident: int, thread_name: str,
                 hard_s: float, soft_s: float, prev: "_StageEntry | None"):
        self.name = name
        self.ident = ident
        self.thread_name = thread_name
        self.hard_s = hard_s
        self.soft_s = soft_s
        self.last_beat = time.monotonic()
        self.last_site = ""
        self.soft_fired = False
        self.cancel_count = 0
        self.prev = prev


def _async_raise(ident: int, exc_type: type | None) -> int:
    """Queue ``exc_type`` (or clear the pending exception with ``None``)
    on the thread with id ``ident``; returns the number of threads hit."""
    return ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(ident),
        ctypes.py_object(exc_type) if exc_type is not None else None,
    )


class Watchdog:
    """Monitor thread + per-thread stage registry behind :func:`guard`."""

    def __init__(self, base_timeout_s: float,
                 soft_fraction: float = SOFT_FRACTION,
                 tick_s: float | None = None,
                 log_path: str | None = None):
        self.base_timeout_s = float(base_timeout_s)
        self.soft_fraction = soft_fraction
        # tick fast enough to resolve the shortest plausible deadline
        # (tests run with seconds-scale bases), slow enough to be free
        self.tick_s = tick_s if tick_s is not None else max(
            0.05, min(0.5, self.base_timeout_s / 16.0)
        )
        self.log_path = log_path
        self._entries: dict[int, _StageEntry] = {}
        self._lock = lockcheck.make_lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- stage registration -------------------------------------------------

    @contextlib.contextmanager
    def guard(self, name: str, units: int = 0):
        """Register the calling thread's stage scope for the monitor.

        The hard deadline is ``scaled_timeout(base, units)`` measured from
        the LAST heartbeat (not stage start); the soft deadline is
        ``soft_fraction`` of it. Nested guards stack per thread.
        """
        ident = threading.get_ident()
        hard = scaled_timeout(self.base_timeout_s, units)
        with self._lock:
            entry = _StageEntry(
                name, ident, threading.current_thread().name,
                hard, hard * self.soft_fraction, self._entries.get(ident),
            )
            self._entries[ident] = entry
        try:
            yield entry
        finally:
            # an async StageTimeout can land while THIS cleanup runs (the
            # stage completed right as the monitor fired, before the lock
            # below was acquired): catch it and redo the cleanup — the
            # entry MUST come off the registry, or the monitor would keep
            # cancelling this thread in unrelated code forever. A cancel
            # that lands here is swallowed on purpose: the stage body
            # already finished its work.
            while True:
                try:
                    with self._lock:
                        if self._entries.get(ident) is entry:
                            if entry.prev is not None:
                                # the outer scope's clock was frozen while
                                # the inner guard was registered: restart
                                # it NOW, or the first monitor tick would
                                # see the whole inner stage's duration as
                                # an outer stall and cancel a healthy scope
                                entry.prev.last_beat = time.monotonic()
                                entry.prev.soft_fired = False
                                self._entries[ident] = entry.prev
                            else:
                                del self._entries[ident]
                        if entry.cancel_count:
                            # a cancel was issued for this scope: if its
                            # async exc was never delivered (the thread sat
                            # in C code until the stage completed anyway),
                            # clear it so it cannot land in unrelated code
                            # later. No-op when it already surfaced.
                            _async_raise(ident, None)
                    break
                except StageTimeout:
                    continue

    def beat(self, site: str) -> None:
        # under the registry lock: _on_hard's staleness recheck + delivery
        # run under the same lock, so a heartbeat can never land between
        # the recheck and the cancel — a stage that just made progress is
        # genuinely safe, not just probabilistically
        with self._lock:
            entry = self._entries.get(threading.get_ident())
            if entry is not None:
                entry.last_beat = time.monotonic()
                entry.last_site = site
                # progress resumed: re-arm the soft report so a SECOND
                # stall in this scope is diagnosed (event + dump) again,
                # not only at its hard cancel
                entry.soft_fired = False

    def current_deadline_s(self) -> float | None:
        entry = self._entries.get(threading.get_ident())
        return entry.hard_s if entry is not None else None

    def entries_snapshot(self) -> list[dict]:
        """Per-stage heartbeat ages for the live plane (/healthz verdict,
        /metrics gauges): one locked pass, age measured against a single
        clock read so the staleness comparison is self-consistent."""
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "stage": e.name,
                    "thread": e.thread_name,
                    "heartbeat_age_s": round(now - e.last_beat, 3),
                    "soft_deadline_s": round(e.soft_s, 3),
                    "hard_deadline_s": round(e.hard_s, 3),
                    "last_heartbeat_site": e.last_site,
                    "soft_fired": e.soft_fired,
                }
                for e in self._entries.values()
            ]

    # --- monitor ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._monitor, name="stage-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _monitor(self) -> None:
        while not self._stop.wait(self.tick_s):
            with self._lock:
                entries = list(self._entries.values())
            for entry in entries:
                # fresh clock read per entry: an earlier entry's synchronous
                # stack-dump I/O in this same tick must not widen a later
                # entry's apparent stall
                stalled = time.monotonic() - entry.last_beat
                if stalled >= entry.soft_s and not entry.soft_fired:
                    entry.soft_fired = True
                    self._on_soft(entry, stalled)
                if stalled >= entry.hard_s:
                    self._on_hard(entry, stalled)

    def _record(self, outcome: str, entry: _StageEntry, stalled: float) -> None:
        from ont_tcrconsensus_tpu_torch.robustness import retry

        retry.recorder().record(
            "watchdog.stall", classification="stall", outcome=outcome,
            detail={
                "stage": entry.name,
                "thread": entry.thread_name,
                "stalled_s": round(stalled, 3),
                "soft_deadline_s": round(entry.soft_s, 3),
                "hard_deadline_s": round(entry.hard_s, 3),
                "last_heartbeat_site": entry.last_site,
            },
        )

    def _dump_stacks(self, header: str) -> None:
        """All-thread faulthandler dump to the library log (post-hoc
        diagnosis for a wedged run) and a one-line notice to stderr."""
        sys.stderr.write(header + "\n")
        if not self.log_path:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            return
        try:
            with open(self.log_path, "a") as fh:
                fh.write(f"{header} (unix time {time.time():.1f})\n")
                faulthandler.dump_traceback(file=fh, all_threads=True)
                fh.write("\n")
        except OSError as exc:  # diagnosis must never kill the monitor
            sys.stderr.write(f"watchdog: cannot write {self.log_path}: {exc!r}\n")
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)

    def _on_soft(self, entry: _StageEntry, stalled: float) -> None:
        self._record("stall_detected", entry, stalled)
        self._dump_stacks(
            f"watchdog: stage {entry.name!r} ({entry.thread_name}) has not "
            f"heartbeat for {stalled:.1f}s (soft deadline "
            f"{entry.soft_s:.1f}s, hard {entry.hard_s:.1f}s; last site "
            f"{entry.last_site or '<none>'}) — dumping all thread stacks"
        )

    def _on_hard(self, entry: _StageEntry, stalled: float) -> None:
        # the send happens under the registry lock, mutually exclusive with
        # the guard's unregister: a cancel can never target a scope that
        # already exited (the async exc would land in unrelated code)
        with self._lock:
            if self._entries.get(entry.ident) is not entry:
                return
            # recheck staleness under the lock: a heartbeat may have landed
            # since the monitor's snapshot — cancelling a stage that just
            # made progress would discard completed work and burn a retry
            stalled = time.monotonic() - entry.last_beat
            if stalled < entry.hard_s:
                return
            entry.cancel_count += 1
            # reset the stall clock BEFORE delivering: the retry attempt
            # that catches the StageTimeout runs inside the same guard
            # scope and must start with a fresh deadline, and soft_fired
            # re-arms so a second stall is reported again
            entry.last_beat = time.monotonic()
            entry.soft_fired = False
            _async_raise(entry.ident, StageTimeout)
        self._record("hard_cancel", entry, stalled)
        self._dump_stacks(
            f"watchdog: stage {entry.name!r} exceeded its hard deadline "
            f"({stalled:.1f}s > {entry.hard_s:.1f}s); cancelled "
            f"(StageTimeout -> the transient retry/degrade path)"
        )
        # hard expiry is a likely prelude to a dead run: flush the flight
        # recorder NOW (obs/live.py sink) while the process still can.
        # Best-effort — a flush failure must never kill the monitor.
        sink = _EXPIRY_SINK
        if sink is not None:
            try:
                sink(entry.name)
            except Exception as exc:
                sys.stderr.write(
                    f"watchdog: expiry sink failed: {exc!r}\n")


# Lock ownership for Watchdog._entries (-> _lock) is declared in the
# port's lock table (robustness/locks.py), which lockcheck reads.


# --- process-wide active watchdog (same discipline as retry) ---------------
#
# Under a jobscope (slice-packed runner pool) each resident tenant job
# binds its own watchdog thread-locally: two concurrent runs each get
# their own monitor with their own deadlines, and neither run's
# activate/deactivate perturbs the other. The scoped entry is a
# ``(wd,)`` 1-tuple so an in-scope deactivate tombstones (the scoped
# thread must NOT fall back to some other run's global watchdog).

_ACTIVE: Watchdog | None = None


def _current() -> Watchdog | None:
    entry = jobscope.get("watchdog")
    if entry is not None:
        return entry[0]
    return _ACTIVE


def activate(wd: Watchdog) -> Watchdog:
    global _ACTIVE
    if jobscope.active():
        jobscope.set("watchdog", (wd,))
        return wd
    _ACTIVE = wd
    return wd


def deactivate(wd: Watchdog | None = None) -> None:
    global _ACTIVE
    if jobscope.active():
        entry = jobscope.get("watchdog")
        if entry is not None and (wd is None or entry[0] is wd):
            jobscope.set("watchdog", (None,))
        return
    if wd is None or _ACTIVE is wd:
        _ACTIVE = None


def active() -> bool:
    return _current() is not None


def heartbeat(site: str) -> None:
    """Reset the calling thread's stage stall clock; free no-op when the
    watchdog is disarmed or the thread holds no guard. Independently, a
    live-plane beat sink (obs/live.py flight recorder) sees every beat —
    heartbeats are progress evidence worth keeping post-mortem even on
    runs where the watchdog itself is disarmed."""
    wd = _current()
    if wd is not None:
        wd.beat(site)
    sink = _BEAT_SINK
    if sink is not None:
        sink(site)


def guard(name: str, units: int = 0):
    """Stage scope context manager; ``nullcontext`` when disarmed."""
    wd = _current()
    if wd is None:
        return contextlib.nullcontext()
    return wd.guard(name, units)


def active_deadline_s() -> float | None:
    """The calling thread's current hard deadline (None when unguarded /
    disarmed)."""
    wd = _current()
    return wd.current_deadline_s() if wd is not None else None


def set_log_path(path: str | os.PathLike[str]) -> None:
    """Point stall stack dumps at the current library's log file."""
    wd = _current()
    if wd is not None:
        wd.log_path = os.fspath(path)


def snapshot() -> list[dict] | None:
    """Per-stage heartbeat ages (None when the watchdog is disarmed) —
    the live plane's /healthz staleness verdict and /metrics gauges."""
    wd = _current()
    return wd.entries_snapshot() if wd is not None else None


# --- live-plane sinks (obs/live.py; same one-attr-check discipline) ---------

_BEAT_SINK = None
_EXPIRY_SINK = None


def set_beat_sink(sink) -> None:
    """Install/remove a callable(site) fed every heartbeat (flight ring)."""
    global _BEAT_SINK
    _BEAT_SINK = sink


def set_expiry_sink(sink) -> None:
    """Install/remove a callable(stage) fired after a hard-deadline
    cancel (the flight recorder's crash-prelude flush trigger)."""
    global _EXPIRY_SINK
    _EXPIRY_SINK = sink
