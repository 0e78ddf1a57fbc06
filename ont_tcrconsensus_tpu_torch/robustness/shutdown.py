"""Preemption-safe shutdown: SIGTERM/SIGINT -> drain -> resumable exit.

A copy of the JAX package's ``robustness/shutdown.py``. The coordinator
turns a signal into a cooperative stop:

1. the first SIGTERM/SIGINT sets a flag (and logs); work in progress is
   not interrupted mid-dispatch,
2. the pipeline polls :func:`checkpoint` at stage boundaries and raises
   :class:`Preempted` at the first one after the flag,
3. the per-library guard in ``pipeline/run.py`` drains the overlap
   executor's background stages, the run writes its robustness report, and
   the process exits with every committed checkpoint intact (the CLI
   returns 143): ``resume=true`` continues byte-identically,
4. a second signal restores the previous disposition and re-delivers, for
   an operator who means "now".

:class:`Preempted` derives from ``BaseException`` on purpose: the
per-library ``except Exception`` guard must never swallow a preemption into
"library failed, skipped". The coordinator installs handlers for SIGTERM
and SIGINT only (on the main thread only), so the run's SIGUSR1 flight
recorder hook and its SIGQUIT stack dump keep working while it is armed.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

from ont_tcrconsensus_tpu_torch.robustness import jobscope


class Preempted(BaseException):
    """Raised at a stage-boundary checkpoint after a shutdown request."""

    def __init__(self, reason: str, site: str = ""):
        self.reason = reason
        self.site = site
        super().__init__(f"{reason} (observed at {site or 'checkpoint'})")


class ShutdownCoordinator:
    """Installable SIGTERM/SIGINT-to-checkpoint bridge (context manager)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._flag = threading.Event()
        self._reason: str | None = None
        self._previous: dict[int, object] = {}
        self._installed = False
        self._signals_seen = 0

    # --- request side -----------------------------------------------------

    def request(self, reason: str) -> None:
        """Ask for a stop at the next checkpoint (signal-handler and
        chaos-injection entry point; safe from any thread)."""
        self._reason = self._reason or reason
        self._flag.set()

    def _on_signal(self, signum, frame) -> None:
        # count REAL signals separately from cooperative requests (chaos
        # preempt, request()): the first actual SIGTERM after a cooperative
        # stop must still take the drain path, not the kill-now escalation
        self._signals_seen += 1
        if self._signals_seen > 1:
            # second signal: the operator means NOW — restore defaults and
            # re-deliver so the default disposition (terminate) applies
            sys.stderr.write(
                f"shutdown: second signal {signum}; exiting immediately\n"
            )
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        sys.stderr.write(
            f"shutdown: signal {signum} received; draining to the next "
            "stage boundary (resume=true continues this run)\n"
        )
        self.request(f"signal {signum}")

    # --- poll side --------------------------------------------------------

    def requested(self) -> bool:
        return self._flag.is_set()

    def checkpoint(self, site: str) -> None:
        if self._flag.is_set():
            raise Preempted(self._reason or "shutdown requested", site)

    # --- installation -----------------------------------------------------

    def install(self) -> bool:
        """Register handlers; False when not on the main thread (signal
        registration is main-thread-only — worker-thread pipelines still
        get cooperative stops via :func:`request`)."""
        if self._installed:
            return True
        try:
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread
            self._previous.clear()
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "ShutdownCoordinator":
        self.install()
        return activate(self)

    def __exit__(self, *exc) -> None:
        self.uninstall()
        deactivate(self)


# process-wide active coordinator, mirroring faults/retry: deep stage code
# polls checkpoints without plumbing the coordinator through signatures.
# Kept as a stack so nesting works: an outer coordinator (a serving
# loop's) becomes active again when an inner run's deactivates. Under a
# jobscope a run's coordinator binds thread-locally, and a scoped
# checkpoint also polls the process-global one, so one signal to the outer
# coordinator stops every scoped run at its next stage boundary.
_ACTIVE: ShutdownCoordinator | None = None
_STACK: list[ShutdownCoordinator] = []


def activate(coord: ShutdownCoordinator) -> ShutdownCoordinator:
    global _ACTIVE
    if jobscope.active():
        jobscope.set("shutdown", coord)
        return coord
    _STACK.append(coord)
    _ACTIVE = coord
    return coord


def deactivate(coord: ShutdownCoordinator | None = None) -> None:
    """Pop ``coord`` (default: the top) off the active stack; the previous
    coordinator — if any — becomes active again."""
    global _ACTIVE
    if jobscope.active() and jobscope.get("shutdown") is coord:
        jobscope.set("shutdown", None)
        return
    if coord is None:
        if _STACK:
            _STACK.pop()
    elif coord in _STACK:
        _STACK.remove(coord)
    _ACTIVE = _STACK[-1] if _STACK else None


def request(reason: str) -> None:
    """Request a cooperative stop on the active coordinator (no-op when
    none is active — e.g. library code called outside run.py)."""
    coord = jobscope.get("shutdown")
    if coord is not None:
        coord.request(reason)
        return
    if _ACTIVE is not None:
        _ACTIVE.request(reason)


def checkpoint(site: str) -> None:
    """Raise :class:`Preempted` here if a stop was requested; free no-op
    otherwise (one global check, same discipline as faults.inject)."""
    coord = jobscope.get("shutdown")
    if coord is not None:
        coord.checkpoint(site)
    if _ACTIVE is not None:
        _ACTIVE.checkpoint(site)
