"""Span/instant API + the Chrome-trace-format ``logs/trace.json`` emitter.

Spans are class-based context managers so callers that need the measured
duration on failure paths (``overlap.DeferredStage``) can hold the object.
Every span exit performs ONE duration computation that feeds all three
consumers — :class:`~ont_tcrconsensus_tpu_torch.qc.timing.StageTimer` (the
``stage_timing.tsv`` rows), the armed :class:`MetricsRegistry` stage
table (the ``telemetry.json`` roll-up), and the armed
:class:`TraceCollector` (the ``trace.json`` timeline) — so the timing
table and the trace derive from one clock read and cannot disagree.

The collector writes the Chrome trace-event JSON object format
(``{"traceEvents": [...]}``): ``X`` complete events per span (one row per
thread, named via ``M``/``thread_name`` metadata), ``i`` instant events
for point-in-time occurrences (retries, chaos injections, watchdog
stalls/cancels, contract violations, kernel builds — emitted by
``robustness/retry.RobustnessRecorder.record``, so the robustness report
and the trace line up on one timeline), and ``C`` counter events from the
memory sampler. Load in ``chrome://tracing`` / Perfetto; it complements a
``profile_trace_dir`` capture of ``torch.profiler`` (per-kernel device
detail) with the host-side stage and thread structure.

A copy of the JAX package's ``obs/trace.py``. Each thread also keeps a
span-label stack whether or not anything is armed (:func:`current_label`);
the build audit (:mod:`.device`) reads it to attribute each kernel build
to the active stage.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from ont_tcrconsensus_tpu_torch.obs import metrics

_tls = threading.local()


def _label_stack() -> list[str]:
    stack = getattr(_tls, "labels", None)
    if stack is None:
        stack = _tls.labels = []
    return stack


def current_label() -> str:
    """Innermost active span name on the calling thread ('' when none)."""
    stack = getattr(_tls, "labels", None)
    return stack[-1] if stack else ""


class Span:
    """One measured scope. ``dur_s`` is valid after exit, also when the
    body raised (the duration still reaches the timer/trace consumers)."""

    __slots__ = ("name", "cat", "args", "t0", "dur_s")

    def __init__(self, name: str, cat: str = "stage", args: dict | None = None):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.dur_s = 0.0

    def __enter__(self) -> "Span":
        _label_stack().append(self.name)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_s = time.monotonic() - self.t0
        stack = _label_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        reg = metrics._ARMED
        if reg is not None:
            reg.stage_add(self.name, self.dur_s)
        col = _ARMED
        if col is not None:
            col.add_span(self)
        ring = _RING
        if ring is not None:
            ring.add_span(self)
        return False


def span(name: str, cat: str = "stage", args: dict | None = None) -> Span:
    """A measured scope; recorded into the trace/metrics only when armed."""
    return Span(name, cat=cat, args=args)


def instant(name: str, args: dict | None = None) -> None:
    """Point-in-time trace event; free no-op when tracing is disarmed."""
    col = _ARMED
    if col is not None:
        col.add_instant(name, args)
    ring = _RING
    if ring is not None:
        ring.add_instant(name, args)


#: in-memory event cap: a multi-hour ``telemetry: full`` run (sampler
#: counters alone are ~18k events/h) must not grow host RSS without bound
#: or let the trace buffer masquerade as pipeline memory in the RSS gauge.
#: At the cap new events are DROPPED and counted — trace.json reports
#: ``dropped_events`` in otherData so truncation is never silent.
MAX_EVENTS = 1_000_000


class TraceCollector:
    """Chrome-trace event accumulator (armed at ``telemetry: full``)."""

    def __init__(self, max_events: int = MAX_EVENTS):
        self._lock = threading.Lock()
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self.pid = os.getpid()
        self.max_events = max_events
        self.dropped = 0
        self.events: list[dict] = []
        self._named_tids: set[int] = set()

    def _ts(self, mono: float) -> float:
        """Monotonic seconds -> trace microseconds since collector start.
        The same mapping places robustness events (which carry ``t_mono``,
        see retry.RobustnessRecorder) exactly on this timeline."""
        return (mono - self.t0_mono) * 1e6

    def _base(self, extra: dict) -> dict:
        tid = threading.get_ident()
        ev = {"pid": self.pid, "tid": tid, **extra}
        with self._lock:
            if len(self.events) >= self.max_events:
                if not self.dropped:
                    sys.stderr.write(
                        f"telemetry: trace buffer full ({self.max_events} "
                        "events); dropping further events (count reported "
                        "in trace.json otherData.dropped_events)\n"
                    )
                self.dropped += 1
                return ev
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self.events.append({
                    "ph": "M", "name": "thread_name", "pid": self.pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            self.events.append(ev)
        return ev

    def add_span(self, sp: Span) -> None:
        ev = {
            "ph": "X", "name": sp.name, "cat": sp.cat,
            "ts": self._ts(sp.t0), "dur": sp.dur_s * 1e6,
        }
        if sp.args:
            ev["args"] = dict(sp.args)
        self._base(ev)

    def add_instant(self, name: str, args: dict | None = None) -> None:
        ev = {
            "ph": "i", "name": name, "cat": "event", "s": "t",
            "ts": self._ts(time.monotonic()),
        }
        if args:
            ev["args"] = dict(args)
        self._base(ev)

    def add_counter(self, name: str, values: dict) -> None:
        self._base({
            "ph": "C", "name": name, "cat": "memory",
            "ts": self._ts(time.monotonic()), "args": dict(values),
        })

    def write(self, path: str) -> None:
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "t0_wall": round(self.t0_wall, 6),
                "t0_mono": round(self.t0_mono, 6),
                "dropped_events": dropped,
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)


# --- process-wide armed collector -------------------------------------------

_ARMED: TraceCollector | None = None


def arm() -> TraceCollector:
    global _ARMED
    _ARMED = TraceCollector()
    return _ARMED


def disarm() -> None:
    global _ARMED
    _ARMED = None


def collector() -> TraceCollector | None:
    return _ARMED


# --- flight-recorder tap (obs/live.py) --------------------------------------
#
# A SECOND slot, deliberately distinct from the full collector: the live
# plane's bounded ring is armed by ``live_port`` (not ``telemetry: full``),
# so spans and instants reach the crash flight recorder even on runs where
# the unbounded trace collector stays off. Same one-attr-check discipline.

_RING = None


def set_ring(ring) -> None:
    global _RING
    _RING = ring
