"""Failure classification, bounded retry, and the robustness report.

The JAX package's ``robustness/retry.py`` on the card's errors. Failures
that reach the pipeline's dispatch sites want different answers:

- **transient** device or transport faults (dropped connections, torn
  calls, the JAX package's XLA ``UNAVAILABLE`` family of messages): retry
  the same dispatch with bounded exponential backoff, on the same device.
  The work is deterministic, so a successful retry is byte-identical. A stage the watchdog
  cancelled (``watchdog.StageTimeout``) is transient too.
- **oom** (``torch.cuda.OutOfMemoryError``, host ``MemoryError``): the same
  shape fails again; the caller shrinks its batch (the polish dispatch's
  ladder) or gives up.
- **device_lost** (a device that is gone): neither a retry nor a smaller
  batch can land on it again, so the fault escalates.
- **fatal** (everything else, and an illegal address or a failed launch on
  the card, which leave the CUDA context unusable): never retried.

Nothing here falls back to the CPU. Every decision is recorded by the
process-wide :class:`RobustnessRecorder` and written to
``robustness_report.json`` at the run's end, with the armed chaos plan
(:mod:`.faults`) and its hit and fire counts, or null.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time

import torch

from ont_tcrconsensus_tpu_torch.obs import trace
from ont_tcrconsensus_tpu_torch.robustness import faults, jobscope, watchdog

#: substrings marking a CUDA error that poisons the context: checked first,
#: a retry on the same context can only fail again
FATAL_MARKERS = (
    "illegal memory access",
    "illegal address",
    "misaligned address",
    "unspecified launch failure",
)

#: substrings marking an exception as device or host memory exhaustion,
#: checked before the transient markers
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "resource_exhausted",
    "out of memory",
    "Out of memory",
    "OOM",
    "hbm",
    "HBM",
)

#: substrings marking the loss of a device, checked before the other sets
DEVICE_LOST_MARKERS = (
    "DEVICE_LOST",
    "device_lost",
    "Device lost",
    "device halted",
)

#: substrings marking an exception as a retryable device/transport fault
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "Connection reset",
    "socket closed",
    "Socket closed",
    "transfer to device",
    "device to host",
    "premature end of",
)


def classify(exc: BaseException) -> str:
    """``"transient" | "oom" | "device_lost" | "fatal"`` for an exception
    from a dispatch site. Unknown exceptions are fatal: retrying a
    deterministic bug only burns the retry budget."""
    if isinstance(exc, faults.DeviceLostChaosError):
        return "device_lost"
    if isinstance(exc, (faults.OomChaosError, torch.cuda.OutOfMemoryError, MemoryError)):
        return "oom"
    if isinstance(exc, faults.TransientChaosError):
        return "transient"
    if isinstance(exc, watchdog.StageTimeout):
        # a watchdog-cancelled stall: rerunning the dispatch is the
        # straggler answer (its message also carries DEADLINE_EXCEEDED)
        return "transient"
    if isinstance(exc, (ConnectionError, TimeoutError, BrokenPipeError)):
        return "transient"
    msg = f"{type(exc).__name__}: {exc}"
    if any(m in msg for m in FATAL_MARKERS):
        return "fatal"
    if any(m in msg for m in DEVICE_LOST_MARKERS):
        return "device_lost"
    if any(m in msg for m in OOM_MARKERS):
        return "oom"
    if any(m in msg for m in TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic seeded jitter.

    ``max_attempts`` counts the first try: 3 means one dispatch plus at
    most two retries. The jitter is a pure function of ``(seed, attempt)``,
    so a replayed run waits identically.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    jitter: float = 0.25
    seed: int = 0

    def delay(self, attempt: int) -> float:
        """Seconds to wait after failed attempt ``attempt`` (1-based)."""
        d = min(self.base_delay_s * (2.0 ** (attempt - 1)), self.max_delay_s)
        if self.jitter:
            rng = random.Random(f"{self.seed}:{attempt}")
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return d


class RobustnessRecorder:
    """Per-site attempt/outcome events behind ``robustness_report.json``.
    Thread-safe: overlapped QC commits and the polish loop record
    concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list[dict] = []

    def reset(self) -> None:
        with self._lock:
            self.events = []

    def record(self, site: str, *, classification: str, outcome: str,
               attempt: int = 1, error: str = "", detail: dict | None = None) -> None:
        ev = {
            "site": site,
            "attempt": attempt,
            "classification": classification,
            "outcome": outcome,
            "t_wall": round(time.time(), 6),
            "t_mono": round(time.monotonic(), 6),
        }
        if error:
            ev["error"] = error
        if detail:
            ev["detail"] = detail
        with self._lock:
            self.events.append(ev)
        # the same event on the trace timeline (a free no-op below
        # `telemetry: full`): retries, stalls and contract violations land
        # on the ruler of the stage spans
        trace.instant(site, args={
            "classification": classification, "outcome": outcome,
            "attempt": attempt,
        })

    def summary(self) -> dict:
        """{site: {events, by_classification, by_outcome}} aggregates."""
        out: dict[str, dict] = {}
        with self._lock:
            events = list(self.events)
        for ev in events:
            s = out.setdefault(ev["site"], {
                "events": 0, "by_classification": {}, "by_outcome": {},
            })
            s["events"] += 1
            for key, field in (("by_classification", "classification"),
                               ("by_outcome", "outcome")):
                v = ev[field]
                s[key][v] = s[key].get(v, 0) + 1
        return out

    def write(self, path: str, policy: "RetryPolicy | None" = None,
              contracts: dict | None = None) -> None:
        with self._lock:
            events = list(self.events)
        report = {
            "policy": dataclasses.asdict(policy) if policy is not None else None,
            "chaos": faults.describe(),
            # conservation-contract counters: a summary, not events; only
            # violations appear in sites/events
            "contracts": contracts,
            "sites": self.summary(),
            "events": events,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(report, fh, indent=1)
        os.replace(tmp, path)


# process-wide active policy/recorder: the deep dispatch sites reach them
# without signature plumbing; run.py installs the config's policy at run
# start. Under a jobscope each job binds its own recorder and policy.
_RECORDER = RobustnessRecorder()
_POLICY = RetryPolicy()


def _active_recorder() -> RobustnessRecorder:
    if jobscope.active():
        rec = jobscope.get("retry_recorder")
        if rec is None:
            rec = RobustnessRecorder()
            jobscope.set("retry_recorder", rec)
        return rec
    return _RECORDER


def _active_policy() -> RetryPolicy:
    pol = jobscope.get("retry_policy")
    return pol if pol is not None else _POLICY


def recorder() -> RobustnessRecorder:
    return _active_recorder()


def policy() -> RetryPolicy:
    return _active_policy()


def set_policy(p: RetryPolicy) -> RetryPolicy:
    global _POLICY
    if jobscope.active():
        jobscope.set("retry_policy", p)
        return p
    _POLICY = p
    return p


def call_with_retry(site: str, fn, *, policy: RetryPolicy | None = None,
                    recorder: RobustnessRecorder | None = None,
                    sleep=time.sleep, reset=None):
    """Run ``fn()`` under the transient-retry policy.

    Only transient failures back off and retry (up to
    ``policy.max_attempts`` attempts in all); fatal, oom and device_lost
    failures raise at once (these sites have no batch to shrink).
    ``reset`` runs before every retry so the callable can clear partial
    side effects (a half-filled QC row list). The last failure re-raises
    when the budget is spent.
    """
    pol = policy if policy is not None else _active_policy()
    rec = recorder if recorder is not None else _active_recorder()
    attempt = 1
    while True:
        try:
            result = fn()
        except Exception as exc:
            cls = classify(exc)
            if cls != "transient" or attempt >= pol.max_attempts:
                rec.record(site, classification=cls,
                           outcome=("fatal" if cls == "fatal"
                                    else "not_retryable" if cls == "oom"
                                    else "escalated" if cls == "device_lost"
                                    else "exhausted"),
                           attempt=attempt, error=repr(exc))
                raise
            rec.record(site, classification=cls, outcome="retried",
                       attempt=attempt, error=repr(exc))
            sleep(pol.delay(attempt))
            attempt += 1
            if reset is not None:
                reset()
        else:
            if attempt > 1:
                rec.record(site, classification="transient",
                           outcome="recovered", attempt=attempt)
            return result
