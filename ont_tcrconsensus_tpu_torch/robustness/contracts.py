"""Stage-boundary conservation contracts (runtime accounting self-checks).

A copy of the JAX package's ``robustness/contracts.py``, checked at the
same sites:

- **ingest**: records parsed == reads entering the device pass + reads
  dropped by the length buckets
- **assign**: the fused-pass filter categories partition the batch total,
  and the columnar store holds exactly the passing reads
- **umi**: per-group cluster-stats member totals equal the eligible UMI
  records, conserved across the sub-threshold rescue merge
- **consensus**: consensus records == selected clusters per group, and the
  merged FASTA holds exactly those records
- **counts**: the counts CSV reads back equal to the in-memory totals

Modes (config key ``contracts``): ``off`` (checks skipped), ``warn``
(default: violations logged and recorded in ``robustness_report.json``),
``strict`` (violations also raise :class:`ContractViolation`, failing the
run). A check is a handful of integer compares.
"""

from __future__ import annotations

import sys
import threading

from ont_tcrconsensus_tpu_torch.robustness import jobscope

MODES = ("off", "warn", "strict")

# process-wide mode + counters; under a jobscope each job binds its own
# {mode, checked, violated} state thread-locally, so a concurrent run's
# reset/set_mode never wipes another job's counters. The module lock
# guards counter mutation for both shapes.
_MODE = "warn"
_lock = threading.Lock()
_checked: dict[str, int] = {}
_violated: dict[str, int] = {}


class ContractViolation(RuntimeError):
    """A conservation invariant failed under ``contracts=strict``."""


def _scoped_state() -> dict | None:
    return jobscope.get("contracts")


def _ensure_scoped() -> dict:
    st = jobscope.get("contracts")
    if st is None:
        st = {"mode": _MODE, "checked": {}, "violated": {}}
        jobscope.set("contracts", st)
    return st


def mode() -> str:
    st = _scoped_state()
    if st is not None:
        return st["mode"]
    return _MODE


def set_mode(new_mode: str) -> str:
    global _MODE
    if new_mode not in MODES:
        raise ValueError(f"contracts mode {new_mode!r} not in {MODES}")
    if jobscope.active():
        _ensure_scoped()["mode"] = new_mode
        return new_mode
    _MODE = new_mode
    return _MODE


def reset() -> None:
    """Clear the per-run check/violation counters (run start)."""
    if jobscope.active():
        st = _ensure_scoped()
        with _lock:
            st["checked"].clear()
            st["violated"].clear()
        return
    with _lock:
        _checked.clear()
        _violated.clear()


def summary() -> dict:
    """{checked: {name: n}, violated: {name: n}} for the robustness report."""
    st = _scoped_state()
    with _lock:
        if st is not None:
            return {"mode": st["mode"], "checked": dict(st["checked"]),
                    "violated": dict(st["violated"])}
        return {"mode": _MODE, "checked": dict(_checked),
                "violated": dict(_violated)}


def check_equal(name: str, lhs_desc: str, lhs, rhs_desc: str, rhs,
                detail: dict | None = None) -> bool:
    """Assert ``lhs == rhs`` under the active mode; returns whether it held.

    ``off`` skips entirely. Violations are recorded in the robustness
    recorder (site ``contracts.<name>``), logged to stderr under ``warn``,
    and raised as :class:`ContractViolation` under ``strict``.
    """
    active_mode = mode()
    st = _scoped_state()
    checked = st["checked"] if st is not None else _checked
    violated = st["violated"] if st is not None else _violated
    if active_mode == "off":
        return True
    with _lock:
        checked[name] = checked.get(name, 0) + 1
    if lhs == rhs:
        return True
    with _lock:
        violated[name] = violated.get(name, 0) + 1
    message = (f"conservation contract {name!r} violated: "
               f"{lhs_desc} ({lhs!r}) != {rhs_desc} ({rhs!r})")
    from ont_tcrconsensus_tpu_torch.robustness import retry

    retry.recorder().record(
        f"contracts.{name}", classification="contract", outcome="violation",
        error=message, detail=detail,
    )
    if active_mode == "strict":
        raise ContractViolation(message)
    print(f"WARNING: {message}", file=sys.stderr)
    return False
