"""Runtime lock-ownership checks (``TCR_LOCKCHECK=1``).

A copy of the JAX package's ``robustness/lockcheck.py``. Disarmed (the
default) the hot path pays one module-attribute check; armed,
:func:`make_lock` hands out ``threading.RLock`` (whose CPython
``_is_owned()`` lets any thread ask "do I hold this?") and
:func:`assert_held` records a violation instead of raising: a checked run
must finish byte-identical, with its violations on stderr.

Arming must happen before the guarded objects are built (their locks are
chosen in ``__init__``): the pipeline arms from the environment first in
``run_with_config``, ahead of the watchdog, the metrics registry and the
live plane, and the module arms at import when ``TCR_LOCKCHECK`` is
already set, so a subprocess needs no code hook. :func:`assert_held` skips
locks made before arming (a plain ``Lock`` has no ``_is_owned``).
Which lock guards which attribute is the lock table of :mod:`.locks`;
:func:`assert_owner` checks a class's lock by that table.
"""

from __future__ import annotations

import os
import sys
import threading

from ont_tcrconsensus_tpu_torch.robustness import locks

ENV_VAR = "TCR_LOCKCHECK"

#: bounded so a hot loop with a broken caller cannot grow without limit
MAX_VIOLATIONS = 100

_ARMED: bool = os.environ.get(ENV_VAR, "") not in ("", "0")
#: guards _VIOLATIONS — assert_held fires from any instrumented thread.
#: RLock, not Lock: the SIGUSR1 flush path can re-enter assert_held on
#: the main thread mid-append; reentrancy turns self-deadlock into a
#: harmless nested (GIL-atomic) append.
_VLOCK = threading.RLock()
_VIOLATIONS: list[str] = []


def armed() -> bool:
    return _ARMED


def arm() -> None:
    """Arm owner-assertions; locks made AFTER this call are checkable."""
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def arm_from_env() -> bool | None:
    """Arm when ``TCR_LOCKCHECK`` is set; returns None untouched when it
    is not."""
    if os.environ.get(ENV_VAR, "") in ("", "0"):
        return None
    arm()
    return True


def make_lock():
    """The lock constructor of every checked lock.

    Disarmed: a plain ``threading.Lock`` — zero overhead, zero behavior
    change. Armed: a ``threading.RLock``, which (a) exposes
    ``_is_owned()`` for :func:`assert_held` and (b) stays
    ``threading.Condition``-compatible, so ``Condition(self._lock)``
    users work identically under either.
    """
    return threading.RLock() if _ARMED else threading.Lock()


def assert_held(lock, label: str) -> None:
    """Record a violation if the calling thread does not own ``lock``.

    Planted in the ``*_locked`` caller-holds-the-lock contract methods.
    Disarmed this is one module-attribute check; armed it never raises
    (the run must complete so outputs can be compared byte-for-byte) —
    violations land on stderr and in :func:`violations`.
    """
    if not _ARMED:
        return
    is_owned = getattr(lock, "_is_owned", None)
    if is_owned is None or is_owned():
        return  # pre-arming plain Lock, or properly held
    msg = (f"lockcheck: {label} entered without owning its lock "
           f"(thread {threading.current_thread().name})")
    with _VLOCK:
        if len(_VIOLATIONS) < MAX_VIOLATIONS:
            _VIOLATIONS.append(msg)
    sys.stderr.write(msg + "\n")


def assert_owner(obj, label: str) -> None:
    """:func:`assert_held` on the lock that the lock table
    (:data:`.locks.LOCK_OWNERSHIP`) names for ``obj``'s class; a class the
    table does not list is not checked."""
    if not _ARMED:
        return
    owned = locks.ownership_by_class().get(type(obj).__name__)
    if owned:
        for lock_attr in sorted(set(owned.values())):
            assert_held(getattr(obj, lock_attr), label)


def violations() -> list[str]:
    with _VLOCK:
        return list(_VIOLATIONS)


def reset() -> None:
    with _VLOCK:
        _VIOLATIONS.clear()
