"""Per-job thread scope for the process-global robustness state.

A copy of the JAX package's ``robustness/jobscope.py``. Every run arms
process-global state (the retry policy and recorder, the contract
counters), which deep stage code reaches with one module-attribute check.
Where two jobs share a process at once, each enters its own scope: while
a thread's scope is active, each scoped module binds and reads its state
in the thread's store instead of the module global, and threads spawned by
a scoped job adopt the submitter's store (:func:`current`/:func:`adopt`).
Threads outside any scope (every one-shot run) see the module globals.
"""

from __future__ import annotations

import threading

_TLS = threading.local()

#: store keys are owned by the scoped modules; listed here only as the
#: vocabulary of the overlay ("retry_policy", "retry_recorder",
#: "contracts").


def enter() -> None:
    """Enter a job scope on the calling thread (immediately before it runs
    a job)."""
    _TLS.store = {}


def exit() -> None:
    """Leave the scope; the thread sees the module globals again."""
    _TLS.store = None


def active() -> bool:
    return getattr(_TLS, "store", None) is not None


def current() -> dict | None:
    """The calling thread's store (None outside any scope): capture at
    spawn time to hand a child worker via :func:`adopt`."""
    return getattr(_TLS, "store", None)


def adopt(store: dict | None) -> None:
    """Adopt a parent thread's store (child workers of a scoped job).
    ``None`` is a no-op so unscoped submitters stay unscoped."""
    if store is not None:
        _TLS.store = store


def set(key: str, value) -> None:
    """Bind ``key`` in the active scope; silently a no-op when unscoped
    (callers decide between global and scoped via :func:`active`)."""
    store = getattr(_TLS, "store", None)
    if store is not None:
        store[key] = value


def get(key: str, default=None):
    """Scoped value for ``key``; ``default`` when unscoped or unset.

    Scoped modules distinguish "unset" (fall back to the module global)
    from an explicit tombstone (the scope armed then disarmed) by
    storing ``(value,)`` tuples or sentinel defaults as they see fit.
    """
    store = getattr(_TLS, "store", None)
    if store is None:
        return default
    return store.get(key, default)
