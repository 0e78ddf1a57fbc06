"""Process-wide lock-ownership registry: every cross-thread shared
location of the port and the lock that owns it, in one table.

The port's copy of the JAX package's ``robustness/locks.py``, the same
rows. The runtime checks (:mod:`.lockcheck`, ``TCR_LOCKCHECK=1``) read
it: :func:`lockcheck.assert_owner` asserts that the lock this table names
for an object's class is held.

Keys are ``"ClassName.attr"``; values are the lock attribute on the same
object that must be held for every access. Module-level globals that are
only ever rebound (``_ACTIVE = wd``) are absent: rebinding is atomic under
the GIL, and only container mutations need a lock.
"""

from __future__ import annotations

LOCK_OWNERSHIP = {
    # --- serve/queue.py: HTTP handler threads and the daemon loop both
    # mutate these; any mutation outside the lock loses jobs under load
    "JobQueue.pending": "_lock",
    "JobQueue.jobs": "_lock",
    "JobQueue.finished_order": "_lock",
    # --- obs/metrics.py: worker threads + the watchdog monitor both
    # feed this object
    "MetricsRegistry.counters": "_lock",
    "MetricsRegistry.gauges": "_lock",
    "MetricsRegistry.gauges_live": "_lock",
    "MetricsRegistry.serve_rejects": "_lock",
    "MetricsRegistry.mesh_slices": "_lock",
    "MetricsRegistry.mesh_degraded": "_lock",
    "MetricsRegistry.slice_tenants": "_lock",
    "MetricsRegistry.slice_quarantined": "_lock",
    "MetricsRegistry.hists": "_lock",
    "MetricsRegistry.stages": "_lock",
    "MetricsRegistry.dispatch": "_lock",
    "MetricsRegistry.dispatch_stages": "_lock",
    "MetricsRegistry.compiles": "_lock",
    "MetricsRegistry.graph_nodes": "_lock",
    "MetricsRegistry.graph_edges": "_lock",
    "MetricsRegistry.graph_meta": "_lock",
    "MetricsRegistry.pools": "_lock",
    "MetricsRegistry.analysis": "_lock",
    "MetricsRegistry.transfers": "_lock",
    "MetricsRegistry.edge_transfers": "_lock",
    "MetricsRegistry.donations": "_lock",
    "MetricsRegistry.node_hbm": "_lock",
    "MetricsRegistry.static_hbm": "_lock",
    "MetricsRegistry._round_trip": "_lock",
    # --- obs/live.py: the ring is fed from every guarded stage thread
    # plus overlap workers while HTTP handler threads snapshot it; the
    # tracker is fed from the main loop and read by handler threads
    "FlightRecorder.events": "_lock",
    "FlightRecorder.total": "_lock",
    "FlightRecorder.flush_path": "_lock",
    "FlightRecorder.last_flush": "_lock",
    "ProgressTracker.libraries_total": "_lock",
    "ProgressTracker.libraries_done": "_lock",
    "ProgressTracker.library": "_lock",
    "ProgressTracker.plan": "_lock",
    "ProgressTracker.done": "_lock",
    "ProgressTracker.node": "_lock",
    "ProgressTracker.node_units": "_lock",
    "ProgressTracker.node_t0": "_lock",
    "ProgressTracker.node_seconds": "_lock",
    "ProgressTracker.priors": "_lock",
    # --- pipeline/overlap.py: the pool counters are fed by every worker
    # thread's completion callback; an unlocked write loses busy seconds
    "StageExecutor._t_first_submit": "_stats_lock",
    "StageExecutor._t_last_done": "_stats_lock",
    "StageExecutor._busy_s": "_stats_lock",
    "StageExecutor._pool_recorded": "_stats_lock",
    # --- robustness/watchdog.py: mutated by guarded stage threads and
    # raced by the monitor; the hard cancel's safety relies on every
    # write being locked
    "Watchdog._entries": "_lock",
    # --- serve/slices.py: the slice pool is mutated by the dispatcher
    # (assign), runner workers (release/quarantine, the mesh degrade hook
    # on a job thread) and read by HTTP submit threads
    # (admission_budget); an unlocked write double-leases a slice
    "SliceAllocator._state": "_lock",
    "SliceAllocator._leases": "_lock",
}

#: Mutable containers on registered classes that are deliberately NOT
#: lock-owned, with the one-line reason.
LOCK_EXEMPT = {
    "StageExecutor._pending": (
        "main-thread only: submit/commit/wait_all all run on the "
        "library loop thread; workers never touch the pending list"
    ),
    "SliceAllocator.devices": (
        "written once in __init__ before any thread sees the allocator; "
        "read-only (index order IS the slice address space) afterwards; "
        "so is the port's SliceAllocator.labels beside it"
    ),
    "SliceAllocator.labels": (
        "the port's list of the slices' labels, one a device: written once "
        "in __init__ beside SliceAllocator.devices, read-only afterwards"
    ),
}


def ownership_by_class() -> dict[str, dict[str, str]]:
    """``{"Watchdog": {"_entries": "_lock"}, ...}`` for runtime consumers."""
    out: dict[str, dict[str, str]] = {}
    for key, lock in LOCK_OWNERSHIP.items():
        cls, attr = key.split(".", 1)
        out.setdefault(cls, {})[attr] = lock
    return out
