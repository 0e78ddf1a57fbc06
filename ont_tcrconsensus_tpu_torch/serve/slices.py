"""Slice allocator: disjoint power-of-two device slices for packed serving.

A copy of the JAX package's ``serve/slices.py``. With ``serve_workers`` > 1
the daemon runs several tenant jobs at once, each on its own slice of the
device list: the host's cards (``parallel/mesh._host_devices``) or an
explicit list, which may name one card more than once (two slices of
``cuda:0``, or eight CPU slices in the tests, the counterpart of the JAX
tests' eight virtual devices). The devices form a buddy pool of aligned
power-of-two slices; each admitted job leases a disjoint slice sized by
its memory need, and slices return to the pool as jobs finish.

Sizing: a slice of ``n`` of the pool's ``N`` devices gets exactly the
budget fraction :func:`~..parallel.budget.degraded_budget` gives a mesh
that kept ``n`` of ``N`` slices, so per-slice admission
(:func:`~.queue.estimate_admission` against the slice's allowance) can
never admit a job the run's own batch sizing would overcommit. The
queue's budget becomes the largest grantable slice's allowance
(:meth:`SliceAllocator.admission_budget`).

Alignment: a slice of size ``n`` starts only at device index multiples of
``n`` (the buddy invariant), so fragmentation is real and testable and
freeing a lease needs no coalescing pass.

Fault containment:

- ``serve.slice_assign`` fires before any pool mutation, so a chaos raise
  at the carve site never leaks devices;
- ``serve.pack`` fires after a release has returned its devices to the
  pool, so a raise mid-pack leaves the pool consistent;
- :meth:`quarantine` takes a lost slice's devices out of circulation
  (neither free nor busy until a restart) and meters them
  (``tcr_slice_quarantined_total``, busy gauge 0); a neighbour's lease is
  untouched.

Labels are the mesh's (:attr:`~..parallel.mesh.Slice.label`): the device
type and the position in the pool's device list, ``cuda:0``, ``cuda:1``
for two slices of one card, ``cpu:0`` ... ``cpu:7`` for eight CPU slices.

Thread contract: HTTP submit threads read :meth:`admission_budget`; the
dispatcher assigns and waits; runner workers release and quarantine. One
lock guards the pool tables (robustness/locks.py); the condition wakes
the dispatcher on release.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from ont_tcrconsensus_tpu_torch.io import bucketing
from ont_tcrconsensus_tpu_torch.obs import live as obs_live
from ont_tcrconsensus_tpu_torch.obs import metrics as obs_metrics
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod
from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel, degraded_budget
from ont_tcrconsensus_tpu_torch.robustness import faults, lockcheck
from ont_tcrconsensus_tpu_torch.serve import queue as queue_mod

#: device-index states in the allocator pool
FREE, BUSY, QUARANTINED = "free", "busy", "quarantined"


@dataclasses.dataclass
class SliceLease:
    """One tenant job's hold on an aligned device run."""

    job_id: str
    start: int          # first device index (multiple of size)
    size: int           # pow2 device count
    devices: list       # the torch devices, in index order
    labels: list        # their slice labels (mesh.Slice.label)

    @property
    def slice_id(self) -> str:
        return f"{self.start}+{self.size}"


class SliceAllocator:
    """Buddy-style pow2 slice pool over the local device order."""

    def __init__(self, devices, budget: BudgetModel):
        if not devices:
            raise ValueError("slice allocator needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.labels = [mesh_mod.Slice(i, d).label for i, d in enumerate(self.devices)]
        self.n_total = len(self.devices)
        # largest pow2 slice the pool can ever grant (aligned at 0)
        self.max_size = 1
        while self.max_size * 2 <= self.n_total:
            self.max_size *= 2
        self.budget = budget
        self._lock = lockcheck.make_lock()
        self._freed = threading.Condition(self._lock)
        self._state: list[str] = [FREE] * self.n_total
        self._leases: dict[str, SliceLease] = {}

    # The pool tables (_state, _leases) are guarded by _lock (the port's
    # lock table, robustness/locks.py).

    # --- sizing (pure arithmetic; no pool state) ---------------------------

    def allowance(self, size: int) -> BudgetModel:
        """The HBM budget a ``size``-device slice is entitled to: the
        whole-host budget scaled by size/total — byte-for-byte the
        degraded-mesh arithmetic, so slice admission and mid-run
        degradation can never disagree about what fits."""
        return degraded_budget(self.budget, size, self.n_total)

    def size_for(self, cfg) -> tuple[int | None, str]:
        """(slice size, detail) for a validated config; (None, why) when
        no grantable slice can ever admit it.

        An explicit ``mesh_shape`` pins the size: the pow2 ceiling of the
        axis product (the mesh uses the first ``product`` devices of the
        lease). Otherwise the SMALLEST pow2 slice whose allowance admits
        the job wins — small jobs pack many-at-a-time, and a job is never
        handed more of the mesh than its shapes need. ``read_batch_size``
        must stay divisible by the slice's data width, matching
        run.py's mesh-divisibility contract.
        """
        if cfg.mesh_shape:
            need = 1
            for v in cfg.mesh_shape.values():
                need *= int(v)
            size = bucketing.pow2_ceil(max(need, 1))
            if size > self.max_size:
                return None, (
                    f"mesh_shape={dict(cfg.mesh_shape)} needs {need} "
                    f"devices; the largest grantable slice is "
                    f"{self.max_size} of {self.n_total}"
                )
            ok, detail = queue_mod.estimate_admission(
                cfg, self.allowance(size))
            if not ok:
                return None, f"slice of {size}: {detail}"
            return size, f"pinned by mesh_shape ({need} devices)"
        size = 1
        while size <= self.max_size:
            divisible = (cfg.read_batch_size is None
                         or cfg.read_batch_size % size == 0)
            if divisible:
                ok, detail = queue_mod.estimate_admission(
                    cfg, self.allowance(size))
                if ok:
                    return size, f"fits a {size}-device slice"
            size *= 2
        # re-run the max-size estimate for an honest rejection detail
        _, detail = queue_mod.estimate_admission(
            cfg, self.allowance(self.max_size))
        return None, f"largest slice ({self.max_size}): {detail}"

    def admission_budget(self) -> BudgetModel:
        """The submit-side admission budget: the largest grantable
        slice's allowance. Shrinks when quarantines eat the big aligned
        runs — the daemon re-swaps the queue budget after each loss, so
        admission follows the surviving capacity."""
        with self._lock:
            best = self._largest_grantable_locked()
        return self.allowance(max(best, 1))

    def _largest_grantable_locked(self) -> int:
        """Largest pow2 size with an aligned run of non-quarantined
        devices (busy counts: it frees later; quarantined never does)."""
        lockcheck.assert_owner(self, "SliceAllocator._largest_grantable_locked")
        size = self.max_size
        while size >= 1:
            for start in range(0, self.n_total - size + 1, size):
                if all(self._state[i] != QUARANTINED
                       for i in range(start, start + size)):
                    return size
            size //= 2
        return 0

    # --- assign / release / quarantine -------------------------------------

    def try_assign(self, job_id: str, size: int) -> SliceLease | None:
        """Lease the first free aligned ``size``-run to ``job_id``; None
        when none is free RIGHT NOW (the caller keeps the job queued and
        waits — fragmentation or full residency is a wait, never a
        rejection). Raises whatever ``serve.slice_assign`` chaos injects —
        before any pool mutation, so nothing leaks."""
        faults.inject("serve.slice_assign")
        with self._lock:
            for start in range(0, self.n_total - size + 1, size):
                if all(self._state[i] == FREE
                       for i in range(start, start + size)):
                    for i in range(start, start + size):
                        self._state[i] = BUSY
                    lease = SliceLease(
                        job_id, start, size,
                        self.devices[start:start + size],
                        self.labels[start:start + size])
                    self._leases[job_id] = lease
                    break
            else:
                return None
        reg = obs_metrics.global_registry()
        if reg is not None:
            for label in lease.labels:
                reg.mesh_slice_set(label, 1.0)
                reg.slice_tenant_set(label, job_id)
        obs_live.ring_event("serve.slice", {
            "event": "assign", "id": job_id, "slice": lease.slice_id,
            "devices": lease.labels,
        })
        return lease

    def can_ever_fit(self, size: int) -> bool:
        """Whether an aligned ``size``-run of non-quarantined devices
        still exists — False means waiting is hopeless (quarantines ate
        the capacity) and the caller should fail the job loudly rather
        than queue it forever."""
        with self._lock:
            return self._largest_grantable_locked() >= size

    def release(self, job_id: str) -> None:
        """Return ``job_id``'s lease to the free pool and wake waiters.
        The ``serve.pack`` chaos site fires AFTER the devices are free —
        a raise mid-pack must leave the pool consistent, never leak a
        slice. No-op for an unknown/already-released job."""
        with self._lock:
            lease = self._leases.pop(job_id, None)
            if lease is not None:
                for i in range(lease.start, lease.start + lease.size):
                    # quarantined devices stay quarantined through the
                    # owner's release: the loss outlives the job
                    if self._state[i] == BUSY:
                        self._state[i] = FREE
                self._freed.notify_all()
        if lease is None:
            return
        reg = obs_metrics.global_registry()
        if reg is not None:
            for label in lease.labels:
                reg.mesh_slice_set(label, 0.0)
                reg.slice_tenant_set(label, "")
        obs_live.ring_event("serve.slice", {
            "event": "release", "id": job_id, "slice": lease.slice_id,
        })
        faults.inject("serve.pack")

    def quarantine(self, job_id: str, lost_devices=None) -> list[str]:
        """Pull ``job_id``'s lease (or just ``lost_devices`` of it) out
        of circulation: device_lost on tenant A's slice must remove that
        capacity from the pool — NOT return it for tenant C to land on —
        while B's disjoint lease never notices. ``lost_devices`` are the
        job mesh's lost :class:`~..parallel.mesh.Slice` s (the degrade
        hook's argument): the job's mesh is built over exactly the lease's
        devices, so a slice's id is its offset in the lease. Returns the
        quarantined device labels (for the caller's logs/ledger)."""
        lost_ids = (None if lost_devices is None
                    else {s.id for s in lost_devices})
        with self._lock:
            lease = self._leases.get(job_id)
            if lease is None:
                return []
            hit: list[int] = []
            for offset in range(lease.size):
                if lost_ids is None or offset in lost_ids:
                    self._state[lease.start + offset] = QUARANTINED
                    hit.append(offset)
        labels = [lease.labels[o] for o in hit]
        # the degrade hook calls this on the JOB's thread, inside its
        # jobscope — plant via the global registry so the quarantine is
        # visible on the daemon's /metrics, not buried in the tenant's
        # per-run telemetry
        reg = obs_metrics.global_registry()
        if reg is not None:
            for label in labels:
                reg.mesh_slice_set(label, 0.0)
                reg.slice_tenant_set(label, "")
                reg.slice_quarantine_add(label)
        if labels:
            obs_live.ring_event("serve.slice", {
                "event": "quarantine", "id": job_id,
                "slice": lease.slice_id, "devices": labels,
            })
        return labels

    def wait_for_release(self, timeout: float) -> None:
        """Block until some lease is released (or ``timeout`` elapses) —
        the dispatcher's fragmentation wait."""
        with self._lock:
            self._freed.wait(timeout)

    # --- introspection ------------------------------------------------------

    def resident(self) -> int:
        with self._lock:
            return len(self._leases)

    def snapshot(self) -> dict:
        """Pool state for tests/debug endpoints: per-device state plus
        the live leases (job -> slice)."""
        with self._lock:
            return {
                "devices": {
                    label: self._state[i]
                    for i, label in enumerate(self.labels)
                },
                "leases": {
                    job_id: {"slice": lease.slice_id,
                             "devices": lease.labels}
                    for job_id, lease in sorted(self._leases.items())
                },
                "quarantined": sum(
                    1 for s in self._state if s == QUARANTINED),
            }
