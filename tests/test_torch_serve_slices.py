"""The port's slice allocator and packed runner pool against the JAX
package's: the allocator on eight CPU slices against JAX's on its eight
virtual CPU devices (sizing, buddy alignment and fragmentation,
quarantine, admission, the ``serve.slice_assign``/``serve.pack`` chaos
order, the slice metrics), the packed daemon with one stub runner in both
packages (two tenants resident on disjoint slices, a lost slice isolating
one tenant, a pinned whole-pool job waiting for a repack, a drain
journaling every resident), the lock table's serve rows held under
``TCR_LOCKCHECK``, and real packed runs on CPU slices: two tenants
resident at once, each writing the one-shot run's files, and a
``serve.slice_lost`` on tenant A that leaves tenant B's files equal.

Waits for a release go through the allocator's release condition
(:meth:`SliceAllocator.wait_for_release`), never through ``jobs_done``:
a job is counted done before its worker returns the slice."""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.obs import live as jlive  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.parallel import mesh as jmesh  # noqa: E402
from ont_tcrconsensus_tpu.parallel.budget import BudgetModel as JBudget  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import run as jrun  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu.robustness import retry as jretry  # noqa: E402
from ont_tcrconsensus_tpu.robustness import shutdown as jshutdown  # noqa: E402
from ont_tcrconsensus_tpu.serve import daemon as jdaemon  # noqa: E402
from ont_tcrconsensus_tpu.serve import queue as jqueue  # noqa: E402
from ont_tcrconsensus_tpu.serve import slices as jslices  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import fastx as tfastx  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import live as tlive  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel as TBudget  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig as TConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import lockcheck, locks  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import retry as tretry  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import shutdown as tshutdown  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import daemon as tdaemon  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import queue as tqueue  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import slices as tslices  # noqa: E402
from test_torch_e2e import NOT_BYTE_COMPARED, _one_torch_thread, _tree  # noqa: E402,F401

_BASE = {"reference_file": "r.fa", "fastq_pass_dir": "fq"}
N_SLICES = 8


class _Side:
    """One package's serve modules, and how to build its allocator and
    daemon over eight slices."""

    def __init__(self, name, slices, queue, daemon, Cfg, Budget, faults, metrics, live,
                 mesh, run, shutdown, retry):
        self.name, self.slices, self.queue, self.daemon = name, slices, queue, daemon
        self.Cfg, self.Budget, self.faults, self.metrics = Cfg, Budget, faults, metrics
        self.live, self.mesh, self.run, self.shutdown = live, mesh, run, shutdown
        self.retry = retry

    def devices(self):
        return ["cpu"] * N_SLICES if self.name == "port" else jax.devices()[:N_SLICES]

    def alloc(self, hbm_gb: float = 12.0):
        return self.slices.SliceAllocator(self.devices(), self.Budget(hbm_gb))

    def make_daemon(self, template, state_dir, **kw):
        if self.name == "port":
            kw.update(device="cpu", devices=self.devices())
        return self.daemon.Daemon(template, port=0, state_dir=state_dir, **kw)

    def lost(self, lease, offsets):
        """The lease's lost devices as each package's degrade hook passes
        them: JAX devices, or the port's mesh slices (ids = offsets)."""
        if self.name == "port":
            return [tmesh.Slice(o, lease.devices[o]) for o in offsets]
        return [lease.devices[o] for o in offsets]


PORT = _Side("port", tslices, tqueue, tdaemon, TConfig, TBudget, tfaults, tmetrics, tlive,
             tmesh, trun, tshutdown, tretry)
JAX = _Side("jax", jslices, jqueue, jdaemon, JConfig, JBudget, jfaults, jmetrics, jlive,
            jmesh, jrun, jshutdown, jretry)
SIDES = (PORT, JAX)


def test_eight_slices_on_both_sides():
    assert len(jax.devices()) >= N_SLICES
    assert PORT.alloc().labels == [f"cpu:{i}" for i in range(N_SLICES)]
    assert list(PORT.alloc().snapshot()["devices"]) == list(JAX.alloc().snapshot()["devices"])


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_allowance_is_the_degraded_budget_as_in_jax(size):
    for gb in (12.0, 16.0, 80.0):
        got = [side.alloc(gb).allowance(size).hbm_gb for side in SIDES]
        assert got[0] == got[1] == pytest.approx(gb * size / N_SLICES)


def _size_cases(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        knobs = {"max_read_length": int(rng.choice([700, 2048, 4096]))}
        r = rng.random()
        if r < 0.3:
            knobs["mesh_shape"] = {"data": int(rng.choice([1, 2, 3, 4, 8, 16]))}
        if rng.random() < 0.7:
            knobs["read_batch_size"] = int(rng.choice([96, 128, 1000, 1 << 14, 1 << 18, 1 << 21]))
        cases.append(knobs)
    return cases


@pytest.mark.parametrize("hbm_gb", [0.5, 12.0, 80.0])
def test_size_for_equals_jax(hbm_gb):
    allocs = [side.alloc(hbm_gb) for side in SIDES]
    for knobs in _size_cases(int(hbm_gb * 10), 30):
        got = [a.size_for(side.Cfg.from_dict({**_BASE, **knobs}))
               for a, side in zip(allocs, SIDES)]
        assert got[0] == got[1], knobs


def _lease_view(lease):
    return None if lease is None else (lease.job_id, lease.start, lease.size, lease.labels)


def _sequence(side: _Side, seed: int) -> list:
    """A seeded run of assigns, releases and quarantines (whole leases and
    single lost devices) on one allocator; every result and the pool
    after each step."""
    rng = np.random.default_rng(seed)
    alloc = side.alloc()
    live_jobs, out = [], []
    for step in range(60):
        op = rng.random()
        if op < 0.5 or not live_jobs:
            job = f"job-{step:02d}"
            lease = alloc.try_assign(job, int(rng.choice([1, 1, 2, 4, 8])))
            if lease is not None:
                live_jobs.append((job, lease))
            out.append(("assign", _lease_view(lease)))
        elif op < 0.85:
            job, _ = live_jobs.pop(int(rng.integers(len(live_jobs))))
            alloc.release(job)
            out.append(("release", job))
        else:
            job, lease = live_jobs[int(rng.integers(len(live_jobs)))]
            lost = (None if rng.random() < 0.5 else
                    side.lost(lease, [int(rng.integers(lease.size))]))
            out.append(("quarantine", alloc.quarantine(job, lost_devices=lost)))
        out.append((alloc.snapshot(), alloc.resident(),
                    [alloc.can_ever_fit(s) for s in (1, 2, 4, 8)],
                    alloc.admission_budget().hbm_gb))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_assign_release_quarantine_sequences_equal_jax(seed):
    assert _sequence(PORT, seed) == _sequence(JAX, seed)


def test_alignment_makes_fragmentation_real_as_in_jax():
    got = []
    for side in SIDES:
        alloc = side.slices.SliceAllocator(side.devices()[:4], side.Budget(12.0))
        steps = [_lease_view(alloc.try_assign(j, 1)) for j in "abcd"]
        steps.append(_lease_view(alloc.try_assign("e", 1)))  # full residency
        alloc.release("b")
        alloc.release("c")
        # two free devices, but neither aligned pair is free: a wait
        steps += [_lease_view(alloc.try_assign("e", 2)), alloc.can_ever_fit(2)]
        alloc.release("d")
        steps.append(_lease_view(alloc.try_assign("e", 2)))
        got.append(steps)
    assert got[0] == got[1]
    assert got[0][-1][1:3] == (2, 2)


def test_chaos_order_assign_before_mutation_pack_after_release_as_in_jax():
    got = []
    for side in SIDES:
        alloc = side.alloc()
        seen = []
        side.faults.arm([{"site": "serve.slice_assign", "kind": "error"},
                         {"site": "serve.pack", "kind": "transient"}], seed=0)
        try:
            with pytest.raises(RuntimeError) as info:
                alloc.try_assign("a", 2)
            seen.append((type(info.value).__name__, str(info.value), alloc.snapshot()))
            seen.append(_lease_view(alloc.try_assign("a", 2)))
            with pytest.raises(RuntimeError) as info:
                alloc.release("a")
            seen.append((type(info.value).__name__, str(info.value), alloc.snapshot()))
            seen.append(_lease_view(alloc.try_assign("b", 8)))
            seen.append(side.faults.describe())
        finally:
            side.faults.disarm()
        got.append(seen)
    assert got[0] == got[1]
    assert got[0][2][2]["leases"] == {} and got[0][3] is not None


def test_slice_metrics_equal_jax():
    lines = []
    for side in SIDES:
        reg = side.metrics.arm()
        try:
            alloc = side.alloc()
            alloc.try_assign("tenant-a", 4)
            alloc.try_assign("tenant-b", 2)
            alloc.quarantine("tenant-a")
            alloc.release("tenant-a")
            lease = alloc.try_assign("tenant-c", 1)
            alloc.quarantine("tenant-c", lost_devices=side.lost(lease, [0]))
            lines.append(sorted(ln for ln in reg.prometheus_lines()
                                if "slice" in ln or "serve" in ln))
        finally:
            side.metrics.disarm()
    assert lines[0] == lines[1]
    assert 'tcr_slice_quarantined_total{slice="cpu:0"} 1' in lines[0]


def test_wait_for_release_wakes_on_a_release():
    alloc = PORT.alloc()
    alloc.try_assign("a", 8)
    woke = []

    def waiter():
        t0 = time.monotonic()
        alloc.wait_for_release(10.0)
        woke.append(time.monotonic() - t0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    alloc.release("a")
    t.join(5.0)
    assert woke and woke[0] < 5.0 and alloc.resident() == 0


# ---------------------------------------------------------------------------
# the packed daemon with one stub runner in both packages


class _StubRunner:
    """Replaces both packages' ``run_with_config``: records the slice it
    ran on (the device count of the job's installed slices), optionally
    raises per tenant, then parks on a gate polling its package's shutdown
    checkpoint, so a drain preempts it as it would a real run."""

    def __init__(self, side: _Side):
        self.side = side
        self.gate = threading.Event()
        self.lock = threading.Lock()
        self.calls: list[tuple[str, int]] = []
        self.raises: dict[str, list[BaseException]] = {}

    def tag_calls(self, tag: str) -> list[int]:
        with self.lock:
            return [n for t, n in self.calls if t == tag]

    def __call__(self, cfg, device=None):
        tag = os.path.basename(cfg.fastq_pass_dir)
        with self.lock:
            self.calls.append((tag, len(self.side.mesh.slice_devices() or ())))
            planned = self.raises.get(tag)
            exc = planned.pop(0) if planned else None
        if exc is not None:
            raise exc
        while not self.gate.wait(0.02):
            self.side.shutdown.checkpoint("stub.run")
        return {"barcode01": {"r1": 1}}


def _wait(predicate, timeout: float = 30.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _wait_resident(alloc, n: int, timeout: float = 30.0) -> None:
    """Until exactly ``n`` leases are held, woken by the allocator's
    release condition (a dispatch needs the short timeout)."""
    deadline = time.monotonic() + timeout
    while alloc.resident() != n:
        if time.monotonic() > deadline:
            raise AssertionError(f"{alloc.resident()} residents, want {n}")
        alloc.wait_for_release(0.05)


class _Packed:
    """A two-worker packed daemon of one package, its runner stubbed."""

    def __init__(self, side: _Side, tmp_path, monkeypatch, **kw):
        self.side = side
        self.tmp = tmp_path / side.name
        self.runner = _StubRunner(side)
        monkeypatch.setattr(side.run, "run_with_config", self.runner)
        self.daemon = side.make_daemon({**_BASE, "compile_cache_dir": "off"},
                                       str(self.tmp / "state"), do_prewarm=False,
                                       **{"workers": 2, **kw})
        self.codes: list[int] = []
        self.loop = threading.Thread(target=lambda: self.codes.append(
            self.daemon.serve_forever()), name=f"serve-packed-{side.name}", daemon=True)

    def __enter__(self):
        self.loop.start()
        _wait(lambda: self.side.live.server() is not None, 60.0, "live plane")
        return self

    def __exit__(self, *exc):
        self.runner.gate.set()
        self.daemon.request_stop()
        self.loop.join(60.0)
        assert not self.loop.is_alive(), "packed daemon did not stop"

    def submit(self, tag: str, **over) -> str:
        status, snap = self.daemon.submit({"fastq_pass_dir": str(self.tmp / tag), **over})
        assert status == 202, snap
        return snap["id"]


def _jobs_view(daemon) -> dict:
    snap = daemon.jobs_snapshot()
    return {"states": {j["id"]: j["state"] for j in snap["jobs"]},
            "results": {j["id"]: j["result"] for j in snap["jobs"]},
            "jobs_done": snap["jobs_done"], "queue_depth": snap["queue_depth"],
            "resident_jobs": snap["resident_jobs"], "slices": snap["slices"]}


def _two_tenants(side, tmp_path, monkeypatch):
    with _Packed(side, tmp_path, monkeypatch) as p:
        a, b = p.submit("fqA"), p.submit("fqB")
        _wait_resident(p.daemon.allocator, 2)
        _wait(lambda: p.runner.tag_calls("fqA") and p.runner.tag_calls("fqB"),
              what="both stubs started")
        during = _jobs_view(p.daemon)
        text = "\n".join(side.metrics.registry().prometheus_lines())
        busy = sorted(ln for ln in text.splitlines() if "tcr_mesh_slice_busy" in ln)
        p.runner.gate.set()
        _wait_resident(p.daemon.allocator, 0)
        _wait(lambda: p.daemon.jobs_snapshot()["jobs_done"] == 2, what="both done")
        after = _jobs_view(p.daemon)
        calls = (p.runner.tag_calls("fqA"), p.runner.tag_calls("fqB"))
    return (a, b), during, busy, after, calls


def test_slice_pack_two_tenants_resident_on_disjoint_slices_as_in_jax(tmp_path, monkeypatch):
    got = [_two_tenants(side, tmp_path, monkeypatch) for side in SIDES]
    assert got[0] == got[1]
    (a, b), during, busy, after, calls = got[0]
    leases = during["slices"]["leases"]
    assert during["resident_jobs"] == 2 and set(leases) == {a, b}
    assert not set(leases[a]["devices"]) & set(leases[b]["devices"])
    assert calls == ([1], [1])  # each run's mesh came up over its one slice
    assert f'tcr_mesh_slice_busy{{slice="cpu:0",tenant="{a}"}} 1' in busy
    assert after["slices"]["leases"] == {} and after["resident_jobs"] == 0
    assert set(after["states"].values()) == {"done"}


def _device_lost(side, tmp_path, monkeypatch):
    with _Packed(side, tmp_path, monkeypatch) as p:
        p.runner.raises["fqA"] = [side.faults.DeviceLostChaosError("DEVICE_LOST: slice drill")]
        b = p.submit("fqB")
        _wait_resident(p.daemon.allocator, 1)
        a = p.submit("fqA")
        _wait(lambda: p.daemon.allocator.snapshot()["quarantined"] >= 1, what="quarantine")
        _wait(lambda: len(p.runner.tag_calls("fqA")) >= 2, what="A's retry")
        p.runner.gate.set()
        _wait_resident(p.daemon.allocator, 0)
        _wait(lambda: p.daemon.jobs_snapshot()["jobs_done"] == 2, what="both done")
        job_a = p.daemon.queue.job(a)
        out = (a, b, _jobs_view(p.daemon), job_a.raw["resume"], job_a.attempts,
               p.runner.tag_calls("fqB"),
               p.daemon.queue.budget.hbm_gb < p.daemon.budget.hbm_gb,
               [(e["site"], e["classification"], e["outcome"], e["detail"])
                for e in side.retry.recorder().events
                if e["site"] == "serve.slice_lost"][-1:])
    return out


def test_slice_pack_device_lost_isolates_one_tenant_as_in_jax(tmp_path, monkeypatch):
    got = [_device_lost(side, tmp_path, monkeypatch) for side in SIDES]
    assert got[0] == got[1]
    a, b, view, resume, attempts, b_calls, shrank, events = got[0]
    assert view["states"] == {a: "done", b: "done"} and view["slices"]["quarantined"] == 1
    assert resume is True and attempts == 1 and b_calls == [1] and shrank
    assert events == [("serve.slice_lost", "device_lost", "slice_quarantined",
                       {"devices": ["cpu:1"]})]


def _pinned(side, tmp_path, monkeypatch):
    with _Packed(side, tmp_path, monkeypatch) as p:
        small = p.submit("fqSmall")
        _wait_resident(p.daemon.allocator, 1)
        big = p.submit("fqBig", mesh_shape={"data": 8})
        time.sleep(0.6)
        views = _jobs_view(p.daemon)["states"]
        # the dispatcher pops the big job, finds no aligned 8-run free and
        # puts it back at the head: queued or requeued, never refused
        waiting = (views[small], views[big] in ("queued", "requeued", "running"))
        p.runner.gate.set()
        _wait(lambda: p.daemon.jobs_snapshot()["jobs_done"] == 2, what="repack")
        _wait_resident(p.daemon.allocator, 0)
        return waiting, _jobs_view(p.daemon)["states"], p.runner.tag_calls("fqBig")


def test_slice_pack_pinned_whole_pool_job_queues_until_repack_as_in_jax(tmp_path,
                                                                        monkeypatch):
    got = [_pinned(side, tmp_path, monkeypatch) for side in SIDES]
    assert got[0] == got[1]
    waiting, final, big_calls = got[0]
    assert waiting == ("running", True)
    assert set(final.values()) == {"done"} and big_calls == [8]


def _drain(side, tmp_path, monkeypatch):
    with _Packed(side, tmp_path, monkeypatch) as p:
        ids = [p.submit("fqA"), p.submit("fqB"), p.submit("fqQueued")]
        _wait_resident(p.daemon.allocator, 2)
        _wait(lambda: p.runner.tag_calls("fqA") and p.runner.tag_calls("fqB"),
              what="both runs started")
        # the SIGTERM path without the signal: both residents preempt at
        # their next checkpoint and every job journals
        p.daemon._coord.request("drill")
        _wait(lambda: bool(p.codes), 60.0, "daemon drain")
        with open(side.queue.journal_path(p.daemon.state_dir)) as fh:
            journal = json.load(fh)
        codes = list(p.codes)
    return ids, codes, [(j["id"], j["state"], j["raw"].get("resume")) for j in journal["jobs"]]


def test_slice_pack_drain_journals_every_resident_as_in_jax(tmp_path, monkeypatch):
    got = [_drain(side, tmp_path, monkeypatch) for side in SIDES]
    ids, codes, journal = got[0]
    assert codes == [143]
    by_id = {j: (state, resume) for j, state, resume in journal}
    assert by_id == {ids[0]: ("requeued", True), ids[1]: ("requeued", True),
                     ids[2]: ("queued", None)}
    assert sorted(got[1][2]) == sorted(journal) and got[1][1] == codes


def test_packed_daemon_under_concurrent_submissions_loses_no_job(tmp_path, monkeypatch):
    """Eight submitter threads against four packed workers over eight
    slices, with a shortened thread switch interval: every accepted job
    runs once and ends done, and no two residents ever share a device."""
    import sys

    overlaps, seen = [], []
    lock = threading.Lock()
    p = _Packed(PORT, tmp_path, monkeypatch, workers=4, queue_max=64)
    p.runner.gate.set()
    inner = p.runner.__call__

    def checking_runner(cfg, device=None):
        leases = p.daemon.allocator.snapshot()["leases"].values()
        devs = [d for lease in leases for d in lease["devices"]]
        with lock:
            seen.append(os.path.basename(cfg.fastq_pass_dir))
            if len(devs) != len(set(devs)):
                overlaps.append(devs)
        return inner(cfg, device)

    monkeypatch.setattr(PORT.run, "run_with_config", checking_runner)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with p:
            ids: list[str] = []

            def submitter(t):
                for i in range(4):
                    ids.append(p.submit(f"fq{t}_{i}"))

            threads = [threading.Thread(target=submitter, args=(t,)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
                assert not t.is_alive()
            _wait(lambda: p.daemon.jobs_snapshot()["jobs_done"] == 32, 60.0, "32 jobs")
            _wait_resident(p.daemon.allocator, 0)
            states = {j["id"]: j["state"] for j in p.daemon.jobs_snapshot()["jobs"]}
    finally:
        sys.setswitchinterval(interval)
    assert len(set(ids)) == 32 and set(states) == set(ids)
    assert set(states.values()) == {"done"}
    assert sorted(seen) == sorted(f"fq{t}_{i}" for t in range(8) for i in range(4))
    assert overlaps == []


# ---------------------------------------------------------------------------
# the lock table's serve rows, held under TCR_LOCKCHECK


class _Checked:
    """Mixin for a lock-owned container: every access asserts that its
    owner's lock is held (``lockcheck.assert_owner``) and is counted."""

    _owner = None
    _label = ""
    hits = 0

    def _check(self):
        type(self).hits += 1
        lockcheck.assert_owner(self._owner, self._label)


def _checked(container, owner, label):
    base = type(container)
    names = ("__getitem__", "__setitem__", "__iter__", "__len__", "__contains__",
             "append", "insert", "pop", "get", "items", "values", "keys", "clear")

    def wrap(name):
        fn = getattr(base, name)

        def method(self, *a, **kw):
            self._check()
            return fn(self, *a, **kw)
        return method

    cls = type(f"Checked_{label}", (_Checked, base),
               {n: wrap(n) for n in names if hasattr(base, n)})
    cls._owner, cls._label = owner, label
    return cls(container)


def test_lockcheck_packed_run_holds_every_serve_lock_row(tmp_path, monkeypatch):
    monkeypatch.setenv(lockcheck.ENV_VAR, "1")
    lockcheck.reset()
    rows = {k: v for k, v in locks.LOCK_OWNERSHIP.items()
            if k.split(".")[0] in ("JobQueue", "SliceAllocator")}
    assert sorted(rows) == ["JobQueue.finished_order", "JobQueue.jobs", "JobQueue.pending",
                            "SliceAllocator._leases", "SliceAllocator._state"]
    try:
        p = _Packed(PORT, tmp_path, monkeypatch)
        owners = {"JobQueue": p.daemon.queue, "SliceAllocator": p.daemon.allocator}
        for key in rows:
            cls, attr = key.split(".")
            owner = owners[cls]
            assert hasattr(getattr(owner, rows[key]), "_is_owned"), "built before arming"
            setattr(owner, attr, _checked(getattr(owner, attr), owner, key))
        with p:
            ids = [p.submit("fqA"), p.submit("fqB"), p.submit("fqC")]
            _wait_resident(p.daemon.allocator, 2)
            p.daemon.jobs_snapshot()
            p.runner.gate.set()
            _wait(lambda: p.daemon.jobs_snapshot()["jobs_done"] == 3, what="three jobs")
            _wait_resident(p.daemon.allocator, 0)
        hits = {key: type(getattr(owners[key.split(".")[0]], key.split(".")[1])).hits
                for key in rows}
        assert all(hits.values()), hits
        assert lockcheck.violations() == []
        assert {j["id"] for j in p.daemon.jobs_snapshot()["jobs"]} == set(ids)
    finally:
        lockcheck.disarm()
        lockcheck.reset()


# ---------------------------------------------------------------------------
# real packed runs on CPU slices


@pytest.fixture(scope="module")
def packed_lane(tmp_path_factory):
    """The JAX packed tests' lane (seed 31, 2 regions), and the port's
    one-shot run of it."""
    tmp = tmp_path_factory.mktemp("torch_packed_lane")
    lib = jsim.simulate_library(seed=31, num_regions=2, molecules_per_region=(2, 3),
                                reads_per_molecule=(5, 7), sub_rate=0.006, ins_rate=0.003,
                                del_rate=0.003, region_len=(700, 850))
    src = tmp / "src"
    (src / "fastq_pass" / "barcode01").mkdir(parents=True)
    tfastx.write_fasta(src / "reference.fa", lib.reference.items())
    tfastx.write_fastq(src / "fastq_pass" / "barcode01" / "barcode01.fastq.gz", lib.reads)
    oneshot = _stage(src, tmp / "oneshot")
    got = trun.run_with_config(TConfig.from_dict(_raw(oneshot)), device="cpu")
    assert got == {"barcode01": lib.true_counts}
    return src, lib, _tree(oneshot), tmp


def _stage(src, root):
    root.mkdir(parents=True)
    shutil.copy(src / "reference.fa", root / "reference.fa")
    shutil.copytree(src / "fastq_pass", root / "fastq_pass")
    return root


def _raw(root, **over) -> dict:
    return {"reference_file": str(root / "reference.fa"),
            "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 600,
            "min_reads_per_cluster": 4, "read_batch_size": 96, "polish_method": "poa",
            "delete_tmp_files": False, "retry_base_delay_s": 0.0, **over}


def _deterministic(tree: dict) -> dict:
    return {rel: b for rel, b in tree.items() if rel not in NOT_BYTE_COMPARED}


def _run_packed(daemon, raws, before_next=None, timeout=600.0):
    """Drive a packed port daemon through ``raws`` (``before_next(i)`` runs
    before submission i > 0); returns the listing, the residency
    high-water (sampled at every release wake and dispatch tick) and the
    slice pool."""
    codes: list[int] = []
    loop = threading.Thread(target=lambda: codes.append(daemon.serve_forever()),
                            name="serve-packed-e2e", daemon=True)
    loop.start()
    high = [0]
    try:
        _wait(lambda: tlive.server() is not None, 60.0, "live plane")
        for i, raw in enumerate(raws):
            if i and before_next is not None:
                before_next(i)
            status, snap = daemon.submit(raw)
            assert status == 202, snap
        deadline = time.monotonic() + timeout
        while daemon.jobs_snapshot()["jobs_done"] < len(raws) or daemon.allocator.resident():
            assert time.monotonic() < deadline, daemon.jobs_snapshot()
            high[0] = max(high[0], daemon.allocator.resident())
            daemon.allocator.wait_for_release(0.05)
        listing = daemon.jobs_snapshot()
        metrics_text = "\n".join(tmetrics.registry().prometheus_lines())
        pool = daemon.allocator.snapshot()
    finally:
        daemon.request_stop()
        loop.join(120.0)
    assert not loop.is_alive() and codes == [0]
    return listing, high[0], pool, metrics_text


def test_packed_e2e_two_tenants_resident_at_once_write_the_one_shot_files(packed_lane):
    src, lib, oneshot, tmp = packed_lane
    w1, w2 = _stage(src, tmp / "p1"), _stage(src, tmp / "p2")
    daemon = PORT.make_daemon(_raw(w1), str(tmp / "state_p"), do_prewarm=False, workers=2)
    listing, high, pool, metrics_text = _run_packed(daemon, [_raw(w1), _raw(w2)])
    assert {j["state"] for j in listing["jobs"]} == {"done"}
    assert high == 2, "the tenants never overlapped"
    assert pool["leases"] == {} and pool["quarantined"] == 0
    assert "tcr_serve_resident_jobs" in metrics_text
    total = sum(lib.true_counts.values())
    for j in listing["jobs"]:
        assert j["result"] == {"libraries": {"barcode01": total}}
    want = _deterministic(oneshot)
    for w in (w1, w2):
        assert _deterministic(_tree(w)) == want


def test_packed_e2e_slice_lost_on_tenant_a_leaves_tenant_b_equal(packed_lane):
    src, lib, oneshot, tmp = packed_lane
    wa, wb = _stage(src, tmp / "qa"), _stage(src, tmp / "qb")
    daemon = PORT.make_daemon(_raw(wb), str(tmp / "state_q"), do_prewarm=False, workers=2)
    seen = {}

    def lose_a_slice(i):
        # B is resident and running; the daemon-scope plan fires at the
        # next job's serve.slice_lost site: tenant A's
        _wait(lambda: daemon.allocator.resident() == 1 and any(
            j.get("first_stage_s") is not None for j in daemon.jobs_snapshot()["jobs"]),
            120.0, "tenant B running")
        tfaults.arm([{"site": "serve.slice_lost", "kind": "device-lost"}])
        seen["b_lease"] = dict(daemon.allocator.snapshot()["leases"])

    listing, high, pool, metrics_text = _run_packed(daemon, [_raw(wb), _raw(wa)],
                                                    before_next=lose_a_slice)
    states = {j["id"]: j["state"] for j in listing["jobs"]}
    assert set(states.values()) == {"done"} and len(states) == 2
    assert high == 2 and pool["quarantined"] == 1
    assert "tcr_slice_quarantined_total" in metrics_text
    b_id = next(iter(seen["b_lease"]))
    quarantined = [d for d, s in pool["devices"].items() if s == "quarantined"]
    assert quarantined and quarantined[0] not in seen["b_lease"][b_id]["devices"]
    # B ran undisturbed: every deterministic file and an empty report
    assert _deterministic(_tree(wb)) == _deterministic(oneshot)
    report_b = json.loads((wb / "fastq_pass" / "nano_tcr" / "robustness_report.json").read_text())
    assert report_b["events"] == []
    # A was requeued with resume and completed on a fresh slice
    tree_a = _tree(wa)
    for rel in ("barcode01/counts/umi_consensus_counts.csv",
                "barcode01/fasta/merged_consensus.fasta"):
        assert tree_a[rel] == oneshot[rel]
