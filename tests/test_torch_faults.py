"""The port's fault injection, shutdown coordinator and lock table against
the JAX package's: one chaos plan fires at the same hits in both
registries, the file-level faults write the same bytes, the port arms
every site of the JAX package (the serve sites since the serve slice), the coordinator drains on a signal and
restores every handler, the lock table names the port's own classes, and
the sites planted in the port's sources are exactly the JAX package's
minus the refused ones."""

from __future__ import annotations

import ast
import gzip
import os
import signal
import subprocess
import sys
import threading

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu.robustness import locks as jlocks  # noqa: E402
from ont_tcrconsensus_tpu.robustness import retry as jretry  # noqa: E402
from ont_tcrconsensus_tpu.robustness import shutdown as jshutdown  # noqa: E402
import ont_tcrconsensus_tpu_torch  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import (  # noqa: E402
    faults,
    lockcheck,
    locks,
    retry,
    shutdown,
)

PKG_DIR = os.path.dirname(ont_tcrconsensus_tpu_torch.__file__)
# a kind no registry knows, held in a name (the chaos lint checks literals)
UNKNOWN_KIND = "meteor"
REPO = os.path.dirname(PKG_DIR)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


def test_vocabularies_equal_jax():
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert faults.KINDS == jfaults.KINDS
    assert faults.ENV_VAR == jfaults.ENV_VAR == "TCR_CHAOS"
    assert faults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE == 137


PLANS = [
    [{"site": "polish.dispatch", "kind": "transient", "skip": 2, "times": 2}],
    [{"site": "assign.dispatch", "kind": "oom"},
     {"site": "assign.dispatch", "kind": "error", "skip": 3}],
    [{"site": "graph.node", "kind": "transient", "p": 0.3, "times": 0}],
    [{"site": "overlap.worker", "kind": "transient", "times": 0, "skip": 1}],
]


@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
def test_a_plan_fires_at_the_same_hits_as_jax(plan):
    fired = {}
    for mod in (faults, jfaults):
        p = mod.arm(plan, seed=7)
        seq = []
        for _ in range(12):
            for site in ("polish.dispatch", "assign.dispatch", "graph.node",
                         "overlap.worker"):
                spec = p.hit(site)
                seq.append((site, None if spec is None else spec.kind))
        fired[mod] = (seq, p.describe())
        mod.disarm()
    assert fired[faults] == fired[jfaults]


@pytest.mark.parametrize("kind,exc,cls", [
    ("transient", "TransientChaosError", "transient"),
    ("oom", "OomChaosError", "oom"),
    ("device-lost", "DeviceLostChaosError", "device_lost"),
    ("error", "RuntimeError", "fatal"),
])
def test_raising_kinds_classify_as_in_jax(kind, exc, cls):
    for mod, rmod in ((faults, retry), (jfaults, jretry)):
        mod.arm([{"site": "assign.dispatch", "kind": kind}])
        with pytest.raises(Exception) as info:
            mod.inject("assign.dispatch")
        assert type(info.value).__name__ == exc
        assert rmod.classify(info.value) == cls
        assert mod.fired("assign.dispatch") == 1
        mod.inject("assign.dispatch")  # times=1: spent
        mod.disarm()
        assert mod.fired("assign.dispatch") == 0


def test_unknown_sites_and_kinds_fail_fast_and_unplanted_sites_are_refused():
    for mod in (faults, jfaults):
        with pytest.raises(ValueError, match="unknown chaos site"):
            mod.arm([{"site": "no.such.site"}])
        with pytest.raises(ValueError, match="unknown chaos kind"):
            mod.arm([{"site": "graph.node", "kind": UNKNOWN_KIND}])
        with pytest.raises(ValueError, match="outside"):
            mod.arm([{"site": "graph.node", "p": 2.0}])
    assert faults.UNPLANTED == {}
    for site in sorted(faults.KNOWN_SITES):
        if site.startswith(("serve.", "mesh.")):  # planted by the port's serve and mesh
            jfaults.arm([{"site": site}])
            faults.arm([{"site": site}])
            assert faults.describe()["specs"] == jfaults.describe()["specs"]
            faults.disarm()
            jfaults.disarm()
    assert faults.describe() is None


def test_arm_from_env_and_describe(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    assert faults.arm_from_env() is None
    monkeypatch.setenv(faults.ENV_VAR, '{"seed": 5, "faults": [{"site": "graph.node"}]}')
    for mod in (faults, jfaults):
        mod.arm_from_env()
        mod.inject("polish.dispatch")
    assert faults.describe() == jfaults.describe()
    assert faults.describe()["seed"] == 5


def _fastq(path, n=20):
    recs = b"".join(b"@r%d\nACGTACGTACGTAAAC\n+\nIIIIIIIIIIIIIIII\n" % i for i in range(n))
    with gzip.open(path, "wb") as fh:
        fh.write(recs)


@pytest.mark.parametrize("kind", ["truncate-file", "corrupt-input"])
def test_file_faults_write_the_jax_bytes(tmp_path, kind):
    out = []
    for mod, d in ((faults, tmp_path / "port"), (jfaults, tmp_path / "jax")):
        d.mkdir()
        src = d / "barcode01.fastq.gz"
        _fastq(src)
        mod.arm([{"site": "ingest.library_fastq", "kind": kind}], seed=3)
        got = mod.mutate_input("ingest.library_fastq", str(src))
        assert os.path.basename(got) != src.name and "fastq" not in os.path.basename(got)
        with open(got, "rb") as fh:
            raw = fh.read()
        out.append(gzip.decompress(raw) if kind == "corrupt-input" else raw)
        mod.disarm()
    assert out[0] == out[1]


def test_corrupt_artifact_and_tear_write_equal_jax(tmp_path):
    res = []
    for mod, name in ((faults, "port"), (jfaults, "jax")):
        art = tmp_path / f"{name}.csv"
        art.write_bytes(b"TCR,Count\nTCR0000,3\nTCR0001,2\n")
        mod.arm([{"site": "resume.verify", "kind": "corrupt-artifact"},
                 {"site": "layout.manifest_write", "kind": "torn"}])
        assert mod.corrupt_artifact("resume.verify", str(art))
        torn = tmp_path / f"{name}.json"
        assert mod.tear_write("layout.manifest_write", str(torn), '{"version": 2}')
        res.append((art.read_bytes(), torn.read_bytes()))
        mod.disarm()
    assert res[0] == res[1]
    assert len(res[0][0]) == len(b"TCR,Count\nTCR0000,3\nTCR0001,2\n")


def test_the_report_records_the_plan(tmp_path):
    faults.arm([{"site": "polish.dispatch", "kind": "transient"}])
    rec = retry.RobustnessRecorder()
    rec.write(str(tmp_path / "r.json"))
    import json

    report = json.loads((tmp_path / "r.json").read_text())
    assert report["chaos"]["specs"][0]["site"] == "polish.dispatch"
    assert report["chaos"] == faults.describe()


# -- the shutdown coordinator -------------------------------------------------


def test_coordinator_drains_to_a_checkpoint_and_restores_handlers():
    before = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT,
                                                     signal.SIGUSR1)}
    usr1 = []
    signal.signal(signal.SIGUSR1, lambda *a: usr1.append(1))
    try:
        with shutdown.ShutdownCoordinator() as coord:
            shutdown.checkpoint("run.library_start")  # nothing requested yet
            os.kill(os.getpid(), signal.SIGUSR1)  # another handler still works
            assert usr1 == [1]
            os.kill(os.getpid(), signal.SIGTERM)
            assert coord.requested()
            with pytest.raises(shutdown.Preempted) as info:
                shutdown.checkpoint("run.round1_checkpoint")
            assert info.value.site == "run.round1_checkpoint"
            assert isinstance(info.value, BaseException)
            assert not isinstance(info.value, Exception)  # guards cannot swallow it
        shutdown.checkpoint("after")  # deactivated: a no-op again
        assert signal.getsignal(signal.SIGTERM) == before[signal.SIGTERM]
        assert signal.getsignal(signal.SIGINT) == before[signal.SIGINT]
    finally:
        signal.signal(signal.SIGUSR1, before[signal.SIGUSR1])


def test_coordinator_off_the_main_thread_and_nesting_follow_jax():
    got = {}
    for mod in (shutdown, jshutdown):
        out = []
        coord = mod.ShutdownCoordinator()
        t = threading.Thread(target=lambda: out.append(coord.install()))
        t.start()
        t.join(10)
        assert not t.is_alive()
        outer, inner = mod.ShutdownCoordinator(), mod.ShutdownCoordinator()
        mod.activate(outer)
        mod.activate(inner)
        mod.request("chaos preempt at run.round1_checkpoint")
        mod.deactivate(inner)
        # the request went to the inner coordinator: the outer one is clean
        mod.checkpoint("x")
        mod.deactivate(outer)
        got[mod] = (out, inner.requested(), outer.requested())
    assert got[shutdown] == got[jshutdown] == ([False], True, False)


def test_second_signal_terminates_at_once():
    code = (
        "import os, signal, time\n"
        "from ont_tcrconsensus_tpu_torch.robustness import shutdown\n"
        "with shutdown.ShutdownCoordinator():\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    time.sleep(5)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == -signal.SIGTERM
    assert "second signal" in proc.stderr


# -- the lock table -----------------------------------------------------------


def _instances():
    from ont_tcrconsensus_tpu_torch.obs import live, metrics
    from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel
    from ont_tcrconsensus_tpu_torch.pipeline import overlap
    from ont_tcrconsensus_tpu_torch.robustness import watchdog
    from ont_tcrconsensus_tpu_torch.serve import queue, slices

    return {
        "JobQueue": queue.JobQueue(2, BudgetModel(12.0)),
        "MetricsRegistry": metrics.MetricsRegistry(),
        "FlightRecorder": live.FlightRecorder(),
        "ProgressTracker": live.ProgressTracker(),
        "StageExecutor": overlap.StageExecutor(device=None),
        "Watchdog": watchdog.Watchdog(base_timeout_s=60),
        "SliceAllocator": slices.SliceAllocator(["cpu"] * 2, BudgetModel(12.0)),
    }


def test_lock_table_names_the_ports_classes_and_their_locks():
    objs = _instances()
    table = locks.ownership_by_class()
    assert set(table) == set(objs)
    for cls, attrs in table.items():
        for attr, lock_attr in attrs.items():
            assert hasattr(objs[cls], attr), f"{cls}.{attr}"
            assert hasattr(getattr(objs[cls], lock_attr), "acquire"), f"{cls}.{lock_attr}"
    # the JAX table restricted to the classes the port has
    jtable = {k: v for k, v in jlocks.LOCK_OWNERSHIP.items() if k.split(".")[0] in table}
    assert locks.LOCK_OWNERSHIP == jtable
    # the JAX exemptions, and the port's own SliceAllocator.labels (the JAX
    # allocator has no such list)
    port_only = {"SliceAllocator.labels"}
    assert set(locks.LOCK_EXEMPT) - port_only <= set(jlocks.LOCK_EXEMPT)
    assert port_only <= set(locks.LOCK_EXEMPT)
    for key in port_only:
        cls, attr = key.split(".")
        assert isinstance(getattr(objs[cls], attr), list), key


def test_lockcheck_asserts_the_lock_the_table_names():
    from ont_tcrconsensus_tpu_torch.obs import live

    lockcheck.reset()
    lockcheck.arm()
    try:
        rec = live.FlightRecorder()  # built armed: an RLock it can ask
        lockcheck.assert_owner(rec, "FlightRecorder.events")
        assert len(lockcheck.violations()) == 1
        with rec._lock:
            lockcheck.assert_owner(rec, "FlightRecorder.events")
        assert len(lockcheck.violations()) == 1
        lockcheck.assert_owner(object(), "unlisted")  # not in the table
        assert len(lockcheck.violations()) == 1
    finally:
        lockcheck.disarm()
        lockcheck.reset()


# -- planted sites ------------------------------------------------------------

_PLANT_CALLS = {"inject", "mutate_input", "corrupt_artifact", "tear_write"}


def _planted_sites() -> set[str]:
    sites = set()
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py") or f == "faults.py":
                continue
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _PLANT_CALLS
                        and isinstance(getattr(node.func.value, "id", None), str)
                        and node.func.value.id == "faults" and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    sites.add(node.args[0].value)
    return sites


def test_planted_sites_are_the_known_sites_minus_the_refused():
    refused = {s for s in faults.KNOWN_SITES if s.startswith(tuple(faults.UNPLANTED))}
    assert _planted_sites() == set(faults.KNOWN_SITES) - refused
