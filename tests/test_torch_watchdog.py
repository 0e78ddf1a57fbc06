"""The port's stage watchdog (``robustness/watchdog.py``) against the JAX
package's: the deadline scaling, the soft stall event with its stack dump,
the hard cancel of a stalled Python thread followed by a transient retry,
the disarm on an early return, and ``stage_timeout_s`` on a CPU lane: a
generous deadline changes no artifact, and a stalled round-2 clustering
pass is reported, dumped to ``<lib>/logs/watchdog.log``, cancelled and
retried to the same counts."""

from __future__ import annotations

import contextlib
import threading
import time

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.robustness import retry as jretry  # noqa: E402
from ont_tcrconsensus_tpu.robustness import watchdog as jwatchdog  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import retry as tretry  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import watchdog as twatchdog  # noqa: E402

#: safety cap on the tests' own stalls, reached only if no cancel comes
_WEDGE_CAP_S = 30.0
PACKAGES = [(twatchdog, tretry), (jwatchdog, jretry)]


@pytest.fixture(autouse=True)
def _clean_state():
    for _, ret in PACKAGES:
        ret.recorder().reset()
    yield
    for wd, ret in PACKAGES:
        wd.deactivate()
        ret.recorder().reset()


def _events(ret, site: str | None = None) -> list[dict]:
    return [e for e in ret.recorder().events if site is None or e["site"] == site]


def _no_clocks(events: list[dict]) -> list[tuple]:
    return [(e["site"], e["attempt"], e["classification"], e["outcome"],
             (e.get("detail") or {}).get("stage")) for e in events]


@pytest.mark.parametrize("base", [0.5, 5.0, 60.0])
@pytest.mark.parametrize("units", [0, 1, 999, 1000, 1001, 5000, 10**7])
def test_scaled_timeout_equals_jax(base, units):
    assert twatchdog.scaled_timeout(base, units) == jwatchdog.scaled_timeout(base, units)
    assert twatchdog.scaled_timeout(base, units, units_per_base=4) == (
        jwatchdog.scaled_timeout(base, units, units_per_base=4))
    assert (twatchdog.SOFT_FRACTION, twatchdog.UNITS_PER_BASE) == (
        jwatchdog.SOFT_FRACTION, jwatchdog.UNITS_PER_BASE)


def test_stage_timeout_is_transient_in_both_packages():
    for wd, ret in PACKAGES:
        exc = wd.StageTimeout()
        assert "DEADLINE_EXCEEDED" in str(exc)
        assert ret.classify(exc) == "transient"


def test_soft_deadline_writes_its_event_and_a_stack_dump(tmp_path):
    per_package = []
    for wd_mod, ret in PACKAGES:
        log = tmp_path / f"{wd_mod.__name__}.log"
        wd = wd_mod.activate(wd_mod.Watchdog(base_timeout_s=10.0, soft_fraction=0.02,
                                             tick_s=0.02, log_path=str(log)))
        wd.start()
        try:
            with wd_mod.guard("round1_polish"):
                wd_mod.heartbeat("polish.chunk")
                time.sleep(0.4)  # the soft deadline (0.2 s) passes, the hard one not
        finally:
            wd.stop()
        (ev,) = _events(ret, "watchdog.stall")  # once per stall, not per tick
        assert ev["detail"]["last_heartbeat_site"] == "polish.chunk"
        assert ev["detail"]["stalled_s"] >= ev["detail"]["soft_deadline_s"]
        dump = log.read_text()
        assert "dumping all thread stacks" in dump and "test_torch_watchdog" in dump
        per_package.append(_no_clocks(_events(ret)))
    assert per_package[0] == per_package[1] == [
        ("watchdog.stall", 1, "stall", "stall_detected", "round1_polish")]


def _stall_then_succeed(wd_mod, ret) -> tuple[object, list[tuple]]:
    """A Python-level stall the hard deadline cancels, under the transient
    retry: the second attempt returns."""
    attempts = []

    def work():
        attempts.append(time.monotonic())
        if len(attempts) == 1:
            deadline = time.monotonic() + _WEDGE_CAP_S
            while time.monotonic() < deadline:  # interruptible between bytecodes
                time.sleep(0.01)
            raise AssertionError("the watchdog never cancelled the stall")
        return "done"

    # a soft deadline of 0.5 s leaves the retry ample time to return
    # before a second stall report could fire
    wd = wd_mod.activate(wd_mod.Watchdog(base_timeout_s=1.0, tick_s=0.02))
    wd.start()
    try:
        with wd_mod.guard("round2_umi_cluster"):
            out = ret.call_with_retry("cluster.batched_round2", work,
                                      sleep=lambda s: None)
    finally:
        wd.stop()
    assert len(attempts) == 2
    return out, _no_clocks(_events(ret))


def test_hard_cancel_of_a_stalled_thread_then_a_transient_retry():
    got = _stall_then_succeed(twatchdog, tretry)
    want = _stall_then_succeed(jwatchdog, jretry)
    assert got == want
    out, events = got
    assert out == "done"
    assert ("watchdog.stall", 1, "stall", "hard_cancel", "round2_umi_cluster") in events
    assert events[-2:] == [("cluster.batched_round2", 1, "transient", "retried", None),
                           ("cluster.batched_round2", 2, "transient", "recovered", None)]


def test_a_worker_thread_guard_is_its_own(tmp_path):
    """The overlapped QC worker's scope is per thread: a stalled worker is
    cancelled while the main thread's stage keeps its deadline."""
    from ont_tcrconsensus_tpu_torch.pipeline import overlap

    wd = twatchdog.activate(twatchdog.Watchdog(base_timeout_s=0.3, tick_s=0.02))
    wd.start()
    try:
        ex = overlap.StageExecutor()

        def stalled():
            deadline = time.monotonic() + _WEDGE_CAP_S
            while time.monotonic() < deadline:
                time.sleep(0.01)

        stage = ex.submit("round1_error_profile", stalled)
        with pytest.raises(twatchdog.StageTimeout):
            ex.commit(stage)
    finally:
        wd.stop()
    (ev,) = [e for e in _events(tretry, "watchdog.stall") if e["outcome"] == "hard_cancel"]
    assert ev["detail"]["stage"] == "overlap.round1_error_profile"
    assert ev["detail"]["thread"] == "stage-round1_error_profile"


def _lane(root, lib, **knobs):
    from ont_tcrconsensus_tpu_torch.io import fastx
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

    (root / "fastq_pass" / "barcode01").mkdir(parents=True)
    fastx.write_fasta(str(root / "reference.fa"), lib.reference.items())
    fastx.write_fastq(str(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz"), lib.reads)
    return RunConfig.from_dict({
        "reference_file": str(root / "reference.fa"), "fastq_pass_dir": str(root / "fastq_pass"),
        "minimal_length": 500, "read_batch_size": 32, "polish_method": "poa",
        "delete_tmp_files": False, **knobs})


def test_early_return_disarms_the_watchdog(tmp_path):
    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun

    lib = simulator.simulate_library(seed=3, num_regions=2, molecules_per_region=(1, 1),
                                     reads_per_molecule=(1, 1))
    cfg = _lane(tmp_path, lib, stage_timeout_s=60, only_run_reference_self_homology=True)
    assert trun.run_with_config(cfg, device="cpu") == {}
    assert not twatchdog.active(), "the early return left an armed watchdog"


#: the stage the lane's stall drill stalls, and its short deadline
STALL_STAGE = "round2_umi_cluster"
STALL_HARD_S = 1.0
GENEROUS_S = 120.0


class _ShortStage(twatchdog.Watchdog):
    """The configured watchdog, with a short deadline for STALL_STAGE only,
    so the drill is cancelled in a second while every other stage keeps
    the generous base."""

    @contextlib.contextmanager
    def guard(self, name: str, units: int = 0):
        with super().guard(name, units) as entry:
            if name == STALL_STAGE:
                entry.hard_s, entry.soft_s = STALL_HARD_S, STALL_HARD_S * self.soft_fraction
            yield entry


@pytest.fixture(scope="module")
def lane_runs(tmp_path_factory):
    """The tiny lane three times: no watchdog, a generous one, and a
    generous one whose round-2 clustering pass stalls once."""
    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun

    tmp = tmp_path_factory.mktemp("torch_watchdog")
    lib = simulator.simulate_library(seed=41, num_regions=2, molecules_per_region=(2, 2),
                                     reads_per_molecule=(5, 6), region_len=(600, 700))
    trees = {}

    def run(name, **knobs):
        trun.run_with_config(_lane(tmp / name, lib, **knobs), device="cpu")
        nano = tmp / name / "fastq_pass" / "nano_tcr"
        trees[name] = {p.relative_to(nano).as_posix(): p.read_bytes()
                       for p in sorted(nano.rglob("*")) if p.is_file()}

    run("plain")
    run("generous", stage_timeout_s=GENEROUS_S)
    orig_cluster, orig_wd = trun.stages.cluster_and_select_grouped, trun.watchdog.Watchdog
    stalled = []

    def stalling(*args, **kwargs):
        if kwargs.get("identity") == trun.RunConfig.vsearch_identity_consensus and not stalled:
            stalled.append(threading.current_thread().name)
            try:
                deadline = time.monotonic() + _WEDGE_CAP_S
                while time.monotonic() < deadline:
                    time.sleep(0.01)
            except twatchdog.StageTimeout:
                # the retry runs under the configured deadline again
                entry = twatchdog._current()._entries[threading.get_ident()]
                entry.hard_s, entry.soft_s = GENEROUS_S, GENEROUS_S * entry.soft_s / STALL_HARD_S
                raise
            raise AssertionError("the watchdog never cancelled the stall")
        return orig_cluster(*args, **kwargs)

    trun.stages.cluster_and_select_grouped = stalling
    trun.watchdog.Watchdog = _ShortStage
    try:
        run("stalled", stage_timeout_s=GENEROUS_S)
    finally:
        trun.stages.cluster_and_select_grouped = orig_cluster
        trun.watchdog.Watchdog = orig_wd
    assert stalled == ["MainThread"]
    return trees


#: files of timings, never byte-compared
TIMED = {"telemetry.json", "history.jsonl", "barcode01/stage_manifest.json",
         "barcode01/logs/stage_timing.tsv"}


def test_a_generous_deadline_changes_no_artifact(lane_runs):
    plain, generous = lane_runs["plain"], lane_runs["generous"]
    assert set(generous) == set(plain)
    assert [rel for rel in sorted(set(plain) - TIMED) if plain[rel] != generous[rel]] == []
    assert b'"events": []' in generous["robustness_report.json"]
    assert "barcode01/logs/watchdog.log" not in generous


def test_a_stalled_stage_is_reported_dumped_cancelled_and_retried(lane_runs):
    import json

    plain, stalled = lane_runs["plain"], lane_runs["stalled"]
    report = json.loads(stalled["robustness_report.json"])
    events = _no_clocks(report["events"])
    assert events == [
        ("watchdog.stall", 1, "stall", "stall_detected", STALL_STAGE),
        ("watchdog.stall", 1, "stall", "hard_cancel", STALL_STAGE),
        ("cluster.batched_round2", 1, "transient", "retried", None),
        ("cluster.batched_round2", 2, "transient", "recovered", None),
    ]
    dump = stalled["barcode01/logs/watchdog.log"].decode()
    assert dump.count("dumping all thread stacks") == 1 and "exceeded its hard deadline" in dump
    assert "stalling" in dump  # the stalled frame is in the dump
    for rel in ("barcode01/counts/umi_consensus_counts.csv",
                "barcode01/fasta/merged_consensus.fasta"):
        assert stalled[rel] == plain[rel]
    tel = json.loads(stalled["telemetry.json"])
    assert tel["robustness_events"]["watchdog.stall"] == 2
    assert not twatchdog.active()


_LOCKCHECK_PROBE = r"""
import json, threading
from ont_tcrconsensus_tpu_torch.robustness import lockcheck
from ont_tcrconsensus_tpu_torch.obs import metrics
lock = lockcheck.make_lock()
lockcheck.assert_held(lock, "probe.unheld")
with lock:
    lockcheck.assert_held(lock, "probe.held")
reg = metrics.MetricsRegistry()
print(json.dumps({"armed": lockcheck.armed(), "rlock": isinstance(lock, type(threading.RLock())),
                  "registry_rlock": isinstance(reg._lock, type(threading.RLock())),
                  "violations": lockcheck.violations()}))
"""


@pytest.mark.parametrize("env", ["1", ""])
def test_tcr_lockcheck_arms_the_ownership_checks_at_import(env):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    environ = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TCR_LOCKCHECK")}
    environ.update(PYTHONPATH=repo, TCR_LOCKCHECK=env)
    out = subprocess.run([sys.executable, "-c", _LOCKCHECK_PROBE], capture_output=True,
                         text=True, env=environ, cwd=repo, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    armed = env == "1"
    assert got == {"armed": armed, "rlock": armed, "registry_rlock": armed,
                   "violations": ["lockcheck: probe.unheld entered without owning its lock "
                                  "(thread MainThread)"] if armed else []}
