"""Chaos drills, in-run recovery: the port and the JAX package each run the
JAX package's chaos lane (seed 23, three regions, ``poa``, read batch 64, a
12 GB budget, no retry back-off) under one chaos plan, and must end with
the same counts CSV and merged consensus FASTA as an undisturbed run, the
same counts as the simulator's truth, and the same robustness events
(site, classification, outcome) as each other. The resume and
crash drills are in ``test_torch_chaos_resume.py``; this file also holds
the lane helpers that file imports."""

from __future__ import annotations

import json
import shutil
from collections import Counter

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import cli as jcli  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu.robustness import shutdown as jshutdown  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import cli as tcli  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import shutdown as tshutdown  # noqa: E402
from test_torch_e2e import _one_torch_thread  # noqa: E402,F401  (autouse)

pytestmark = pytest.mark.chaos

COUNTS_CSV = "nano_tcr/barcode01/counts/umi_consensus_counts.csv"
MERGED_FASTA = "nano_tcr/barcode01/fasta/merged_consensus.fasta"
ARTIFACTS = (COUNTS_CSV, MERGED_FASTA)
MANIFEST = "nano_tcr/barcode01/stage_manifest.json"
REPORT = "nano_tcr/robustness_report.json"
# (run config, run, cli main, faults, shutdown) of each package
SIDES = {
    "port": (RunConfig, lambda cfg: trun.run_with_config(cfg, device="cpu"), tcli.main,
             tfaults, tshutdown),
    "jax": (JConfig, jax_run, jcli.main, jfaults, jshutdown),
}


def disarm():
    for *_, faults_mod, shutdown_mod in SIDES.values():
        faults_mod.disarm()
        shutdown_mod.deactivate()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    disarm()


def lane_inputs(tmp):
    """The JAX package's chaos lane (``tests/test_chaos.py``)."""
    lib = jsim.simulate_library(
        seed=23, num_regions=3, molecules_per_region=(2, 3), reads_per_molecule=(5, 8),
        sub_rate=0.006, ins_rate=0.003, del_rate=0.003, region_len=(700, 850),
    )
    inputs = tmp / "inputs"
    (inputs / "fastq_pass" / "barcode01").mkdir(parents=True)
    jfastx.write_fasta(inputs / "reference.fa", lib.reference.items())
    jfastx.write_fastq(inputs / "fastq_pass" / "barcode01" / "barcode01.fastq.gz", lib.reads)
    return lib, inputs


def stage(inputs, root):
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(inputs / "reference.fa", root / "reference.fa")
    shutil.copytree(inputs / "fastq_pass", root / "fastq_pass")
    return root


def cfg_dict(root, **overrides) -> dict:
    d = {
        "reference_file": str(root / "reference.fa"),
        "fastq_pass_dir": str(root / "fastq_pass"),
        "minimal_length": 600,
        "min_reads_per_cluster": 4,
        "read_batch_size": 64,
        "polish_method": "poa",
        "delete_tmp_files": False,
        "hbm_budget_gb": 12.0,
        "retry_base_delay_s": 0.0,
    }
    d.update(overrides)
    return d


def run(side, root, **overrides):
    config_cls, run_fn, *_ = SIDES[side]
    return run_fn(config_cls.from_dict(cfg_dict(root, **overrides)))


def artifacts(root) -> dict[str, bytes]:
    return {rel: (root / "fastq_pass" / rel).read_bytes() for rel in ARTIFACTS}


def report(root) -> dict:
    return json.loads((root / "fastq_pass" / REPORT).read_text())


def events(root) -> Counter:
    """The report's events as a multiset of (site, classification, outcome)."""
    return Counter((e["site"], e["classification"], e["outcome"])
                   for e in report(root)["events"])


def manifest_stages(root) -> dict:
    data = json.loads((root / "fastq_pass" / MANIFEST).read_text())
    return data.get("stages", data)


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """The lane and one undisturbed run of each package (the byte
    reference of every drill)."""
    tmp = tmp_path_factory.mktemp("torch_chaos")
    lib, inputs = lane_inputs(tmp)
    base = {}
    for side in SIDES:
        root = stage(inputs, tmp / f"baseline_{side}")
        assert run(side, root)["barcode01"] == lib.true_counts
        base[side] = artifacts(root)
    assert base["port"] == base["jax"]
    return {"tmp": tmp, "inputs": inputs, "lib": lib, "artifacts": base["port"]}


def drill(lane, tmp_path, name, plan, **overrides):
    """Run one chaos plan on both packages; {side: (root, counts, fires
    per spec)}."""
    out = {}
    for side in SIDES:
        root = stage(lane["inputs"], tmp_path / f"{name}_{side}")
        got = run(side, root, chaos=plan, **overrides)
        out[side] = (root, got["barcode01"],
                     [SIDES[side][3].fired(spec["site"]) for spec in plan])
        disarm()
    return out


RECOVERY = {
    # transient faults at the dispatches and a dead QC worker
    "transient-dispatches-and-dead-worker": (
        [{"site": "assign.dispatch", "kind": "transient"},
         {"site": "polish.dispatch", "kind": "transient"},
         {"site": "overlap.worker", "kind": "transient"}],
        {("assign.round1", "transient", "retried"): 1,
         ("assign.round1", "transient", "recovered"): 1,
         ("polish.dispatch", "transient", "retried"): 1,
         ("polish.dispatch", "transient", "recovered"): 1,
         ("overlap.worker", "transient", "retried"): 1,
         ("overlap.worker", "transient", "recovered"): 1}),
    "oom-polish": ([{"site": "polish.dispatch", "kind": "oom"}],
                   {("polish.dispatch", "oom", "oom_shrink"): 1}),
    "poisoned-batched-passes": (
        [{"site": "cluster.batched_round1", "kind": "error"},
         {"site": "cluster.batched_round2", "kind": "error"}],
        {("cluster.batched_round1", "fatal", "fatal"): 1,
         ("cluster.batched_round1", "fatal", "degraded"): 1,
         ("cluster.batched_round2", "fatal", "fatal"): 1,
         ("cluster.batched_round2", "fatal", "degraded"): 1}),
    # the same under the imperative order, which shares the fallback
    "poisoned-batched-passes-imperative": (
        [{"site": "cluster.batched_round1", "kind": "error"},
         {"site": "cluster.batched_round2", "kind": "error"}],
        {("cluster.batched_round1", "fatal", "degraded"): 1,
         ("cluster.batched_round2", "fatal", "degraded"): 1},
        {"executor": "imperative"}),
}


@pytest.mark.parametrize("name", sorted(RECOVERY))
def test_in_run_recovery_equals_jax(lane, tmp_path, name):
    plan, expect, *overrides = RECOVERY[name]
    out = drill(lane, tmp_path, name, plan, **(overrides[0] if overrides else {}))
    (proot, pcounts, pfired), (jroot, jcounts, jfired) = out["port"], out["jax"]
    assert pfired == jfired == [1] * len(plan)
    assert pcounts == jcounts == lane["lib"].true_counts
    assert artifacts(proot) == artifacts(jroot) == lane["artifacts"]
    assert events(proot) == events(jroot)
    for key, n in expect.items():
        assert events(proot)[key] == n, key
    assert report(proot)["chaos"]["fired"] == report(jroot)["chaos"]["fired"]
    # a recovered run is complete: counts checkpointed, nothing skipped
    assert "counts" in manifest_stages(proot)
    assert not (proot / "fastq_pass" / "nano_tcr" / "barcode01" / "logs"
                / "incomplete_region_clusters.log").exists()


def test_a_node_fault_fails_the_library_and_resume_completes_it_as_in_jax(lane, tmp_path):
    """``graph.node`` sits outside every retry wrapper, in both packages: a
    fault there, even a transient one, fails the node and so the library;
    the guard reports it and the run raises. Here it fires at the 8th node
    body (``round2_umi_records``), after the round-1 checkpoint, so
    ``resume`` reloads round 1 and completes round 2."""
    kind = "transient"
    plan = [{"site": "graph.node", "kind": kind, "skip": 7}]
    msgs = {}
    for side in SIDES:
        root = stage(lane["inputs"], tmp_path / side)
        with pytest.raises(RuntimeError, match=r"1 library\(ies\) failed: \['barcode01'\]") as e:
            run(side, root, chaos=plan)
        msgs[side] = str(e.value)
        log = (root / "fastq_pass" / "nano_tcr" / "failed_libraries_p0.log").read_text()
        assert log.startswith("barcode01\t") and f"{kind} fault at graph.node" in log
        done = manifest_stages(root)
        assert "round1_consensus" in done and "counts" not in done
        disarm()
        assert run(side, root, resume=True)["barcode01"] == lane["lib"].true_counts
        assert artifacts(root) == lane["artifacts"]
        assert "counts" in manifest_stages(root)
    assert msgs["port"] == msgs["jax"]


def test_the_disarmed_baseline_report_is_clean(lane):
    for side in SIDES:
        rep = report(lane["tmp"] / f"baseline_{side}")
        assert rep["sites"] == {} and rep["events"] == [] and rep["chaos"] is None
        assert rep["contracts"]["violated"] == {}
    assert report(lane["tmp"] / "baseline_port")["contracts"] == report(
        lane["tmp"] / "baseline_jax")["contracts"]


@pytest.mark.slow
def test_a_c_level_hang_is_detected_and_recovered_as_in_jax(lane, tmp_path):
    """The twin of the JAX package's C-level wedge drill
    (``test_chaos_hang_c_level_wedge_detected_and_recovered``): a ``hang``
    at ``polish.dispatch`` (one long C-level sleep) outlives the stage's
    6 s deadline. The watchdog detects and dumps on time, queues the cancel
    at the hard deadline, the StageTimeout lands when the call returns, and
    the stage retries to the undisturbed files, in both packages alike.
    Slow-marked as JAX's is: the wedge must outlive its deadline."""
    plan = [{"site": "polish.dispatch", "kind": "hang"}]
    out = drill(lane, tmp_path, "hang", plan, stage_timeout_s=6.0)
    for side, (root, counts, fired) in out.items():
        assert fired == [1], side
        assert counts == lane["lib"].true_counts, side
        assert artifacts(root) == lane["artifacts"], side
        sites = report(root)["sites"]
        wd = sites["watchdog.stall"]["by_outcome"]
        assert wd["stall_detected"] >= 1 and wd["hard_cancel"] >= 1, side
        pol = sites["polish.dispatch"]["by_outcome"]
        assert pol["retried"] >= 1 and pol["recovered"] >= 1, side
    assert set(events(out["port"][0])) == set(events(out["jax"][0]))
