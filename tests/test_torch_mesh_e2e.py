"""The port's data mesh end to end against the JAX package's, on CPU slices.

The lane is ``test_torch_e2e.py``'s clean one (the JAX package's e2e
lane: seed 11, four regions of 700-850 nt, read batch 64). The port runs
on eight installed CPU slices (``install_slice_devices``), the JAX
package on its eight virtual XLA devices.

- ``data=2`` under the graph executor (``rnn``, the default polish) and
  under ``executor: "imperative"`` (``poa``): every file under
  ``nano_tcr/`` byte-identical to the JAX package's ``data=2`` run, but
  the four files of timings, which are compared by schema. The port's
  ``data=8`` run and its unsharded run write the same files but the
  round-1 error profile (:data:`MOVES_WITH_THE_MESH`). One difference
  from the JAX package is named: the port gauges every slice busy at each
  sharded dispatch (``mesh_slice_busy`` and the ``mesh.slice_busy``
  gauge, last value in ``gauges_live``),
  where the JAX package's pipeline gauges slices only when a mesh
  degrades.
- The chaos drills of the JAX package's ``tests/test_chaos.py``
  (``mesh.device_lost``, ``mesh.slice_oom``) and a transient
  ``mesh.dispatch``, at ``data=2`` under ``poa``: the robustness report's
  events, the telemetry counters and the slice gauges are the JAX run's,
  and the counts CSV and merged FASTA are the undisturbed run's.
- The CLI with ``--cpu`` runs ``data=1`` (its one slice) to the unsharded
  run's files and refuses ``data=2``; the ``read_batch_size``
  divisibility error, word for word."""

import json

import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import run as jrun  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel import mesh  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import cli  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402
from test_torch_e2e import LANES, _assert_same_schema, _lane_dir, _schema, _tree  # noqa: E402
from test_torch_e2e import _one_torch_thread  # noqa: E402,F401  (this file's fixture too)

ARTIFACTS = ("barcode01/counts/umi_consensus_counts.csv",
             "barcode01/fasta/merged_consensus.fasta")
TIMINGS = ("telemetry.json", "history.jsonl", "barcode01/stage_manifest.json",
           "barcode01/logs/stage_timing.tsv")
SLICE_GAUGES = ("mesh_slice_busy", "mesh.slice_busy")
# Round 1's fast path aligns a quarter of each batch, the rows picked per
# slice (as on each JAX shard), so the reads the error profile samples
# carry other spans at another data-axis size; the JAX package's data=2
# and unsharded runs differ in this file the same way. The counts and the
# consensus do not move.
MOVES_WITH_THE_MESH = {"barcode01/logs/barcode01_align_error_profile.log"}


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    return jsim.simulate_library(**LANES["clean"]), tmp_path_factory.mktemp("mesh_e2e")


def _run(lane, side, name, method="rnn", executor="graph", **knobs):
    """One run of ``side`` ("port" or "jax") on the lane; its nano_tcr tree."""
    lib, tmp = lane
    root = tmp / f"{side}_{name}"
    cfg = {**_lane_dir(root, lib, method, "clean", executor), **knobs}
    if side == "jax":
        jrun.run_with_config(JConfig.from_dict(cfg))
    else:
        mesh.install_slice_devices(["cpu"] * 8)
        try:
            trun.run_with_config(RunConfig.from_dict(cfg), device="cpu")
        finally:
            mesh.install_slice_devices(None)
    return _tree(root)


def _telemetry(tree, drop_gauges=False):
    tel = json.loads(tree["telemetry.json"])
    if drop_gauges:
        tel.pop("mesh_slice_busy", None)
        for section in ("gauges", "gauges_live"):
            tel.get(section, {}).pop("mesh.slice_busy", None)
        if not tel.get("gauges_live", True):
            del tel["gauges_live"]
    return tel


def _assert_files_equal(port, other, but=()):
    assert sorted(port) == sorted(other)
    differ = [rel for rel in sorted(port) if rel not in TIMINGS and port[rel] != other[rel]]
    assert differ == sorted(but)


@pytest.fixture(scope="module")
def graph_runs(lane):
    return {
        "jax_d2": _run(lane, "jax", "d2", mesh_shape={"data": 2}),
        "d2": _run(lane, "port", "d2", mesh_shape={"data": 2}),
        "d8": _run(lane, "port", "d8", mesh_shape={"data": 8}),
        "d0": _run(lane, "port", "d0"),
    }


def test_data2_writes_the_jax_data2_files(graph_runs):
    _assert_files_equal(graph_runs["d2"], graph_runs["jax_d2"])


@pytest.mark.parametrize("arm,other", [("d8", "jax_d2"), ("d8", "d0"), ("d2", "d0")])
def test_other_data_axes_move_only_the_round1_profile(graph_runs, arm, other):
    _assert_files_equal(graph_runs[arm], graph_runs[other], but=MOVES_WITH_THE_MESH)
    for rel in ARTIFACTS:
        assert graph_runs[arm][rel] == graph_runs[other][rel], rel


def test_timings_have_the_jax_schema_and_the_mesh_names(graph_runs):
    port, jax = graph_runs["d2"], graph_runs["jax_d2"]
    tel, jtel = _telemetry(port), _telemetry(jax)
    # the one named difference: the port's slice gauges
    assert tel["mesh_slice_busy"] == {"cpu:0": 1.0, "cpu:1": 1.0}
    assert tel["gauges"]["mesh.slice_busy"] == 2.0
    assert not any(k in jtel or k in jtel["gauges"] for k in SLICE_GAUGES)
    _assert_same_schema(_schema(_telemetry(port, drop_gauges=True)), _schema(jtel))
    assert sorted(tel["counters"]) == sorted(jtel["counters"])
    for name in ("assign.batches", "cluster.batched", "polish.chunks"):
        assert tel["counters"][name] == jtel["counters"][name], name
    assert tel["histograms"] == jtel["histograms"]
    (entry,), (jentry,) = ([json.loads(x) for x in t["history.jsonl"].decode().splitlines()]
                           for t in (port, jax))
    assert entry["mesh_config"] == jentry["mesh_config"] == "data=2"
    assert entry["fingerprint"] == jentry["fingerprint"]
    assert set(entry) == set(jentry)
    assert "mesh_config" not in json.loads(graph_runs["d0"]["history.jsonl"].decode())
    assert json.loads(graph_runs["d8"]["history.jsonl"].decode())["mesh_config"] == "data=8"
    assert _telemetry(graph_runs["d8"])["mesh_slice_busy"] == {f"cpu:{i}": 1.0
                                                               for i in range(8)}
    for t in (port, jax):
        rows = t["barcode01/logs/stage_timing.tsv"].decode().splitlines()
        assert rows[0] == "stage\tseconds\tcalls"
    assert (sorted(json.loads(port["barcode01/stage_manifest.json"])["stages"])
            == sorted(json.loads(jax["barcode01/stage_manifest.json"])["stages"]))


def test_the_cli_runs_a_one_slice_mesh_on_the_cpu(graph_runs, lane):
    """``--cpu`` has one slice: ``data=1`` runs through the CLI to the
    unsharded run's files, the round-1 profile included; ``data=2``
    raises the JAX package's error."""
    lib, tmp = lane
    cfgs = {}
    for n in (1, 2):
        root = tmp / f"cli_d{n}"
        cfgs[n] = tmp / f"cli_d{n}.json"
        cfgs[n].write_text(json.dumps({**_lane_dir(root, lib, "rnn", "clean", "graph"),
                                       "mesh_shape": {"data": n}}))
    assert cli.main([str(cfgs[1]), "--cpu"]) == 0
    _assert_files_equal(_tree(tmp / "cli_d1"), graph_runs["d0"])
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        cli.main([str(cfgs[2]), "--cpu"])


def test_imperative_data2_writes_the_jax_files(lane):
    kw = dict(method="poa", executor="imperative", mesh_shape={"data": 2})
    port, jax = _run(lane, "port", "imp_d2", **kw), _run(lane, "jax", "imp_d2", **kw)
    _assert_files_equal(port, jax)
    assert "graph" not in _telemetry(port) and "graph" not in _telemetry(jax)
    _assert_same_schema(_schema(_telemetry(port, drop_gauges=True)),
                        _schema(_telemetry(jax)))


def test_read_batch_size_must_divide_the_data_axis(lane, tmp_path):
    knobs = {"reference_file": str(tmp_path / "r.fa"), "fastq_pass_dir": str(tmp_path),
             "mesh_shape": {"data": 8}, "read_batch_size": 100}
    msgs = []
    mesh.install_slice_devices(["cpu"] * 8)
    try:
        for make, cfg in ((lambda c: trun.make_mesh_from_config(c, "cpu"), RunConfig),
                          (jrun.make_mesh_from_config, JConfig)):
            with pytest.raises(ValueError, match="read_batch_size") as exc:
                make(cfg.from_dict(knobs))
            msgs.append(str(exc.value))
    finally:
        mesh.install_slice_devices(None)
    assert msgs[0] == msgs[1] == "read_batch_size=100 must divide by the data axis size 8"


# -- the chaos drills -------------------------------------------------------------

DRILLS = {
    "device_lost": [{"site": "mesh.device_lost", "kind": "device-lost"}],
    "slice_oom": [{"site": "mesh.slice_oom", "kind": "oom"}],
    "dispatch": [{"site": "mesh.dispatch", "kind": "transient"}],
}


@pytest.fixture(scope="module")
def undisturbed(lane):
    return _run(lane, "port", "poa_d0", method="poa")


@pytest.fixture(scope="module", params=sorted(DRILLS))
def drill(request, lane):
    name = request.param
    kw = dict(method="poa", mesh_shape={"data": 2}, chaos=DRILLS[name],
              retry_base_delay_s=0.0)
    try:
        port = _run(lane, "port", f"drill_{name}", **kw)
        jax = _run(lane, "jax", f"drill_{name}", **kw)
    finally:
        tfaults.disarm()
        jfaults.disarm()
    return name, port, jax


def _events(tree):
    report = json.loads(tree["robustness_report.json"])
    return [{k: e.get(k) for k in ("site", "classification", "outcome", "attempt", "detail")}
            for e in report["events"]], report["sites"]


def test_drills_end_with_the_undisturbed_files(drill, undisturbed):
    _, port, jax = drill
    for rel in ARTIFACTS:
        assert port[rel] == undisturbed[rel] == jax[rel], rel


def test_drills_record_the_jax_events_and_counters(drill):
    name, port, jax = drill
    (events, sites), (jevents, jsites) = _events(port), _events(jax)
    assert events == jevents
    assert sites == jsites
    tel, jtel = _telemetry(port), _telemetry(jax)
    assert sorted(tel["counters"]) == sorted(jtel["counters"])
    for key, value in jtel["counters"].items():
        if not key.startswith("transfer."):  # bytes: the packages' arrays differ
            assert tel["counters"][key] == value, key
    assert tel.get("mesh_degraded_by_site") == jtel.get("mesh_degraded_by_site")
    if name == "device_lost":
        assert sites["polish.dispatch"]["by_outcome"] == {"escalated": 1}
        (ev,) = [e for e in events if e["site"] == "mesh.degraded"]
        assert ev["classification"] == "device_lost"
        assert ev["detail"] == {"node": "round1_polish", "data_from": 2, "data_to": 1}
        assert tel["counters"]["mesh.degraded"] == 1
        assert tel["mesh_degraded_by_site"] == {"mesh.device_lost": 1}
        assert tel["mesh_slice_busy"] == jtel["mesh_slice_busy"] == {"cpu:0": 1.0,
                                                                      "cpu:1": 0.0}
        assert sorted(tel["mesh_slice_busy"].values()) == [0.0, 1.0]
    elif name == "slice_oom":
        assert sites["polish.dispatch"]["by_outcome"]["oom_shrink"] == 1
        assert "mesh.degraded" not in sites
    else:
        assert "retried" in json.dumps(sites)
        assert "mesh.degraded" not in sites
