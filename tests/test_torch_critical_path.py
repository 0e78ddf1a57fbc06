"""The port's critical-path analyzer (``obs/critical_path.py``) against the
JAX package's, on the telemetry and trace of a JAX graph-executor run (a
tiny ``telemetry: full`` lane), on that telemetry damaged in known ways,
on a port run under ``executor: "imperative"``, whose telemetry has no
graph section, and on a port run under the default graph executor."""

from __future__ import annotations

import copy
import json

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.obs import critical_path as jcp  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import critical_path as tcp  # noqa: E402


def _lane(root, lib, **knobs) -> dict:
    from ont_tcrconsensus_tpu.io import fastx

    (root / "fastq_pass" / "barcode01").mkdir(parents=True)
    fastx.write_fasta(root / "reference.fa", lib.reference.items())
    fastx.write_fastq(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz", lib.reads)
    return {"reference_file": str(root / "reference.fa"),
            "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 500,
            "read_batch_size": 32, "polish_method": "poa", "delete_tmp_files": False,
            "telemetry": "full", **knobs}


@pytest.fixture(scope="module")
def graph_run(tmp_path_factory):
    from ont_tcrconsensus_tpu.io import simulator
    from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig
    from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

    tmp = tmp_path_factory.mktemp("torch_critical_path")
    lib = simulator.simulate_library(seed=41, num_regions=2, molecules_per_region=(2, 2),
                                     reads_per_molecule=(5, 6), region_len=(600, 700))
    jax_run(JConfig.from_dict(_lane(tmp / "jax", lib)))
    trun.run_with_config(RunConfig.from_dict(_lane(tmp / "port", lib, executor="imperative")),
                         device="cpu")
    trun.run_with_config(RunConfig.from_dict(_lane(tmp / "port_graph", lib)), device="cpu")

    def load(side):
        nano = tmp / side / "fastq_pass" / "nano_tcr"
        return (json.loads((nano / "telemetry.json").read_text()),
                json.loads((nano / "logs" / "trace.json").read_text()))

    return load("jax"), load("port"), load("port_graph"), tmp / "port_graph"


def _both(telemetry, trace=None):
    got = tcp.analyze(copy.deepcopy(telemetry), copy.deepcopy(trace))
    want = jcp.analyze(copy.deepcopy(telemetry), copy.deepcopy(trace))
    assert got == want
    tl: list[str] = []
    jl: list[str] = []
    tcp.render(got, tl)
    jcp.render(want, jl)
    assert tl == jl
    return got


def test_analyze_and_render_equal_jax_on_a_graph_run(graph_run):
    (telemetry, trace), *_ = graph_run
    assert "graph" in telemetry
    with_trace = _both(telemetry, trace)
    without = _both(telemetry)
    assert with_trace["problems"] == [] and without["problems"] == []
    assert with_trace["critical_path"] == without["critical_path"]
    assert "round1_polish" in with_trace["critical_path"]


def _damaged(telemetry: dict) -> list[dict]:
    out = []
    t = copy.deepcopy(telemetry)
    t["graph"]["nodes"]["round1_polish"] = "garbage"
    out.append(t)
    t = copy.deepcopy(telemetry)
    for node in t["graph"]["nodes"].values():
        node.pop("inputs", None)
        node.pop("outputs", None)
    out.append(t)
    t = copy.deepcopy(telemetry)
    t["graph"]["nodes"]["round1_fused_assign"]["inputs"] = ["r2_counts"]  # a cycle
    t["graph"]["nodes"]["round2_counts"]["outputs"] = ["r2_counts"]
    out.append(t)
    t = copy.deepcopy(telemetry)
    t["graph"]["pool"] = {"busy_s": "x"}
    t["dispatch_by_stage"] = {"round1_polish": {"host_s": -1}}
    out.append(t)
    t = copy.deepcopy(telemetry)
    t["graph"] = []
    out.append(t)
    out.append({})
    return out


@pytest.mark.parametrize("case", range(6))
def test_damaged_graph_telemetry_degrades_as_in_jax(graph_run, case):
    (telemetry, trace), *_ = graph_run
    got = _both(_damaged(telemetry)[case], trace)
    # a garbage pool or dispatch row is left out of the analysis silently
    assert bool(got["problems"]) is (case != 3)


def test_a_port_run_has_no_graph_section_yet(graph_run):
    _, (telemetry, trace), *_ = graph_run
    assert "graph" not in telemetry and "overlap_pool" in telemetry
    got = _both(telemetry, trace)
    assert got["problems"] and "no executed-graph section" in got["problems"][0]


def test_a_port_graph_run_analyzes_as_in_jax(graph_run):
    (jtelemetry, _), _, (telemetry, trace), _ = graph_run
    assert sorted(telemetry["graph"]["nodes"]) == sorted(jtelemetry["graph"]["nodes"])
    got = _both(telemetry, trace)
    assert got["problems"] == []
    assert sorted(got["nodes"]) == sorted(jtelemetry["graph"]["nodes"])
    assert got["critical_path"] and got["critical_path_s"] > 0


@pytest.mark.parametrize("flag", ["critical_path", "memory"])
def test_report_renders_a_port_graph_run_as_the_jax_renderer(graph_run, capsys, flag):
    """``--report --critical-path`` and ``--memory`` on a port graph run's
    artifacts: the port's renderer prints what the JAX package's prints."""
    from ont_tcrconsensus_tpu.obs import report as jreport
    from ont_tcrconsensus_tpu_torch.obs import report as treport

    root = str(graph_run[3] / "fastq_pass")
    out = []
    for mod in (treport, jreport):
        assert mod.report_main(root, **{flag: True}) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "stage graph" in out[0]
