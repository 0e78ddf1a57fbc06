"""Every cell, configuration, traffic mix, metric and kernel count is
found by name; a new traffic file and its cell need no edit to a file
that is there; a stage reader's stages are its own; BENCHMARK.json keeps
to its schema."""

import importlib
import importlib.util
import json
import os
import re
import shutil

import pytest

from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
from tcrbench import gen, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_is_found_by_name():
    bench = _bench()
    for cell in bench["workloads"]:
        spec = run.load_cell(ROOT, cell["name"])
        assert spec["config"]["name"] == cell["config"]
        RunConfig.from_dict({"reference_file": "r.fa", "fastq_pass_dir": "fq",
                             **spec["config"]["knobs"]})
        lib = gen.generate({**spec["traffic"], "num_regions": 2, "molecules_per_region": [1, 1],
                            "reads_per_molecule": [1, 1], "heavy": {}, "extra_reads": None,
                            "num_similar_pairs": 0}, 1)
        assert len(lib.reads) == 2
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


def test_every_metric_has_its_reader():
    for metric in _bench()["per_layer"]:
        read = run.load_reader(ROOT, metric["name"])
        assert read({"lanes": 0, "lane_s": [], "timings": [], "telemetry": [],
                     "window_s": 0.0}) is None


def test_every_kernel_count_names_a_real_entry_point():
    rec = run.LaunchRecorder(ROOT)
    files = [f for f in os.listdir(os.path.join(ROOT, "tcrbench", "roofline"))
             if f.endswith(".py") and not f.startswith("_")]
    assert rec.kernels and len(rec.kernels) == len(files)
    for mod in rec.kernels.values():
        assert callable(getattr(importlib.import_module(mod.ENTRY[0]), mod.ENTRY[1]))


def test_a_new_traffic_file_is_found_without_an_edit(tmp_path):
    """A later cell adds a traffic file and a workload entry; the
    harness's own files stay as they are."""
    shutil.copytree(os.path.join(ROOT, "tcrbench"), tmp_path / "tcrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["workloads"].append({"name": "rnn.extra_lane", "config": "tcr_rnn",
                               "traffic": "extra_lane", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    extra = {**run.load_cell(ROOT, "rnn.deep_lane")["traffic"], "num_regions": 3,
             "molecules_per_region": [1, 1], "reads_per_molecule": [2, 2], "num_similar_pairs": 0}
    (tmp_path / "tcrbench" / "traffic" / "extra_lane.json").write_text(json.dumps(extra))
    spec = run.load_cell(str(tmp_path), "rnn.extra_lane")
    assert spec["traffic"]["num_regions"] == 3
    assert len(gen.generate(spec["traffic"], 5).reads) == 3 * 2
    with pytest.raises(KeyError):
        run.load_cell(str(tmp_path), "rnn.missing_lane")


def test_benchmark_json_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["tcrbench"] and bench["command"][1] == "tcrbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    used = {w["config"] for w in bench["workloads"]}
    assert set(names) == used
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            body = json.load(fh)
        assert all(NAME.match(k) and k in body for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] == "reads_per_s" and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    layers: dict[str, set] = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_run_other_subtracts_the_stages_every_reader_declares(tmp_path):
    """A stage reader added as a file alone is taken out of
    ``run.other_s_per_lane`` with no edit to a file that is there."""
    shutil.copytree(os.path.join(ROOT, "tcrbench"), tmp_path / "tcrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    metrics = tmp_path / "tcrbench" / "metrics"
    ctx = {"lanes": 1, "lane_s": [10.0], "timings": [{"round1_fused_assign": 2.0,
                                                       "round2_counts": 1.5}],
           "telemetry": [], "window_s": 10.0}
    spec = importlib.util.spec_from_file_location("other_copy", metrics / "run.other_s_per_lane.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(ctx) == 8.0
    (metrics / "counts.s_per_lane.py").write_text(
        "from tcrbench.metrics._stages import per_lane\n"
        "STAGES = ('round2_counts',)\n\n\ndef read(ctx):\n    return per_lane(ctx, STAGES)\n")
    assert mod.read(ctx) == 6.5
