"""The run end to end on the CPU at a tiny size (the port's plain
path): the last line's schema, what the run's process loads, and the
refusals (no card, a checkout without the program)."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "ont_tcrconsensus_tpu"}

REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
from tcrbench import run
from tcrbench.tests._tiny import TINY
r = run.run_cell({cell!r}, 7, 0.1, {trace}, root={root!r}, device="cpu", traffic=TINY,
                 work={work!r})
r.pop("_info")
print(json.dumps({{"result": r, "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _rehearse(cell, trace, tmp_path):
    code = REHEARSAL.format(root=ROOT, cell=cell, trace=trace, work=str(tmp_path / "work"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,trace", [("rnn.deep_lane", False), ("poa.clonal_lane", True)])
def test_tiny_lane_rehearsal(cell, trace, tmp_path):
    got = _rehearse(cell, trace, tmp_path)
    r = got["result"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "check"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], (int, float))
    if trace:
        assert "assign.s_per_lane" in r["metrics"] and "reads_per_s" not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"reads_per_s", "peak_device_gb", "setup_s"}
    for name, c in r["check"].items():
        assert c["value"] <= c["limit"], name
    assert not FORBIDDEN & set(got["modules"])


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this is the refusal without one")
    out = subprocess.run([sys.executable, "tcrbench/run.py", "--workload", "rnn.deep_lane",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_bare_checkout_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "tcrbench"), tmp_path / "tcrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "tcrbench/run.py", "--workload", "rnn.deep_lane",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == ""


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``ont_tcrconsensus_tpu_torch``
    begins with ``ont_tcrconsensus_tpu``."""
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tcrbench")):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, f))}
                assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


@pytest.mark.parametrize("name", ["reference.py", "judge.py", "gen.py", "roofline", "metrics"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    path = os.path.join(ROOT, "tcrbench", name)
    files = ([os.path.join(path, f) for f in os.listdir(path) if f.endswith(".py")]
             if os.path.isdir(path) else [path])
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert "ont_tcrconsensus_tpu_torch" not in tops, f
