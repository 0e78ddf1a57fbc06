"""``scripts/torch_perf_gate.py``, the port's median/MAD regression gate,
against the JAX package's ``scripts/perf_gate.py`` on seeded ledgers: the
same verdicts (text and ``--json`` object) and exit codes for pass, fail,
warn and usage. The port's gate runs with ``jax`` and ``torch`` poisoned in
``sys.modules``, so it runs on a host whose card is wedged."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.obs import history  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = {"jax": os.path.join(REPO, "scripts", "perf_gate.py"),
         "port": os.path.join(REPO, "scripts", "torch_perf_gate.py")}

# the port's gate with both frameworks made unimportable
_POISONED = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["torch"] = None
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    bad = [m for m in ("jax", "torch") if sys.modules.get(m) is not None]
    assert not bad, bad
"""


def _run(side: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if side == "port":
        cmd = [sys.executable, "-c", _POISONED, GATES["port"], *args]
    else:
        cmd = [sys.executable, GATES["jax"], *args]
    return subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=120)


def _bench(rps, fp="f0", n_reads=11332):
    return history.build_entry("bench", fingerprint=fp, sha=None, backend="cuda",
                               n_reads=n_reads, reads_per_sec=rps,
                               extra={"host_round_trip_bytes": 0})


def _load(p99, rps=50.0):
    return history.build_entry("serve_load", fingerprint="f1", sha=None, backend="cuda",
                               n_reads=90, reads_per_sec=rps, warmup_s=1.0,
                               extra={"p99_wait_s": p99, "scenario": "sustained"})


def _ledger(seed: int, kind: str) -> list[dict]:
    rng = np.random.default_rng(seed)
    base = [_bench(float(150 + rng.normal(0, 3))) for _ in range(5)]
    if kind == "pass":
        return base + [_bench(148.0)]
    if kind == "fail":
        return base + [_bench(90.0)]
    if kind == "warn":
        return [_bench(150.0)]
    if kind == "load_pass":
        return base + [_load(2.0 + 0.01 * i) for i in range(3)] + [_load(2.02)]
    if kind == "load_fail":
        return base + [_load(2.0 + 0.01 * i) for i in range(3)] + [_load(9.0)]
    if kind == "load_one":
        return [_load(1.5)]
    raise ValueError(kind)


@pytest.mark.parametrize("kind,rc", [("pass", 0), ("fail", 1), ("warn", 0), ("load_pass", 0),
                                     ("load_fail", 1), ("load_one", 0)])
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_the_port_s_gate_gives_the_jax_verdict(tmp_path, kind, rc, as_json):
    path = tmp_path / "ledger.jsonl"
    with open(path, "w") as fh:
        for e in _ledger(7, kind):
            fh.write(json.dumps(e) + "\n")
    args = [str(path)] + (["--json"] if as_json else [])
    got, want = _run("port", *args), _run("jax", *args)
    assert got.returncode == want.returncode == rc, (got.stderr, want.stderr)
    if as_json:
        body = json.loads(got.stdout)
        assert body == json.loads(want.stdout)
        assert {body["status"], body["load"]["status"]} & {"pass", "fail", "warn"}
    else:
        assert got.stdout == want.stdout
    if kind == "load_one":  # one sustained entry: nothing to gate against yet
        status = json.loads(got.stdout)["load"]["status"] if as_json else \
            got.stdout.splitlines()[-1].split()[2]
        assert status.lower() == "warn"


@pytest.mark.parametrize("case", ["missing_ledger", "empty_ledger", "bad_current",
                                  "current_not_object", "torn_line"])
def test_usage_and_torn_ledgers_as_in_jax(tmp_path, case):
    path = tmp_path / "ledger.jsonl"
    lines = [json.dumps(e) for e in _ledger(3, "pass")]
    args = [str(path)]
    if case == "missing_ledger":
        args = [str(tmp_path / "nope.jsonl")]
    elif case == "empty_ledger":
        path.write_text("")
    elif case == "bad_current":
        path.write_text("\n".join(lines) + "\n")
        args += ["--current", str(tmp_path / "nope.json")]
    elif case == "current_not_object":
        path.write_text("\n".join(lines) + "\n")
        (tmp_path / "cur.json").write_text("[1, 2]")
        args += ["--current", str(tmp_path / "cur.json")]
    else:
        path.write_text("\n".join(lines[:3] + ["{torn", "not json"] + lines[3:]) + "\n")
    got, want = _run("port", *args), _run("jax", *args)
    assert got.returncode == want.returncode
    assert got.stdout == want.stdout
    assert got.stderr.replace(GATES["port"], "") == want.stderr.replace(GATES["jax"], "")
    assert got.returncode == (0 if case == "torn_line" else 2)
