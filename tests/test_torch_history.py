"""The port's run ledger (``obs/history.py``) against the JAX package's: the
config fingerprint of the same config, the ledger entry built from the same
telemetry, the three gates on the same seeded ledgers, and rotation. Both
packages read one run config, so a port run and a JAX run of one workload
pool in one ledger."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.obs import history as jhistory  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import history as thistory  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig  # noqa: E402

CONFIGS = [
    {},
    {"read_batch_size": 32, "polish_method": "poa"},
    {"telemetry": "full", "live_port": 0, "history_ledger": "/tmp/ledger.jsonl",
     "profile_trace_dir": "/tmp/prof", "compile_cache_dir": "off"},
    {"stage_timeout_s": 60, "overlap_qc": False, "error_profile_sample": 0},
    {"min_reads_per_cluster": 2, "low_depth_polish": True, "sw_band_width": 256,
     "executor": "imperative"},
]


@pytest.mark.parametrize("knobs", CONFIGS, ids=range(len(CONFIGS)))
def test_config_fingerprint_equals_jax(knobs):
    base = {"reference_file": "r.fa", "fastq_pass_dir": "fq", **knobs}
    fp = thistory.config_fingerprint(RunConfig.from_dict(base))
    assert fp == jhistory.config_fingerprint(JConfig.from_dict(base))
    assert len(fp) == 16
    # paths and observation endpoints never change it
    moved = {**base, "reference_file": "/elsewhere/ref.fa", "fastq_pass_dir": "/mnt/fq"}
    assert thistory.config_fingerprint(RunConfig.from_dict(moved)) == fp


def test_fingerprint_sees_workload_knobs_and_excludes_the_same_keys():
    assert thistory.FINGERPRINT_EXCLUDED_KEYS == jhistory.FINGERPRINT_EXCLUDED_KEYS
    a = {"reference_file": "r.fa", "fastq_pass_dir": "fq"}
    assert (thistory.config_fingerprint(RunConfig.from_dict({**a, "read_batch_size": 32}))
            != thistory.config_fingerprint(RunConfig.from_dict(a)))
    assert thistory.config_fingerprint({"b": 1, "a": 2}) == jhistory.config_fingerprint(
        {"a": 2, "b": 1})


def _telemetry(rng) -> dict:
    return {
        "duration_s": float(rng.uniform(10, 20)),
        "stages": {"round1_polish": {"seconds": 3.5, "calls": 1},
                   "round1_fused_assign": {"seconds": 2.25, "calls": 1}, "bad": 3},
        "dispatch": {"polish.dispatch": {"dispatches": 2, "gets": 0, "host_s": 1.25,
                                         "block_s": 0.5},
                     "assign.dispatch": {"dispatches": 3, "gets": 3, "host_s": 0.75,
                                         "block_s": 0.125}},
        "compile": {"count": 2, "seconds": 3.5, "by_stage": {}},
        "gauges": {"device.hbm_bytes_in_use": 9_240_000_000, "host.rss_bytes": 123456},
        "transfers": {"sites": {"assign.dispatch": {"h2d_bytes": 10, "h2d": 1,
                                                    "d2h_bytes": 4096, "d2h": 3}},
                      "edges": {}, "host_round_trip_bytes": 0,
                      "donation": {"cons_codes": {"verdict": "donated", "node": "x"}}},
        "analysis": {"graftcheck": {"verdict": "clean"}},
        "graph": {"nodes": {"round1_polish": {"critical_s": 3.5, "overlapped_s": 0.0,
                                              "runs": 1, "skips": 0, "units": 11}}},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_entry_equals_jax(seed):
    tel = _telemetry(np.random.default_rng(seed))
    kw = dict(fingerprint="abc", sha="deadbeef", backend="cuda", n_reads=1000,
              reads_per_sec=205.7, warmup_s=1.5, steady_s=12.25, extra={"mesh_config": None})
    t = thistory.build_entry("run", tel, **kw)
    j = jhistory.build_entry("run", tel, **kw)
    assert abs(t.pop("t_wall") - j.pop("t_wall")) < 5.0
    assert t == j
    assert t["dispatch_host_s"] == 2.0 and t["hbm_high_water_bytes"] == 9_240_000_000


def _ledger(rng, n: int, metric: str, **common) -> list[dict]:
    base = {"schema": 1, "fingerprint": "fp", "backend": "cuda", "n_reads": 1000, **common}
    return [{**base, metric: float(v)} for v in rng.normal(100.0, 3.0, n)]


def _verdict(res) -> dict:
    return dataclasses.asdict(res)


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("scale", [1.0, 1.3, 0.7])
def test_gates_equal_jax(seed, scale):
    rng = np.random.default_rng(seed)
    for metric, gate in (("reads_per_sec", "evaluate_gate"),
                         ("duration_s", "evaluate_gate")):
        entries = _ledger(rng, 6, metric)
        current = {**entries[0], metric: entries[0][metric] * scale}
        got = getattr(thistory, gate)(entries[1:], current)
        want = getattr(jhistory, gate)(entries[1:], current)
        assert _verdict(got) == _verdict(want)
        thin = getattr(thistory, gate)(entries[1:2], current)
        assert _verdict(thin) == _verdict(getattr(jhistory, gate)(entries[1:2], current))
        assert thin.status == "warn"
    entries = _ledger(rng, 6, "host_round_trip_bytes")
    current = {**entries[0], "host_round_trip_bytes": entries[0]["host_round_trip_bytes"]
               * scale}
    for budget in (None, 0.0, 150.0):
        got = thistory.evaluate_bytes_gate(entries[1:], current, abs_budget=budget)
        want = jhistory.evaluate_bytes_gate(entries[1:], current, abs_budget=budget)
        assert _verdict(got) == _verdict(want)
    loads = [{**e, "source": "serve_load", "p99_wait_s": e["reads_per_sec"] / 50.0}
             for e in _ledger(rng, 6, "reads_per_sec")]
    loads[-1] = {**loads[-1], "reads_per_sec": loads[-1]["reads_per_sec"] * scale}
    for current in (None, loads[-1], {"source": "run"}):
        got = thistory.evaluate_load_gate(loads[:-1] if current else loads, current)
        want = jhistory.evaluate_load_gate(loads[:-1] if current else loads, current)
        assert _verdict(got) == _verdict(want)


def test_rotation_and_garbage_lines_equal_jax(tmp_path):
    paths = {}
    for name, mod in (("port", thistory), ("jax", jhistory)):
        path = tmp_path / f"{name}.jsonl"
        for i in range(9):
            mod.append_entry(str(path), {"schema": 1, "i": i}, max_entries=5)
        with open(path, "a") as fh:
            fh.write("{torn\n[1, 2]\n\n")
        paths[name] = path
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    got, want = (mod.read_entries(str(paths[n]))
                 for n, mod in (("port", thistory), ("jax", jhistory)))
    assert got == want
    assert [e["i"] for e in got[0]] == [4, 5, 6, 7, 8] and len(got[1]) == 2


def test_detect_backend_reads_only_a_loaded_torch():
    assert thistory.detect_backend() in ("cpu", "cuda")


def test_record_run_writes_the_run_device_and_the_shared_ledger(tmp_path):
    from ont_tcrconsensus_tpu_torch.obs import metrics

    cfg = RunConfig.from_dict({"reference_file": "r.fa", "fastq_pass_dir": "fq",
                               "history_ledger": str(tmp_path / "shared.jsonl")})
    assert thistory.record_run(str(tmp_path), cfg) is None  # disarmed: nothing
    reg = metrics.arm()
    try:
        reg.stage_add("round1_polish", 1.5)
        entry = thistory.record_run(str(tmp_path), cfg, backend="cuda")
    finally:
        metrics.disarm()
    lines = [json.loads(x) for x in (tmp_path / "history.jsonl").read_text().splitlines()]
    shared = [json.loads(x) for x in (tmp_path / "shared.jsonl").read_text().splitlines()]
    assert lines == shared == [entry]
    assert entry["backend"] == "cuda" and entry["source"] == "run"
    assert entry["fingerprint"] == jhistory.config_fingerprint(JConfig.from_dict({
        "reference_file": "r.fa", "fastq_pass_dir": "fq"}))
    assert entry["stages"] == {"round1_polish": 1.5}
