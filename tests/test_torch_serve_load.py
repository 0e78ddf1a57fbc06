"""``scripts/torch_serve_load.py``, the port's seeded load harness for the
warm-serving daemon, against the JAX package's ``scripts/serve_load.py``
(the non-slow cases of ``tests/test_serve_load.py``): the schedule, mix,
payloads, percentiles, the exact-accounting invariants and the report
schema give the JAX harness's answers; the ``smoke`` and ``packed``
scenarios (stub runner, in process, on the CPU) give the JAX harness's
report at the same seed and arguments but for the timings and paths; the
in-process loop crash journals and flushes as in JAX. The two subprocess
drills with the real pipeline are slow-marked, as JAX marks them."""

from __future__ import annotations

import json
import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import serve_load as jload  # noqa: E402
import torch_serve_load as tload  # noqa: E402

from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import history  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import queue as queue_mod  # noqa: E402

_BASE = {"reference_file": "r.fa", "fastq_pass_dir": "fq"}
# the report's fields of timings: never compared
TIMED = ("t_wall", "wait_s", "first_stage_s")


@pytest.fixture(autouse=True)
def _no_chaos_bleed():
    yield
    faults.disarm()
    jfaults.disarm()


def test_schedule_is_a_pure_function_of_seed_and_mix_as_in_jax():
    mix = tload.parse_mix("ok=4,over_budget=2,oversized_body=1")
    a = tload.build_schedule(3, mix, 2.0)
    assert a == tload.build_schedule(3, mix, 2.0)
    assert tload.build_schedule(4, mix, 2.0) != a
    assert a == jload.build_schedule(3, jload.parse_mix("ok=4,over_budget=2,oversized_body=1"),
                                     2.0)


def test_schedule_carries_the_exact_mix_multiset_in_window():
    sched = tload.build_schedule(0, {"ok": 3, "invalid_config": 2}, 1.5)
    assert sorted(s["kind"] for s in sched) == ["invalid_config"] * 2 + ["ok"] * 3
    offsets = [s["t"] for s in sched]
    assert offsets == sorted(offsets) and all(0.0 <= t < 1.5 for t in offsets)


def test_parse_mix_rejects_unknown_kind_and_empty():
    with pytest.raises(ValueError, match="unknown mix kind"):
        tload.parse_mix("ok=1,no_such_kind=2")
    with pytest.raises(ValueError, match="no submissions"):
        tload.parse_mix("ok=0")
    assert tload.MIX_KINDS == jload.MIX_KINDS and tload.STATUS_REASONS == jload.STATUS_REASONS


@pytest.mark.parametrize("kind", ["ok", "over_budget", "invalid_config", "oversized_body"])
def test_payloads_are_jax_s(kind):
    assert tload.payload_for(kind, _BASE) == jload.payload_for(kind, _BASE)
    obj, raw = tload.payload_for(kind, _BASE)
    if kind == "over_budget":
        assert obj["read_batch_size"] == 1 << 24
    if kind == "oversized_body":
        assert len(raw) > (1 << 20)


def test_percentile_nearest_rank():
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert tload.percentile(vals, 50) == 3.0 == jload.percentile(vals, 50)
    assert tload.percentile(vals, 99) == 5.0
    assert tload.percentile([7.0], 50) == 7.0
    assert tload.percentile([], 50) is None


def _sound_report(**over):
    report = {
        "schema": 1, "source": "serve_load", "scenario": "smoke", "seed": 0,
        "submitted": 10, "accepted": 6, "completed": 4, "poisoned": 1,
        "failed": 0, "journaled_remaining": 1,
        "rejected_by_reason": {"queue_full": 3, "invalid_config": 1},
        "wait_s": {"p50": 0.1, "p99": 0.2},
        "first_stage_s": {"p50": None, "p99": None},
        "invariants": [],
    }
    report.update(over)
    return report


@pytest.mark.parametrize("over,n", [({}, 0), ({"submitted": 11}, 1), ({"completed": 3}, 1),
                                    ({"submitted": 11, "completed": 3}, 2)])
def test_invariants_are_jax_s(over, n):
    got = tload.check_invariants(_sound_report(**over))
    assert got == jload.check_invariants(_sound_report(**over)) and len(got) == n


def test_report_schema_validates_and_names_holes_as_in_jax():
    assert tload.validate_report(_sound_report()) == []
    missing = _sound_report()
    del missing["rejected_by_reason"]
    missing["wait_s"] = {"p50": 0.1}
    missing["source"] = "bench"
    problems = tload.validate_report(missing)
    assert problems == jload.validate_report(missing)
    assert any("rejected_by_reason" in p for p in problems)
    assert any("wait_s missing 'p99'" in p for p in problems)
    assert tload.REPORT_SCHEMA == jload.REPORT_SCHEMA == 1


def test_ledger_reason_prefers_body_then_status_map():
    led = tload.Ledger()
    led.record("ok", 202, {"id": "job-1"})
    led.record("ok", 429, {"error": "queue_full"})
    led.record("ok", 413, {})
    led.record("ok", 500, {})
    assert led.submitted == 4 and led.accepted == 1 and led.accepted_ids == ["job-1"]
    assert led.rejected_by_reason == {"queue_full": 1, "body_too_large": 1, "http_500": 1}


def _both(tmp_path, args: list[str]) -> dict:
    """One scenario through each harness with the same arguments; each
    side's exit code and report."""
    out = {}
    for side, module, extra in (("port", tload, ["--cpu"]), ("jax", jload, [])):
        path = tmp_path / f"{side}.json"
        rc = module.main([*args, *extra, "--workdir", str(tmp_path / side), "--out", str(path)])
        out[side] = (rc, json.loads(path.read_text()))
    return out


def _untimed(report: dict) -> dict:
    body = {k: v for k, v in report.items() if k not in TIMED}
    body["drills"] = {k: v for k, v in report["drills"].items() if k != "ledger_entry"}
    return body


def test_smoke_report_is_jax_s(tmp_path):
    got = _both(tmp_path, ["--scenario", "smoke", "--seed", "7",
                           "--mix", "ok=2,over_budget=1,invalid_config=1,oversized_body=1",
                           "--period-s", "0.3", "--stub-job-s", "0.02",
                           "--queue-max", "2", "--burst", "4"])
    (rc, report), (jrc, jreport) = got["port"], got["jax"]
    assert rc == jrc == 0
    assert _untimed(report) == _untimed(jreport)
    assert report["invariants"] == [] and tload.validate_report(report) == []
    assert report["rejected_by_reason"] == {"queue_full": 2, "over_budget": 1,
                                            "invalid_config": 1, "body_too_large": 1,
                                            "draining": 1}
    assert report["drills"]["mid_drain_503"] == 1
    assert report["drills"]["saturation"]["queue_full_429"] == 2
    assert report["drills"]["resume"]["journal_consumed"]
    assert (report["drills"]["resume"]["completed_after_restart"]
            == report["drills"]["drain"]["journaled"] == 2)
    assert report["drills"]["metrics"]["live_queue_depth_gauge"]


def test_packed_report_is_jax_s(tmp_path):
    ledgers = {side: tmp_path / f"{side}_ledger.jsonl" for side in ("port", "jax")}
    out = {}
    for side, module, extra in (("port", tload, ["--cpu"]), ("jax", jload, [])):
        path = tmp_path / f"{side}.json"
        rc = module.main(["--scenario", "packed", "--seed", "11", "--mix", "ok=3,over_budget=1",
                          "--period-s", "0.2", "--stub-job-s", "0.02", "--queue-max", "4",
                          "--workers", "2", "--workdir", str(tmp_path / side), "--out",
                          str(path), "--ledger", str(ledgers[side]), *extra])
        out[side] = (rc, json.loads(path.read_text()))
    (rc, report), (jrc, jreport) = out["port"], out["jax"]
    assert rc == jrc == 0
    assert _untimed(report) == _untimed(jreport)
    packed = report["drills"]["packed"]
    assert packed["resident_high_water"] >= 2 and packed["disjoint_slices"] is True
    assert report["completed"] == report["accepted"] == 3
    entries = [json.loads(line) for line in ledgers["port"].read_text().splitlines()]
    jentries = [json.loads(line) for line in ledgers["jax"].read_text().splitlines()]
    skip = {"t_wall", "p50_wait_s", "p99_wait_s", "git_sha"}
    assert [{k: v for k, v in e.items() if k not in skip} for e in entries] == \
        [{k: v for k, v in e.items() if k not in skip} for e in jentries]
    pool = [dict(entries[-1]) for _ in range(3)] + entries
    assert history.evaluate_load_gate(pool).status in ("pass", "warn")


def test_packed_on_the_card_wants_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    args = tload.parse_args(["--scenario", "packed"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tload.slice_devices(args)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tload.slice_devices(args) == ["cuda:0", "cuda:0"]
    assert tload.slice_devices(tload.parse_args(["--scenario", "packed", "--cpu"])) == \
        ["cpu"] * 8


def test_smoke_without_cpu_raises_where_there_is_no_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tload.main(["--scenario", "smoke", "--workdir", str(tmp_path), "--out",
                    str(tmp_path / "r.json")])


def test_inprocess_crash_flushes_flight_recorder_and_journals(tmp_path, monkeypatch):
    from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod
    from ont_tcrconsensus_tpu_torch.serve.daemon import Daemon

    monkeypatch.setattr(run_mod, "run_with_config", lambda cfg, device=None: {"barcode01": {}})
    state = str(tmp_path / "state")
    d = Daemon(dict(_BASE), port=0, state_dir=state, queue_max=4, do_prewarm=False,
               device="cpu")
    assert d.submit({})[0] == 202
    assert d.submit({})[0] == 202
    faults.arm([{"site": "serve.daemon_loop", "kind": "error",
                 "message": "induced loop crash"}])
    box = {}

    def _run():
        try:
            d.serve_forever()
        except RuntimeError as exc:
            box["error"] = str(exc)

    th = threading.Thread(target=_run, daemon=True)
    th.start()
    th.join(timeout=60.0)
    assert not th.is_alive()
    assert box["error"] == "induced loop crash"
    with open(queue_mod.journal_path(state)) as fh:
        assert len(json.load(fh)["jobs"]) == 2  # the popped job was requeued first
    with open(os.path.join(state, "logs", "flight_recorder.json")) as fh:
        flight = json.load(fh)
    assert flight["reason"] == "serve_crash:RuntimeError" and flight["events"]


def _run_scenario(tmp_path, scenario):
    out = tmp_path / "load_report.json"
    rc = tload.main(["--scenario", scenario, "--seed", "3", "--tenants", "2",
                     "--drain-after-s", "1", "--timeout-s", "500", "--cpu",
                     "--workdir", str(tmp_path / "w"), "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0, report["invariants"]
    assert report["invariants"] == [] and report["drills"]["byte_identity"] is True
    assert report["drills"]["resume"]["journal_consumed"]
    assert report["completed"] == report["accepted"]
    return report


@pytest.mark.slow
def test_crash_e2e_flight_recorder_journal_and_byte_identity(tmp_path):
    report = _run_scenario(tmp_path, "crash")
    assert report["drills"]["disruption"]["exit_code"] != 0
    assert report["drills"]["flight_recorder"]["reason"] == "serve_crash:RuntimeError"
    assert (report["drills"]["journal"]["journaled"]
            == report["drills"]["resume"]["completed_after_restart"])


@pytest.mark.slow
def test_drain_e2e_sigterm_under_load_byte_identity(tmp_path):
    report = _run_scenario(tmp_path, "drain")
    assert report["drills"]["disruption"]["exit_code"] == 143
    assert report["drills"]["flight_recorder"]["reason"] == "serve_drain"
    assert report["drills"]["mid_drain_503"] in (1, "daemon_already_down")
