"""The port's serve queue against the JAX package's: admission decisions
and their detail strings on one budget, the pop/mark/requeue lifecycle
and its snapshots (clocks masked), the metrics it plants, and the drain
journal (round trip, torn-file quarantine, garbage) and poison files,
equal to the JAX package's files with their wall clocks masked."""

from __future__ import annotations

import json
import os
import re
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.parallel.budget import BudgetModel as JBudget  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu.serve import queue as jqueue  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel as TBudget  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig as TConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import queue as tqueue  # noqa: E402

_BASE = {"reference_file": "r.fa", "fastq_pass_dir": "fq"}
SIDES = {"port": (tqueue, TConfig, TBudget, tmetrics, tfaults),
         "jax": (jqueue, JConfig, JBudget, jmetrics, jfaults)}
_CLOCK = re.compile(r'("(?:t_wall|submitted_t|started_t|finished_t|wait_s)": )[0-9.e+-]+')


def _mask(text: str) -> str:
    return _CLOCK.sub(r"\1<t>", text)


def _admission_cases(seed: int, n: int) -> list[dict]:
    """Seeded knob sets around the budget's edges."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        knobs = {"max_read_length": int(rng.choice([200, 700, 1500, 2048, 3000, 4096, 6000])),
                 "max_reads_per_cluster": int(rng.choice([8, 60, 500, 4000])),
                 "sw_band_width": int(rng.choice([128, 256, 384, 512]))}
        if rng.random() < 0.6:
            knobs["read_batch_size"] = int(2 ** rng.integers(6, 24))
        cases.append(knobs)
    return cases


@pytest.mark.parametrize("hbm_gb", [0.05, 1.0, 12.0, 80.0])
def test_admission_decisions_and_details_equal_jax(hbm_gb):
    for knobs in _admission_cases(int(hbm_gb * 100), 40):
        got = {side: mod.estimate_admission(Cfg.from_dict({**_BASE, **knobs}), Budget(hbm_gb))
               for side, (mod, Cfg, Budget, *_) in SIDES.items()}
        assert got["port"] == got["jax"], knobs


def _lifecycle(side: str) -> list:
    """One scripted pass through the queue: admissions and refusals, pops,
    requeues at the front and (with backoff) at the back, marks, the
    bounded finished memory; every return value and snapshot, clocks
    masked."""
    mod, Cfg, Budget, *_ = SIDES[side]
    q = mod.JobQueue(3, Budget(12.0))
    out = []

    def rec(value):
        out.append(_mask(json.dumps(value, sort_keys=True, default=str)))

    jobs = [q.submit({"i": i}, Cfg.from_dict(_BASE)) for i in range(3)]
    rec([j.snapshot() for j in jobs])
    for raw, knobs in (({"x": 1}, {}), ({"y": 2}, {"read_batch_size": 1 << 24})):
        try:
            q.submit(raw, Cfg.from_dict({**_BASE, **knobs}))
        except mod.AdmissionError as exc:
            rec([exc.reason, exc.detail, str(exc)])
    rec(q.reject("invalid_config", "bad knob").args)
    a = q.pop(timeout=0.01)
    rec([a.id, a.state, a.wait_s is not None])
    q.requeue_front(a)
    rec([q.depth(), [j.id for j in q.drain_jobs()], a.state])
    a = q.pop(timeout=0.01)
    b = q.pop(timeout=0.01)
    q.requeue_back(b, delay_s=30.0)
    c = q.pop(timeout=0.05)
    rec([a.id, c.id, q.pop(timeout=0.02)])  # b is still backing off
    b.not_before = 0.0
    rec(q.pop(timeout=0.05).id)
    q.mark(a, "done", result={"libraries": {"barcode01": 5}})
    q.mark(b, "poisoned", error="fatal: boom")
    q.mark(c, "failed", error="x")
    rec(q.snapshot())
    rec(q.job(a.id).snapshot())
    rec(q.job("job-9999"))
    for i in range(mod.MAX_FINISHED_REMEMBERED + 2):
        j = q.submit({"k": i}, Cfg.from_dict(_BASE))
        q.mark(q.pop(timeout=0.01), "done")
    rec([len(q.jobs), q.finished_order[:2], j.id])
    return out


def test_queue_lifecycle_and_snapshots_equal_jax():
    assert _lifecycle("port") == _lifecycle("jax")


def test_queue_metrics_equal_jax():
    summaries, lines = {}, {}
    for side, (mod, Cfg, Budget, metrics, _) in SIDES.items():
        reg = metrics.arm()
        try:
            q = mod.JobQueue(1, Budget(12.0))
            q.submit({}, Cfg.from_dict(_BASE))
            for knobs in ({}, {"read_batch_size": 1 << 24}):
                with pytest.raises(mod.AdmissionError):
                    q.submit({}, Cfg.from_dict({**_BASE, **knobs}))
            q.reject("draining", "d")
            q.mark(q.pop(timeout=0.01), "done")
            summary = reg.summary()
            summaries[side] = {k: summary[k] for k in
                               ("counters", "gauges", "gauges_live", "serve_rejected_by_reason")}
            # the wait histogram's values are clocks: its lines by name
            lines[side] = [ln.rsplit(" ", 1)[0] if "wait_s" in ln else ln
                           for ln in reg.prometheus_lines() if "serve" in ln]
        finally:
            metrics.disarm()
    assert summaries["port"] == summaries["jax"]
    assert summaries["port"]["counters"]["serve.rejected"] == 3
    assert lines["port"] == lines["jax"]


def _jobs(mod):
    return [mod.Job(id="job-0001", raw={"k": 1, "resume": True}, state="requeued",
                    submitted_t=1.5),
            mod.Job(id="job-0002", raw={"k": 2}, submitted_t=2.25)]


def test_journal_round_trip_equal_jax(tmp_path):
    files, loaded = {}, {}
    for side, (mod, *_) in SIDES.items():
        sd = str(tmp_path / side)
        path = mod.write_journal(sd, _jobs(mod))
        assert path == mod.journal_path(sd) and not os.path.exists(path + ".tmp")
        with open(path) as fh:
            files[side] = _mask(fh.read())
        loaded[side] = mod.load_journal(sd)
        assert not os.path.exists(path), "a loaded journal is consumed"
        assert mod.load_journal(sd) == []
        # an empty drain removes a stale journal instead of resurrecting it
        mod.write_journal(sd, _jobs(mod))
        assert mod.write_journal(sd, []) is None and not os.path.exists(path)
    assert files["port"] == files["jax"]
    assert loaded["port"] == loaded["jax"]
    assert [r["id"] for r in loaded["port"]] == ["job-0001", "job-0002"]


def test_torn_journal_is_quarantined_as_in_jax(tmp_path, capsys, monkeypatch):
    # one clock for both sides: the journal's t_wall sets the torn half's
    # length, and so the offset the JSON error names
    monkeypatch.setattr(time, "time", lambda: 1760000000.125)
    got = {}
    for side, (mod, *_, faults) in SIDES.items():
        sd = str(tmp_path / side)
        faults.arm([{"site": "serve.journal_write", "kind": "torn"}])
        try:
            path = mod.write_journal(sd, _jobs(mod))
        finally:
            faults.disarm()
        with open(path) as fh:
            torn = fh.read()
        with pytest.raises(ValueError):
            json.loads(torn)
        capsys.readouterr()
        assert mod.load_journal(sd) == []
        err = capsys.readouterr().err
        with open(path + ".bad") as fh:
            bad = fh.read()
        assert not os.path.exists(path) and mod.load_journal(sd) == []
        got[side] = (_mask(torn), _mask(bad), err.replace(str(tmp_path / side), "<sd>"))
    assert got["port"] == got["jax"]
    assert "torn/unreadable drain journal" in got["port"][2]


@pytest.mark.parametrize("garbage", [
    "{torn",
    json.dumps({"schema": 1, "jobs": "not-a-list"}),
    json.dumps([1, 2]),
    json.dumps({"schema": 1, "jobs": [{"id": "x", "raw": "not a dict"}, "garbage"]}),
])
def test_garbage_journals_degrade_as_in_jax(tmp_path, garbage, capsys):
    got = {}
    for side, (mod, *_) in SIDES.items():
        sd = tmp_path / side
        sd.mkdir()
        (sd / mod.JOURNAL_BASENAME).write_text(garbage)
        got[side] = (mod.load_journal(str(sd)),
                     sorted(p.name for p in sd.iterdir()),
                     capsys.readouterr().err.replace(str(sd), "<sd>"))
    assert got["port"] == got["jax"]


def test_poison_file_equal_jax(tmp_path):
    files = {}
    for side, (mod, *_) in SIDES.items():
        sd = str(tmp_path / side)
        assert mod.load_poison(sd) == []
        a, b = _jobs(mod)
        a.attempts, b.attempts = 3, 1
        path = mod.append_poison(sd, a, classification="retry_exhausted",
                                 error="TransientChaosError('UNAVAILABLE: x')")
        assert mod.append_poison(sd, b, classification="fatal", error="boom") == path
        with open(path) as fh:
            files[side] = _mask(fh.read())
        entries = mod.load_poison(sd)
        assert [e["classification"] for e in entries] == ["retry_exhausted", "fatal"]
        with open(path, "w") as fh:
            fh.write("{garbage")
        assert mod.load_poison(sd) == []
    assert files["port"] == files["jax"]
