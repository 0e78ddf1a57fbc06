"""The port's warm-serving daemon against the JAX package's.

- Prewarm: the declared width buckets, and a prewarm report at one small
  bucket with the JAX package's keys (plus the port's ``launches`` and
  ``build_s``); the mesh skip and a failed prewarm as in JAX.
- The control plane, with one stub runner patched into both packages'
  ``run_with_config``: the same scripted submissions over real HTTP give
  equal statuses and bodies (202/400/404/409/413/429/503, clocks masked);
  the transient/fatal/exhausted ladder gives JAX's recorder events, job
  states and poison file; a drain journals as JAX's does and a restarted
  daemon resumes the journal; a loop crash journals the popped job and
  flushes ``serve_crash:<Type>``.
- The real runner on ``poa`` (the JAX serve tests' lane: seed 29, three
  regions): two jobs through one port daemon each write every
  deterministic file of the port's one-shot run, their counts CSV and
  merged FASTA equal the JAX package's one-shot run, no job builds a
  kernel, and the ledger splits warm-up from steady time as in JAX.
- The CLI: ``serve`` without a card and without ``--cpu`` exits non-zero;
  a ``serve --cpu`` process gets SIGTERM mid-job, exits 143 and leaves
  the journal, and a restarted daemon completes the job to the one-shot
  run's counts CSV and merged FASTA.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.models import polisher as jpolisher  # noqa: E402
from ont_tcrconsensus_tpu.obs import history as jhistory  # noqa: E402
from ont_tcrconsensus_tpu.obs import live as jlive  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.parallel.budget import BudgetModel as JBudget  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import assign as jassign  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import run as jrun  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu.robustness import retry as jretry  # noqa: E402
from ont_tcrconsensus_tpu.robustness import shutdown as jshutdown  # noqa: E402
from ont_tcrconsensus_tpu.serve import daemon as jdaemon  # noqa: E402
from ont_tcrconsensus_tpu.serve import prewarm as jprewarm  # noqa: E402
from ont_tcrconsensus_tpu.serve import queue as jqueue  # noqa: E402
import ont_tcrconsensus_tpu_torch  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import fastx as tfastx  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import history as thistory  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import live as tlive  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel as TBudget  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.assign import AssignEngine, ReferencePanel  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig as TConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import retry as tretry  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import shutdown as tshutdown  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import daemon as tdaemon  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import prewarm as tprewarm  # noqa: E402
from ont_tcrconsensus_tpu_torch.serve import queue as tqueue  # noqa: E402
from test_torch_e2e import NOT_BYTE_COMPARED, _one_torch_thread, _tree  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(ont_tcrconsensus_tpu_torch.__file__))
_BASE = {"reference_file": "r.fa", "fastq_pass_dir": "fq"}
_CLOCK = re.compile(r'("(?:t_wall|t_mono|submitted_t|started_t|finished_t|wait_s|'
                    r'first_stage_s|warmup_s|seconds)": )[0-9.e+-]+')
ARTIFACTS = ("barcode01/counts/umi_consensus_counts.csv",
             "barcode01/fasta/merged_consensus.fasta")


class _Side:
    def __init__(self, name, daemon, queue, Cfg, run, faults, retry, shutdown, live,
                 metrics, history):
        self.name, self.daemon, self.queue, self.Cfg, self.run = name, daemon, queue, Cfg, run
        self.faults, self.retry, self.shutdown, self.live = faults, retry, shutdown, live
        self.metrics, self.history = metrics, history

    def make_daemon(self, template, state_dir, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.daemon.Daemon(template, port=0, state_dir=state_dir, **kw)


PORT = _Side("port", tdaemon, tqueue, TConfig, trun, tfaults, tretry, tshutdown, tlive,
             tmetrics, thistory)
JAX = _Side("jax", jdaemon, jqueue, JConfig, jrun, jfaults, jretry, jshutdown, jlive,
            jmetrics, jhistory)
SIDES = (PORT, JAX)


def _mask(value) -> str:
    return _CLOCK.sub(r"\1<t>", json.dumps(value, sort_keys=True))


def _http(method: str, url: str, obj=None, data: bytes | None = None):
    payload = None if method == "GET" else (json.dumps(obj).encode() if data is None else data)
    req = urllib.request.Request(url, data=payload, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as err:
        body = err.read().decode()
        return err.code, (json.loads(body) if body.startswith("{") else body)


def _wait(predicate, timeout: float = 60.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# config knobs, the ledger entry, prewarm


def test_serve_knobs_and_fingerprint_as_in_jax():
    for side in SIDES:
        cfg = side.Cfg.from_dict(_BASE)
        assert (cfg.serve_queue_max, cfg.serve_prewarm, cfg.serve_workers) == (8, True, 1)
        varied = side.Cfg.from_dict({**_BASE, "compile_cache_dir": "/tmp/cache",
                                     "serve_queue_max": 2, "serve_prewarm": False,
                                     "live_port": 0, "serve_workers": 2})
        assert side.history.config_fingerprint(varied) == side.history.config_fingerprint(cfg)
    for knobs in ({"serve_queue_max": 0}, {"serve_workers": True}, {"compile_cache_dir": ""}):
        errors = []
        for side in SIDES:
            with pytest.raises(ValueError) as info:
                side.Cfg.from_dict({**_BASE, **knobs})
            errors.append(str(info.value))
        assert errors[0] == errors[1]
    entries = [side.history.build_entry("serve", warmup_s=12.34567, steady_s=1.5)
               for side in SIDES]
    assert {k: entries[0][k] for k in ("source", "warmup_s", "steady_s")} == \
        {k: entries[1][k] for k in ("source", "warmup_s", "steady_s")} == \
        {"source": "serve", "warmup_s": 12.346, "steady_s": 1.5}


@pytest.mark.parametrize("max_read_length", [100, 200, 256, 700, 1000, 2048, 3000, 4096,
                                             5000, 9000])
def test_declared_width_buckets_equal_jax(max_read_length):
    got = [mod.declared_width_buckets(Cfg.from_dict({**_BASE, "max_read_length": max_read_length}))
           for mod, Cfg in ((tprewarm, TConfig), (jprewarm, JConfig))]
    assert got[0] == got[1]


def _small_reference() -> dict[str, str]:
    rng = __import__("numpy").random.default_rng(3)
    return {f"r{i}": "".join(rng.choice(list("ACGT"), 300)) for i in range(3)}


def _jax_report(monkeypatch, cfg_raw: dict, read_batch: int, widths: list[int]) -> dict:
    """JAX's prewarm report with its lowering stubbed out (what is compared
    is the report's shape and sizing, not XLA's compile)."""
    class _Lowered:
        def compile(self):
            return None

    class _Jit:
        def lower(self, *a, **kw):
            return _Lowered()

    monkeypatch.setattr(jassign, "_fused_pass", _Jit())
    monkeypatch.setattr(jpolisher, "_device_polish_batch_jit", _Jit())
    engine = types.SimpleNamespace(
        fast_denom=4, top_k=2, _static_kwargs=lambda **kw: {},
        panel=types.SimpleNamespace(d_codes=0, d_lens=0, d_profiles=0),
        umi_masks=0, umi_mask_lens=0, primer_stack=0, primer_stack_lens=0,
        primer_max_dists=0)
    return jprewarm.prewarm(JConfig.from_dict(cfg_raw), engine, read_batch, JBudget(12.0),
                            widths=widths)


def test_prewarm_report_at_one_bucket_has_the_jax_keys(tmp_path, monkeypatch):
    ref = tmp_path / "reference.fa"
    reference = _small_reference()
    tfastx.write_fasta(ref, reference.items())
    raw = {**_BASE, "reference_file": str(ref), "max_reads_per_cluster": 4,
           "min_reads_per_cluster": 2, "cluster_batch_size": 2}
    cfg = TConfig.from_dict(raw)
    panel = ReferencePanel.build(reference, {n: i for i, n in enumerate(reference)},
                                 device="cpu")
    engine = AssignEngine(panel, cfg.umi_fwd, cfg.umi_rev, primers=cfg.primer_sequences(),
                          primer_max_dist_frac=cfg.primer_max_dist_frac,
                          band_width=cfg.sw_band_width, device="cpu")
    port = tprewarm.prewarm(cfg, engine, 64, TBudget(12.0), widths=[256])
    jax_ = _jax_report(monkeypatch, raw, 64, [256])
    assert set(port) == set(jax_) | {"build_s"}
    assert (port["compiled"], port["failed"]) == (jax_["compiled"], jax_["failed"]) == (2, 0)
    for p, j in zip(port["entries"], jax_["entries"], strict=True):
        assert set(p) == set(j) | {"launches"}, (p, j)
        assert {k: p[k] for k in j if k != "seconds"} == {k: j[k] for k in j if k != "seconds"}
        # the CPU's plain versions launch no kernel
        assert p["launches"] == {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0, "B6": 0}
    assert [e["kind"] for e in port["entries"]] == ["fused_assign", "polisher"]
    assert port["entries"][1]["batch"] == 2 and port["entries"][1]["s_bucket"] == 4


def test_the_polisher_prewarm_band_is_not_the_polish_band_in_both_packages(monkeypatch):
    """Recorded in ROADMAP.md's Queue C: JAX's prewarm warms the polisher
    tile at ``sw_band_width`` (128 by default), while every polish chunk
    runs at ``POLISH_BAND_WIDTH`` (64) below width 2048, so the JAX
    daemon's warmed polish program is not the one its jobs run. The port
    copies the tile on purpose (equal reports); its warm-up launch still
    loads kernel B2's library, which holds both bands."""
    import inspect

    from ont_tcrconsensus_tpu.ops import consensus as jconsensus
    from ont_tcrconsensus_tpu.pipeline import stages as jstages
    from ont_tcrconsensus_tpu_torch.pipeline import stages as tstages

    raw = {**_BASE, "max_read_length": 2000}
    report = _jax_report(monkeypatch, raw, 64, [2048])
    band = [e for e in report["entries"] if e["kind"] == "polisher"][0]["band"]
    for stages in (jstages, tstages):
        default = inspect.signature(stages.polish_clusters_all).parameters["band_width"].default
        assert default == jconsensus.POLISH_BAND_WIDTH == 64
    assert band == TConfig.from_dict(raw).sw_band_width == 128


def test_prewarm_skips_mesh_configs_as_in_jax():
    raw = {**_BASE, "mesh_shape": {"data": 2}}
    got = [mod.prewarm(Cfg.from_dict(raw), None, 64, None)
           for mod, Cfg in ((tprewarm, TConfig), (jprewarm, JConfig))]
    assert got[0] == got[1] and got[0]["entries"] == []


def test_a_failed_prewarm_is_a_report_line_as_in_jax(tmp_path):
    got = []
    for side in SIDES:
        daemon = side.make_daemon(dict(_BASE), str(tmp_path / side.name))
        side.faults.arm([{"site": "serve.prewarm", "kind": "error"}])
        try:
            daemon._prewarm()
        finally:
            side.faults.disarm()
        got.append(_mask(daemon.prewarm_report))
    assert got[0] == got[1]
    assert '"failed": 1' in got[0]


# ---------------------------------------------------------------------------
# the control plane with one stub runner


class _StubRunner:
    """Replaces a package's ``run_with_config``: counts its calls, then
    parks on a gate polling that package's shutdown checkpoint."""

    def __init__(self, side: _Side):
        self.side = side
        self.gate = threading.Event()
        self.calls: list[str] = []

    def __call__(self, cfg, device=None):
        self.calls.append(os.path.basename(cfg.fastq_pass_dir))
        while not self.gate.wait(0.02):
            self.side.shutdown.checkpoint("stub.run")
        return {"barcode01": {"r1": 2, "r2": 3}}


class _Serving:
    """One package's serial daemon on a thread, its runner stubbed."""

    def __init__(self, side, tmp, monkeypatch, template=None, **kw):
        self.side = side
        self.tmp = tmp
        self.runner = _StubRunner(side)
        monkeypatch.setattr(side.run, "run_with_config", self.runner)
        self.daemon = side.make_daemon(
            {**_BASE, "compile_cache_dir": "off", "retry_base_delay_s": 0.0,
             **(template or {})}, str(tmp / "state"), do_prewarm=False, **kw)
        self.codes: list = []
        self.loop = threading.Thread(target=self._serve, name=f"serve-{side.name}",
                                     daemon=True)

    def _serve(self):
        try:
            self.codes.append(self.daemon.serve_forever())
        except Exception as exc:  # the loop-crash drill's error, for the test
            self.codes.append(exc)

    def __enter__(self):
        self.loop.start()
        _wait(lambda: self.side.live.server() is not None or self.codes, what="live plane")
        srv = self.side.live.server()
        self.url = f"http://127.0.0.1:{srv.port}/jobs" if srv is not None else None
        return self

    def __exit__(self, *exc):
        self.runner.gate.set()
        self.daemon.request_stop()
        self.loop.join(60.0)
        assert not self.loop.is_alive(), "daemon did not stop"

    def raw(self, tag: str, **over) -> dict:
        return {"fastq_pass_dir": str(self.tmp / tag), **over}

    def state(self, job_id: str) -> str:
        return self.daemon.queue.job(job_id).state


def _control_plane(side, tmp_path, monkeypatch) -> list:
    out = []
    with _Serving(side, tmp_path / side.name, monkeypatch, queue_max=2) as s:
        def post(obj=None, data=None, path="/jobs"):
            status, body = _http("POST", s.url.replace("/jobs", path), obj, data)
            out.append((status, _mask(body)))
            return body

        a = post(s.raw("fqA"))
        _wait(lambda: s.runner.calls, what="job A running")
        post(s.raw("fqB"))
        post(s.raw("fqC"))
        post(s.raw("fqD"))                                # queue_full
        post(s.raw("fqE", no_such_knob=1))                # invalid_config
        post(s.raw("fqF", read_batch_size=1 << 24))       # over_budget
        post(s.raw("fqG", live_port=0))                   # still queue_full
        post(data=b"{torn")
        post(data=b"[1, 2]")
        post(data=b"")
        post({}, path="/nope")
        monkeypatch.setattr(side.live, "MAX_JOB_BODY_BYTES", 64)
        post(s.raw("fqH", comment="x" * 200))             # body too large
        monkeypatch.setattr(side.live, "MAX_JOB_BODY_BYTES", 1 << 20)
        for path in ("", f"/{a['id']}", "/zzz"):
            status, body = _http("GET", s.url + path)
            out.append(("GET", status, _mask(body)))
        s.daemon._draining.set()
        post(s.raw("fqI"))                                # draining
        s.daemon._draining.clear()
        # read while job A still runs: each serial job's end re-arms a
        # fresh daemon-scope registry
        rejects = side.metrics.registry().summary()["serve_rejected_by_reason"]
        s.runner.gate.set()
        _wait(lambda: s.daemon.jobs_snapshot()["jobs_done"] == 3, what="three jobs done")
        out.append(_mask(s.daemon.jobs_snapshot()))
        out.append(rejects)
    return out


def test_jobs_routes_statuses_and_bodies_equal_jax(tmp_path, monkeypatch):
    got = [_control_plane(side, tmp_path, monkeypatch) for side in SIDES]
    assert got[0] == got[1]
    statuses = [r[0] for r in got[0][:12]]
    assert statuses == [202, 202, 202, 429, 400, 409, 429, 400, 400, 400, 404, 413]
    assert got[0][15][0] == 503
    assert got[0][-1] == {"body_too_large": 1, "draining": 1, "invalid_config": 1,
                          "over_budget": 1, "queue_full": 2}


def _ladder(side, tmp_path, monkeypatch) -> list:
    """Transient then done; fatal, poisoned; transient twice, exhausted."""
    side.retry.recorder().reset()
    monkeypatch.delenv("TCR_CHAOS", raising=False)
    side.faults.arm([
        {"site": "serve.job_run", "kind": "transient"},
        {"site": "serve.job_run", "kind": "error", "skip": 2},
        {"site": "serve.job_run", "kind": "transient", "skip": 3, "times": 2},
    ])
    out = []
    with _Serving(side, tmp_path / side.name, monkeypatch,
                  template={"retry_max_attempts": 2}) as s:
        s.runner.gate.set()
        for tag in ("fqA", "fqB", "fqC"):
            status, snap = s.daemon.submit(s.raw(tag))
            assert status == 202
            _wait(lambda: s.state(snap["id"]) in ("done", "poisoned"), what=tag)
            job = s.daemon.queue.job(snap["id"])
            out.append((snap["id"], job.state, job.error, job.attempts))
        out.append(list(s.runner.calls))
        out.append([(e["site"], e["classification"], e["outcome"], e["attempt"], e["error"])
                    for e in side.retry.recorder().events])
        with open(side.queue.poison_path(s.daemon.state_dir)) as fh:
            out.append(_mask(json.load(fh)).replace(str(s.tmp), "<tmp>"))
    return out


def test_retry_and_poison_ladder_equal_jax(tmp_path, monkeypatch):
    got = [_ladder(side, tmp_path, monkeypatch) for side in SIDES]
    assert got[0] == got[1]
    states = [(r[1], r[3]) for r in got[0][:3]]
    assert states == [("done", 1), ("poisoned", 1), ("poisoned", 2)]
    assert [e[2] for e in got[0][4]] == ["retry", "poisoned", "retry", "poisoned"]
    assert "retry_exhausted" in got[0][2][2] and "fatal" in got[0][1][2]


def _drain_and_resume(side, tmp_path, monkeypatch) -> list:
    tmp = tmp_path / side.name
    out = []
    with _Serving(side, tmp, monkeypatch) as s:
        a = s.daemon.submit(s.raw("fqA"))[1]["id"]
        b = s.daemon.submit(s.raw("fqB"))[1]["id"]
        _wait(lambda: s.runner.calls, what="job A running")
        # what a SIGTERM does, without the signal (a thread has no handlers)
        s.daemon._coord.request("drill")
        s.loop.join(60.0)
        out.append(s.codes)
        with open(side.queue.journal_path(s.daemon.state_dir)) as fh:
            out.append(_mask(json.load(fh)).replace(str(tmp), "<tmp>"))
        out.append((s.state(a), s.state(b)))
    with _Serving(side, tmp, monkeypatch) as s2:
        s2.runner.gate.set()
        _wait(lambda: s2.daemon.jobs_snapshot()["jobs_done"] == 2, what="resumed jobs")
        out.append(_mask(s2.daemon.jobs_snapshot()["jobs"]))
        out.append(list(s2.runner.calls))
        out.append(os.path.exists(side.queue.journal_path(s2.daemon.state_dir)))
    return out


def test_drain_journals_and_a_restart_resumes_as_in_jax(tmp_path, monkeypatch):
    got = [_drain_and_resume(side, tmp_path, monkeypatch) for side in SIDES]
    assert got[0] == got[1]
    assert got[0][0] == [143]
    journal = json.loads(got[0][1].replace("<t>", "0"))
    assert [(j["id"], j["state"], j["raw"].get("resume")) for j in journal["jobs"]] == \
        [("job-0001", "requeued", True), ("job-0002", "queued", None)]
    assert got[0][4] == ["fqA", "fqB"] and got[0][5] is False


def _loop_crash(side, tmp_path, monkeypatch) -> list:
    monkeypatch.delenv("TCR_CHAOS", raising=False)
    side.faults.arm([{"site": "serve.daemon_loop", "kind": "error",
                      "message": "induced serve-loop crash"}])
    with _Serving(side, tmp_path / side.name, monkeypatch) as s:
        s.daemon.submit(s.raw("fqA"))
        s.loop.join(60.0)
        crash = s.codes[0]
        with open(side.queue.journal_path(s.daemon.state_dir)) as fh:
            journal = _mask(json.load(fh)).replace(str(s.tmp), "<tmp>")
        with open(os.path.join(s.daemon.state_dir, "logs", "flight_recorder.json")) as fh:
            flight = json.load(fh)
    return [type(crash).__name__, str(crash), journal, flight["reason"], s.runner.calls]


def test_a_loop_crash_journals_and_flushes_as_in_jax(tmp_path, monkeypatch):
    got = [_loop_crash(side, tmp_path, monkeypatch) for side in SIDES]
    assert got[0] == got[1]
    assert got[0][:2] == ["RuntimeError", "induced serve-loop crash"]
    assert got[0][3] == "serve_crash:RuntimeError" and got[0][4] == []


def test_the_plane_is_disarmed_after_a_daemon(tmp_path, monkeypatch):
    with _Serving(PORT, tmp_path, monkeypatch) as s:
        s.runner.gate.set()
    assert tlive.server() is None and tlive._JOBS is None and tlive._NODE_START_HOOK is None
    assert tmetrics.registry() is None and tshutdown._ACTIVE is None
    assert not tfaults.active()


# ---------------------------------------------------------------------------
# the real runner on poa


def _stage(src, root):
    root.mkdir(parents=True)
    shutil.copy(src / "reference.fa", root / "reference.fa")
    shutil.copytree(src / "fastq_pass", root / "fastq_pass")
    return root


def _raw_cfg(root, **over) -> dict:
    return {"reference_file": str(root / "reference.fa"),
            "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 600,
            "min_reads_per_cluster": 4, "read_batch_size": 96, "polish_method": "poa",
            "delete_tmp_files": False, **over}


def _deterministic(tree: dict) -> dict:
    return {rel: b for rel, b in tree.items() if rel not in NOT_BYTE_COMPARED}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX serve tests' lane run one-shot by both packages, then two
    jobs of it through one warm port daemon over real HTTP."""
    tmp = tmp_path_factory.mktemp("torch_serve")
    lib = jsim.simulate_library(seed=29, num_regions=3, molecules_per_region=(2, 3),
                                reads_per_molecule=(5, 7), sub_rate=0.006, ins_rate=0.003,
                                del_rate=0.003, region_len=(700, 850))
    src = tmp / "src"
    (src / "fastq_pass" / "barcode01").mkdir(parents=True)
    tfastx.write_fasta(src / "reference.fa", lib.reference.items())
    tfastx.write_fastq(src / "fastq_pass" / "barcode01" / "barcode01.fastq.gz", lib.reads)
    oneshot = _stage(src, tmp / "oneshot")
    assert trun.run_with_config(TConfig.from_dict(_raw_cfg(oneshot)), device="cpu") == \
        {"barcode01": lib.true_counts}
    jax_root = _stage(src, tmp / "jax")
    assert jrun.run_with_config(JConfig.from_dict(_raw_cfg(jax_root))) == \
        {"barcode01": lib.true_counts}

    w1, w2 = _stage(src, tmp / "w1"), _stage(src, tmp / "w2")
    ledger = str(tmp / "serve_ledger.jsonl")
    daemon = PORT.make_daemon(_raw_cfg(w1, history_ledger=ledger), str(tmp / "state"),
                              prewarm_widths=[1024])
    loop = threading.Thread(target=daemon.serve_forever, name="serve-e2e", daemon=True)
    loop.start()
    try:
        _wait(lambda: tlive.server() is not None, 120.0, "live plane")
        url = f"http://127.0.0.1:{tlive.server().port}/jobs"
        snaps = []
        for w in (w1, w2):
            status, snap = _http("POST", url, _raw_cfg(w, history_ledger=ledger))
            assert status == 202, snap
            _wait(lambda: _http("GET", f"{url}/{snap['id']}")[1]["state"] in ("done", "failed"),
                  600.0, snap["id"])
            snaps.append(_http("GET", f"{url}/{snap['id']}")[1])
        listing = _http("GET", url)[1]
    finally:
        daemon.request_stop()
        loop.join(120.0)
    assert not loop.is_alive()
    return {"lib": lib, "src": src, "tmp": tmp, "oneshot": _tree(oneshot),
            "jax": _tree(jax_root), "w": (w1, w2), "snaps": snaps, "listing": listing,
            "daemon": daemon, "ledger": ledger}


def test_served_jobs_complete_with_the_latency_tap(served):
    for snap in served["snaps"]:
        assert snap["state"] == "done", snap
        assert snap["wait_s"] >= 0.0 and snap["first_stage_s"] > 0.0
        assert snap["result"] == {"libraries": {"barcode01": sum(
            served["lib"].true_counts.values())}}
    assert served["listing"]["jobs_done"] == 2 and served["listing"]["queue_depth"] == 0
    assert served["daemon"].warmup_s > 0.0


def test_served_jobs_write_the_one_shot_runs_files(served):
    want = _deterministic(served["oneshot"])
    assert len(want) > 40
    for w in served["w"]:
        assert _deterministic(_tree(w)) == want


def test_served_counts_and_fasta_equal_the_jax_one_shot_run(served):
    for w in served["w"]:
        tree = _tree(w)
        for rel in ARTIFACTS:
            assert tree[rel] == served["jax"][rel], rel


def test_served_jobs_build_no_kernel(served):
    for w in served["w"]:
        tele = json.loads((w / "fastq_pass" / "nano_tcr" / "telemetry.json").read_text())
        assert tele["compile"]["count"] == 0, tele["compile"]
        assert tele["analysis"]["compile_cache"]["armed"] is True


def test_served_prewarm_report(served):
    report = served["daemon"].prewarm_report
    fused = [e for e in report["entries"] if e["kind"] == "fused_assign"]
    assert fused and all(e["ok"] and (e["width"], e["batch"]) == (1024, 96) for e in fused)
    pol = [e for e in report["entries"] if e["kind"] == "polisher"]
    assert pol and not pol[0]["ok"]  # poa: no polisher to warm
    assert report["compiled"] == 1 and report["failed"] == 1


def test_served_ledger_splits_warm_up_from_steady_time(served):
    entries, problems = thistory.read_entries(served["ledger"])
    assert problems == []
    serve_entries = [e for e in entries if e["source"] == "serve"]
    assert len(serve_entries) == 2 and len([e for e in entries if e["source"] == "run"]) == 2
    first, second = serve_entries
    assert first["warmup_s"] == served["daemon"].warmup_s and "warmup_s" not in second
    for e in serve_entries:
        assert e["steady_s"] > 0.0 and e["job_id"].startswith("job-")
        assert e["dispatch_first_stage_s"] is not None and e["wait_s"] >= 0.0
        assert e["backend"] == "cpu"


def test_serve_without_a_card_exits_non_zero(tmp_path):
    tmpl = tmp_path / "template.json"
    tmpl.write_text(json.dumps(_BASE))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TCR_CONSENSUS_FORCE_CPU")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "ont_tcrconsensus_tpu_torch", "serve",
                           str(tmpl), "--port", "0", "--state-dir", str(tmp_path / "s")],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "s" / tdaemon.SERVE_INFO_BASENAME).exists()


def test_sigterm_drains_a_serve_process_and_a_restart_completes_it(served, monkeypatch):
    """A ``serve --cpu`` process gets SIGTERM while its job runs: exit 143,
    the job journaled with ``resume: true``; a restarted daemon completes
    it to the one-shot run's counts CSV and merged FASTA."""
    tmp = served["tmp"]
    root = _stage(served["src"], tmp / "sigterm")
    state = tmp / "sigterm_state"
    tmpl = tmp / "sigterm_template.json"
    tmpl.write_text(json.dumps(_raw_cfg(root)))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TCR_CHAOS")}
    env["PYTHONPATH"] = REPO
    log = tmp / "sigterm_daemon.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ont_tcrconsensus_tpu_torch", "serve", str(tmpl),
             "--port", "0", "--state-dir", str(state), "--cpu", "--no-prewarm"],
            stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    try:
        info = state / tdaemon.SERVE_INFO_BASENAME
        _wait(info.exists, 120.0, "serve_info.json")
        url = f"http://127.0.0.1:{json.loads(info.read_text())['port']}/jobs"
        status, snap = _http("POST", url, _raw_cfg(root))
        assert status == 202, snap
        _wait(lambda: _http("GET", f"{url}/{snap['id']}")[1].get("first_stage_s") is not None,
              120.0, "the job's first stage")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 143, log.read_text()[-3000:]
    journal = json.loads((state / tqueue.JOURNAL_BASENAME).read_text())
    assert [(j["id"], j["state"], j["raw"]["resume"]) for j in journal["jobs"]] == \
        [(snap["id"], "requeued", True)]
    flight = json.loads((state / "logs" / "flight_recorder.json").read_text())
    assert flight["reason"] == "serve_drain"

    daemon = PORT.make_daemon(_raw_cfg(root), str(state), do_prewarm=False)
    loop = threading.Thread(target=daemon.serve_forever, name="serve-restart", daemon=True)
    loop.start()
    try:
        _wait(lambda: daemon.jobs_snapshot()["jobs_done"] == 1, 600.0, "the resumed job")
        assert [j["state"] for j in daemon.jobs_snapshot()["jobs"]] == ["done"]
    finally:
        daemon.request_stop()
        loop.join(120.0)
    assert not (state / tqueue.JOURNAL_BASENAME).exists()
    tree = _tree(root)
    for rel in ARTIFACTS:
        assert tree[rel] == served["oneshot"][rel], rel
