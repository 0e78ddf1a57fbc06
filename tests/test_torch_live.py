"""The port's live plane (``obs/live.py``): the three endpoints on an
ephemeral port while a CPU lane runs, ``/metrics`` text equal to the JAX
package's for the same registry, the SIGUSR1 flight-recorder flush, and
the plane disarmed after the run."""

from __future__ import annotations

import json
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.obs import live as jlive  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.robustness import watchdog as jwatchdog  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import live as tlive  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import watchdog as twatchdog  # noqa: E402

_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r" [0-9eE+.\-]+$"
)


def validate_prometheus(text: str) -> dict[str, int]:
    """Parse an exposition; {family: sample count}."""
    families: dict[str, int] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _PROM_SAMPLE.match(line), f"bad exposition line: {line!r}"
        name = line.split("{", 1)[0].split(" ", 1)[0]
        families[name] = families.get(name, 0) + 1
    return families


def _metrics_text(metrics_mod, live_mod) -> str:
    metrics_mod.arm()
    try:
        metrics_mod.counter_add("assign.batches", 3)
        metrics_mod.gauge_max("host.rss_bytes", 12345.0)
        metrics_mod.gauge_max("device.hbm_bytes_in_use", 9_240_000_000)
        metrics_mod.observe("polish.chunk_clusters", 7)
        metrics_mod.registry().stage_add("round1_polish", 0.25)
        metrics_mod.registry().dispatch_add("polish.dispatch", dispatches=2, host_s=1.5,
                                            block_s=0.25, stage="round1_polish")
        metrics_mod.registry().compile_add("round1_fused_assign[1024]", 2.5)
        metrics_mod.pool_add("overlap.pool", busy_s=1.0, idle_s=0.5, window_s=1.5, slots=2)
        metrics_mod.graph_node_add("round1_polish", critical_s=0.25)
        metrics_mod.mesh_slice_set("cuda:0", 1.0)
        metrics_mod.mesh_degraded_add("mesh.device_lost")
        return live_mod._metrics_text()
    finally:
        metrics_mod.disarm()


def _no_clock(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith("tcr_run_duration_seconds ")]


def test_metrics_text_equals_jax_for_the_same_registry():
    t = _metrics_text(tmetrics, tlive)
    j = _metrics_text(jmetrics, jlive)
    assert _no_clock(t) == _no_clock(j)
    fams = validate_prometheus(t)
    assert fams["tcr_up"] == 1 and fams["tcr_stage_seconds_total"] == 1
    assert 'tcr_counter_total{site="assign.batches"} 3' in t
    # a disarmed registry is still a valid exposition, as in the JAX package
    assert tlive._metrics_text() == jlive._metrics_text()
    assert validate_prometheus(tlive._metrics_text()) == {"tcr_up": 1}


def test_metrics_text_with_an_armed_watchdog_equals_jax():
    texts = []
    for wd_mod, live_mod in ((twatchdog, tlive), (jwatchdog, jlive)):
        wd = wd_mod.Watchdog(base_timeout_s=5.0)  # monitor not started
        wd_mod.activate(wd)
        try:
            with wd.guard("round1_polish", units=4000):
                text = live_mod._metrics_text()
        finally:
            wd_mod.deactivate(wd)
        # the heartbeat age is a clock reading
        texts.append([re.sub(r"(heartbeat_age_seconds\{[^}]*\}) .*", r"\1", ln)
                      for ln in text.splitlines()])
    assert texts[0] == texts[1]
    assert 'tcr_watchdog_hard_deadline_seconds{stage="round1_polish"} 20.0' in texts[0]


def test_sigusr1_hook_flushes_and_restores(tmp_path):
    ring = tlive.FlightRecorder()
    ring.add_instant("polish.dispatch")
    path = tmp_path / "flight_recorder.json"
    ring.set_flush_path(str(path))
    tlive._RING = ring
    hook = tlive.Sigusr1Hook()
    prev = signal.getsignal(signal.SIGUSR1)
    hook.install()
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        hook.restore()
        tlive._RING = None
    rec = json.loads(path.read_text())
    assert rec["reason"] == "sigusr1" and rec["schema"] == jlive.FLIGHT_SCHEMA
    assert [e["name"] for e in rec["events"]][0] == "polish.dispatch"
    assert signal.getsignal(signal.SIGUSR1) == prev


def test_disarmed_live_sites_touch_nothing():
    assert tlive._RING is None and tlive._PROGRESS is None
    tlive.ring_event("flight.flush", {"reason": "x"})
    assert tlive.flush_armed("crash:Nope") is None
    tlive.progress_totals(3)
    tlive.progress_library("barcode01")
    tlive.progress_library_done()
    tlive.configure_eta_priors(["/nowhere.jsonl"], "fp")
    sentinel = object()
    tlive._PROGRESS = sentinel
    try:
        with pytest.raises(AttributeError):
            tlive.progress_library("barcode01")
    finally:
        tlive._PROGRESS = None


def _fetch(url: str) -> tuple[int, str, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type", ""), ""


@pytest.fixture(scope="module")
def live_run(tmp_path_factory):
    """A port lane with ``live_port: 0`` whose round-1 polish waits while a
    probe thread reads the three endpoints and sends SIGUSR1; and the same
    lane with the plane off, for the byte comparison."""
    from ont_tcrconsensus_tpu_torch.io import fastx, simulator
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

    tmp = tmp_path_factory.mktemp("torch_live")
    lib = simulator.simulate_library(seed=41, num_regions=2, molecules_per_region=(2, 2),
                                     reads_per_molecule=(5, 6), region_len=(600, 700))

    def lane(name, **knobs):
        root = tmp / name
        (root / "fastq_pass" / "barcode01").mkdir(parents=True)
        fastx.write_fasta(str(root / "reference.fa"), lib.reference.items())
        fastx.write_fastq(str(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz"),
                          lib.reads)
        trun.run_with_config(RunConfig.from_dict({
            "reference_file": str(root / "reference.fa"),
            "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 500,
            "read_batch_size": 32, "polish_method": "poa", "delete_tmp_files": False,
            **knobs}), device="cpu")
        return root / "fastq_pass" / "nano_tcr"

    in_stage, release = threading.Event(), threading.Event()
    probed: dict[str, object] = {}
    orig = trun.stages.polish_clusters_all

    def gated(*args, **kwargs):
        in_stage.set()
        release.wait(timeout=60.0)
        return orig(*args, **kwargs)

    def probe():
        try:
            if not in_stage.wait(timeout=300.0):
                probed["error"] = "round1_polish never entered"
                return
            srv = tlive.server()
            if srv is None:
                probed["error"] = "live server not armed"
                return
            probed["port"] = srv.port
            base = f"http://127.0.0.1:{srv.port}"
            for route in ("/healthz", "/metrics", "/progress", "/nope"):
                probed[route] = _fetch(base + route)
            os.kill(os.getpid(), signal.SIGUSR1)
            time.sleep(0.5)  # the handler runs on the main thread, in the gated wait
        except Exception as exc:  # surfaced by the consuming tests
            probed["error"] = repr(exc)
        finally:
            release.set()

    t = threading.Thread(target=probe, name="live-probe", daemon=True)
    trun.stages.polish_clusters_all = gated
    try:
        t.start()
        nano_on = lane("on", live_port=0, stage_timeout_s=120)
    finally:
        trun.stages.polish_clusters_all = orig
        release.set()
        t.join(timeout=30.0)
    nano_off = lane("off")
    return nano_on, nano_off, probed


def test_endpoints_serve_mid_run(live_run):
    _, _, probed = live_run
    assert "error" not in probed, probed.get("error")
    status, ctype, body = probed["/healthz"]
    health = json.loads(body)
    assert status == 200 and ctype.startswith("application/json")
    assert health["status"] == "ok" and health["pid"] == os.getpid()
    assert health["watchdog"]["armed"]
    assert [s["stage"] for s in health["watchdog"]["stages"]] == ["round1_polish"]
    assert health["flight_recorder"]["capacity"] == tlive.MAX_RING_EVENTS
    status, ctype, body = probed["/metrics"]
    assert status == 200 and ctype.startswith("text/plain")
    fams = validate_prometheus(body)
    assert fams["tcr_up"] == 1 and fams["tcr_stage_seconds_total"] >= 1
    assert 'tcr_counter_total{site="live.requests"}' in body
    assert 'tcr_dispatch_total{site="assign.dispatch"}' in body
    assert 'tcr_watchdog_hard_deadline_seconds{stage="round1_polish"}' in body
    status, _, body = probed["/progress"]
    prog = json.loads(body)
    assert status == 200 and prog["library"] == "barcode01"
    assert prog["libraries_total"] == 1 and prog["libraries_done"] == 0
    assert probed["/nope"][0] == 404


def test_sigusr1_flushes_the_flight_recorder_without_stopping_the_run(live_run):
    nano_on, _, probed = live_run
    assert "error" not in probed, probed.get("error")
    rec = json.loads((nano_on / "logs" / "flight_recorder.json").read_text())
    assert rec["reason"] == "sigusr1" and rec["pid"] == os.getpid()
    names = {e["name"] for e in rec["events"]}
    assert "round1_fused_assign" in names and "assign.batch" in names  # spans, beats
    assert (nano_on / "barcode01" / "counts" / "umi_consensus_counts.csv").exists()


def test_live_plane_changes_no_output_and_is_disarmed_after(live_run):
    nano_on, nano_off, probed = live_run
    for rel in ("barcode01/counts/umi_consensus_counts.csv",
                "barcode01/fasta/merged_consensus.fasta"):
        assert (nano_on / rel).read_bytes() == (nano_off / rel).read_bytes()
    rep = json.loads((nano_on / "robustness_report.json").read_text())
    assert rep["events"] == []  # the generous deadline never fired
    assert tlive.server() is None and tlive._RING is None and tlive._PROGRESS is None
    assert twatchdog._current() is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{probed['port']}/healthz", timeout=2)


@pytest.mark.parametrize("argv", [
    ["run.json", "--report", "--live-port", "0"],
    ["run.json", "--json"], ["run.json", "--critical-path"], ["run.json", "--memory"],
])
def test_cli_refuses_report_options_on_a_run_and_a_port_on_a_report(argv, capsys):
    from ont_tcrconsensus_tpu_torch.pipeline import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert "option" in capsys.readouterr().err


def test_run_pipeline_live_port_overrides_the_config(tmp_path, monkeypatch):
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun

    cfg_path = tmp_path / "run.json"
    cfg_path.write_text(json.dumps({"reference_file": "r.fa", "fastq_pass_dir": "fq",
                                    "live_port": 8931}))
    seen = []
    monkeypatch.setattr(trun, "run_with_config",
                        lambda cfg, device=None: seen.append((cfg.live_port, device)))
    trun.run_pipeline(str(cfg_path), device="cpu", live_port=0)
    trun.run_pipeline(str(cfg_path), device="cpu")
    assert seen == [(0, "cpu"), (8931, "cpu")]
