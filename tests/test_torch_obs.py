"""The port's observation layer against the JAX package's: the registry's
``telemetry.json`` body and Prometheus text, the trace collector, the
stage timer, the site vocabulary, the dispatch split, the disarmed plants,
the transfer ledger's sizing and memory reconciler, and a ``telemetry:
full`` lane run in both packages whose ``logs/trace.json`` holds the same
spans on the same thread rows."""

from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu import obs as jobs  # noqa: E402
from ont_tcrconsensus_tpu.obs import device as jdevice  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.obs import trace as jtrace  # noqa: E402
from ont_tcrconsensus_tpu.obs import transfers as jtransfers  # noqa: E402
from ont_tcrconsensus_tpu_torch import obs as tobs  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import device as tdevice  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import trace as ttrace  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import transfers as ttransfers  # noqa: E402

# summary keys that hold clock readings, not results
TIMING_KEYS = ("duration_s", "t_wall_start", "t_mono_start")


def _script(reg) -> None:
    """One sequence of registry calls, the same for both packages."""
    reg.counter_add("assign.batches")
    reg.counter_add("assign.batches", 2)
    reg.counter_add("transfer.d2h", 4096)
    reg.gauge_max("host.rss_bytes", 1000)
    reg.gauge_max("host.rss_bytes", 500)
    reg.gauge_max("device.hbm_bytes_in_use", 7 << 20)
    reg.gauge_set("serve.queue_depth", 3)
    reg.reject_add("queue_full")
    reg.observe("polish.chunk_clusters", 8)
    reg.observe("polish.chunk_clusters", 3)
    reg.stage_add("round1_polish", 1.25)
    reg.stage_add("round1_polish", 0.5)
    reg.stage_add("round1_fused_assign", 2.0)
    reg.dispatch_add("polish.dispatch", dispatches=1, host_s=0.4, block_s=0.1,
                     stage="round1_polish")
    reg.dispatch_add("consensus.get", gets=3, stage="round1_polish")
    reg.dispatch_add("assign.dispatch", dispatches=2, gets=2, host_s=0.2, block_s=0.3,
                     stage="round1_fused_assign")
    reg.compile_add("round1_fused_assign[1024]", 1.5)
    reg.compile_add("<unattributed>", 0.25)
    reg.pool_add("overlap.pool", busy_s=1.0, idle_s=3.0, window_s=2.0, slots=2)
    reg.analysis_set("compile_cache", {"armed": True, "dir": "/cache"})
    reg.transfer_add("assign.dispatch", "d2h", 4096)
    reg.transfer_add("assign.dispatch", "h2d", 1024)
    reg.mesh_slice_set("cuda:0", 1.0)
    reg.mesh_degraded_add("mesh.device_lost")
    reg.slice_tenant_set("cuda:0", "job-1")
    reg.slice_quarantine_add("cuda:0")


def _script_graph(reg) -> None:
    reg.graph_node_declare("round1_polish", inputs=["r1_selected"], outputs=["r1_polished"],
                           units=11)
    reg.graph_node_add("round1_polish", critical_s=1.75)
    reg.graph_node_skip("round2_counts")
    reg.graph_edge_set("r1_polished", "hbm")
    reg.edge_transfer_add("r1_polished", "h2d", 9766, "hbm")
    reg.round_trip_add(128)
    reg.donation_set("r1_polished", "donated", "round1_consensus")
    reg.node_hbm_add("round1_polish", 1 << 20)
    reg.node_hbm_add("round1_consensus", 3 << 20)
    reg.static_hbm_set("round1_polish", 2 << 20)


@pytest.mark.parametrize("graph", [False, True], ids=["imperative", "graph"])
def test_registry_summary_and_prometheus_text_equal_jax(graph):
    regs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        _script(reg)
        if graph:
            _script_graph(reg)
        regs.append(reg)
    j, t = (r.summary() for r in regs)
    for key in TIMING_KEYS:
        assert isinstance(j.pop(key), float) and isinstance(t.pop(key), float)
    assert t == j
    assert ("graph" in t) is graph and ("overlap_pool" in t) is not graph
    j_text, t_text = (
        [ln for ln in r.prometheus_lines() if not ln.startswith("tcr_run_duration_seconds ")]
        for r in regs)
    assert t_text == j_text
    assert len(t_text) == len(regs[1].prometheus_lines()) - 1


def test_site_vocabulary_equals_jax():
    assert tobs.OBS_SITES == jobs.OBS_SITES
    assert tobs.KNOWN_SITES is tobs.OBS_SITES


REQUIRED_PHASES = {"X", "i", "M", "C"}


def validate_trace(payload: dict) -> None:
    """Chrome trace-event schema; spans on one thread nest or are disjoint."""
    assert isinstance(payload.get("traceEvents"), list)
    spans_by_tid: dict[int, list[tuple[float, float]]] = {}
    for ev in payload["traceEvents"]:
        assert ev["ph"] in REQUIRED_PHASES, ev
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str) and ev["name"]
        if ev["ph"] == "M":
            assert ev["name"] == "thread_name" and ev["args"]["name"]
            continue
        assert ev["ts"] >= 0.0, ev
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0, ev
            spans_by_tid.setdefault(ev["tid"], []).append((ev["ts"], ev["dur"]))
        elif ev["ph"] == "i":
            assert ev.get("s") == "t"
    for tid, spans in spans_by_tid.items():
        open_ends: list[float] = []
        for ts, dur in sorted(spans):
            end = ts + dur
            while open_ends and ts >= open_ends[-1] - 0.5:
                open_ends.pop()
            if open_ends:
                assert end <= open_ends[-1] + 0.5, f"tid {tid}: partial overlap"
            open_ends.append(end)


def _drive_trace(trace_mod, col) -> dict:
    with trace_mod.span("round1_polish"):
        with trace_mod.span("round1_umi_cluster"):
            time.sleep(0.002)
        trace_mod.instant("polish.dispatch", args={"outcome": "retried"})
    t = threading.Thread(
        target=lambda: trace_mod.span("round2_umi_cluster").__enter__().__exit__(
            None, None, None),
        name="worker-thread",
    )
    t.start()
    t.join()
    col.add_counter("memory", {"host_rss_bytes": 123})
    return col


def _shape(payload: dict) -> list:
    """Events without their clocks, pids and thread ids."""
    return [(e["ph"], e["name"], e.get("cat"), e.get("s"), sorted(e.get("args", {})))
            for e in payload["traceEvents"]]


def test_trace_events_have_the_jax_structure(tmp_path):
    payloads = []
    for name, mod in (("jax", jtrace), ("port", ttrace)):
        col = mod.arm()
        try:
            _drive_trace(mod, col)
        finally:
            mod.disarm()
        path = tmp_path / f"{name}.json"
        col.write(str(path))
        payloads.append(json.loads(path.read_text()))
    for payload in payloads:
        validate_trace(payload)
    assert _shape(payloads[1]) == _shape(payloads[0])
    assert sorted(payloads[1]["otherData"]) == sorted(payloads[0]["otherData"])
    rows = {e["args"]["name"] for e in payloads[1]["traceEvents"] if e["ph"] == "M"}
    assert "worker-thread" in rows


def test_trace_buffer_cap_drops_and_reports(tmp_path):
    col = ttrace.TraceCollector(max_events=3)
    ttrace._ARMED = col
    try:
        for _ in range(6):
            ttrace.instant("chaos.inject")
    finally:
        ttrace.disarm()
    path = tmp_path / "trace.json"
    col.write(str(path))
    payload = json.loads(path.read_text())
    assert len(payload["traceEvents"]) == 3  # thread row + 2 instants
    assert payload["otherData"]["dropped_events"] == 4
    validate_trace(payload)


def test_stage_timer_and_trace_are_one_measurement():
    from ont_tcrconsensus_tpu_torch.qc.timing import StageTimer

    reg, col = tmetrics.arm(), ttrace.arm()
    try:
        timer = StageTimer(torch.device("cpu"))
        with timer.stage("round1_polish"):
            time.sleep(0.005)
        with pytest.raises(ValueError):
            with timer.stage("round1_polish"):
                raise ValueError("the stage failed")
    finally:
        tmetrics.disarm()
        ttrace.disarm()
    spans = [e for e in col.events if e.get("ph") == "X"]
    assert len(spans) == 2 and timer.calls["round1_polish"] == 2
    assert timer.seconds["round1_polish"] == reg.stages["round1_polish"][0]
    assert sum(e["dur"] for e in spans) == pytest.approx(reg.stages["round1_polish"][0] * 1e6)


def _split(dev_mod, metrics_mod, trace_mod, value):
    reg = metrics_mod.arm()
    try:
        with trace_mod.span("round1_polish"):
            with dev_mod.dispatch("polish.dispatch", bucket="8x1024"):
                out = dev_mod.timed_get("consensus.get", value)
                time.sleep(0.02)
            dev_mod.timed_get("umi.distance", value)
    finally:
        metrics_mod.disarm()
    return reg, out


def test_dispatch_split_credits_nested_gets_to_the_enclosing_frame():
    jreg, jout = _split(jdevice, jmetrics, jtrace, np.arange(8))
    treg, tout = _split(tdevice, tmetrics, ttrace, torch.arange(8))
    np.testing.assert_array_equal(tout, jout)
    assert isinstance(tout, np.ndarray)
    for reg in (jreg, treg):
        poll, get, umi = (reg.dispatch[k] for k in
                          ("polish.dispatch", "consensus.get", "umi.distance"))
        assert poll[:2] == [1, 0] and poll[2] >= 0.015  # host_s owns the sleep
        assert get[:2] == [0, 1] and get[3] == 0.0  # its wait went to the frame
        assert umi[:2] == [0, 1]  # frameless: its own site
        assert set(reg.dispatch_stages) == {"round1_polish"}
    assert {k: v[:2] for k, v in treg.dispatch.items()} == {
        k: v[:2] for k, v in jreg.dispatch.items()}
    assert treg.transfers == jreg.transfers  # the readbacks' d2h bytes


def test_timed_get_returns_host_copies_of_a_tree():
    tree = {"a": torch.arange(3, dtype=torch.int32), "b": (torch.ones(2), 7)}
    out = tdevice.timed_get("assign.dispatch", tree)
    assert isinstance(out["a"], np.ndarray) and out["a"].dtype == np.int32
    assert isinstance(out["b"], tuple) and out["b"][1] == 7
    np.testing.assert_array_equal(out["b"][0], np.ones(2, np.float32))


def test_disarmed_plants_touch_no_registry():
    assert tmetrics._ARMED is None and ttrace._ARMED is None
    tmetrics.counter_add("assign.batches")
    tmetrics.gauge_max("host.rss_bytes", 1.0)
    tmetrics.observe("polish.chunk_clusters", 4)
    tmetrics.pool_add("overlap.pool", busy_s=1.0)
    ttrace.instant("chaos.inject")
    with tdevice.dispatch("polish.dispatch", bucket="8x1024"):
        pass
    tdevice.kernel_built("sw_banded", 1.0, built=True)
    tdevice.finalize_memory([])
    ttransfers.d2h("assign.dispatch", np.arange(4))
    out = tdevice.timed_get("umi.distance", torch.arange(4))
    np.testing.assert_array_equal(out, np.arange(4))
    sentinel = object()  # no registry methods at all
    for mod in (tmetrics, ttrace):
        mod._ARMED = sentinel
        try:
            with pytest.raises(AttributeError):
                if mod is tmetrics:
                    tmetrics.counter_add("assign.batches")
                else:
                    ttrace.instant("chaos.inject")
        finally:
            mod._ARMED = None


def test_kernel_builds_count_and_warm_loads_do_not():
    reg, col = tmetrics.arm(), ttrace.arm()
    try:
        with ttrace.span("round1_fused_assign"):
            with tdevice.dispatch("assign.dispatch", bucket=1024):
                tdevice.kernel_built("sw_banded", 2.5, built=True)
            tdevice.kernel_built("pileup_forward", 0.01, built=False)
    finally:
        tmetrics.disarm()
        ttrace.disarm()
    comp = reg.summary()["compile"]
    assert comp["count"] == 1 and comp["seconds"] == 2.5
    assert list(comp["by_stage"]) == ["round1_fused_assign[1024]"]
    instants = [e for e in col.events if e.get("ph") == "i"]
    assert [e["name"] for e in instants] == ["xla.compile", "xla.compile"]
    assert [e["args"]["built"] for e in instants] == [True, False]


@dataclasses.dataclass
class _Rec:
    codes: np.ndarray
    name: str
    n: int


NBYTES_CASES = [
    np.zeros((3, 5), np.int32),
    {"a": np.ones(4, np.float64), "b": [b"abc", "xyzé", 3, 2.5, True, None]},
    (np.zeros(7, np.uint8), {"nested": {"deep": np.zeros((2, 2), np.int16)}}),
    _Rec(np.zeros(6, np.int64), "r", 1),
    iter([1, 2, 3]),  # never consumed: counts 0
    [[[[[[[[np.zeros(1000)]]]]]]]],  # past the depth limit
]


@pytest.mark.parametrize("value", NBYTES_CASES, ids=range(len(NBYTES_CASES)))
def test_nbytes_of_equals_jax(value):
    assert ttransfers.nbytes_of(value) == jtransfers.nbytes_of(value)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.float32, torch.int64])
def test_nbytes_of_a_tensor_is_its_numpy_copy(dtype):
    t = torch.zeros((3, 17), dtype=dtype)
    assert ttransfers.nbytes_of(t) == jtransfers.nbytes_of(t.numpy()) == t.numel() * t.element_size()
    assert ttransfers.nbytes_of({"x": t, "y": [t[:1]]}) == 4 * t.numel() * t.element_size() // 3


MEMORY_PAYLOADS = [
    {"transfers": {"sites": {}, "edges": {}, "host_round_trip_bytes": 0}},
    {"transfers": {
        "host_round_trip_bytes": 4096,
        "donation": {"r1_polished": {"verdict": "donated", "node": "round1_consensus"},
                     "cons_store": {"verdict": "copied", "node": "round2_umi_records"},
                     "bad": 3},
        "static_hbm_by_node": {"round1_polish": 2 << 20, "round1_fused_assign": 1 << 20,
                               "garbage": "x"},
        "node_hbm": {"round1_polish": {"delta_bytes": 1 << 20, "end_bytes": 5 << 20,
                                       "samples": 1},
                     "round1_fused_assign": {"end_bytes": 1 << 20},
                     "round2_counts": "nope"},
    }},
    {"transfers": {"static_hbm_by_node": {"round1_polish": 1000}}},
    {"transfers": "not an object"},
    {"telemetry": "on"},
    ["not", "a", "dict"],
]


@pytest.mark.parametrize("payload", MEMORY_PAYLOADS, ids=range(len(MEMORY_PAYLOADS)))
def test_analyze_and_render_memory_equal_jax(payload):
    ta, ja = ttransfers.analyze_memory(payload), jtransfers.analyze_memory(payload)
    assert ta == ja
    tl: list[str] = []
    jl: list[str] = []
    ttransfers.render_memory(ta, tl)
    jtransfers.render_memory(ja, jl)
    assert tl == jl


def test_buffer_probe_reads_tensor_storage():
    a = torch.arange(8)
    probe = ttransfers.buffer_probe({"a": a, "view": a[2:]})
    assert probe is not None
    ptrs, non_cpu, deleted = probe
    assert ptrs == {a.untyped_storage().data_ptr()} and not non_cpu and deleted == 0
    assert ttransfers.buffer_probe(np.arange(3)) is None
    # CPU tensors never testify to a donation
    assert ttransfers.donation_verdict(probe, probe) == "unknown"


# ---------------------------------------------------------------------------
# a telemetry: full lane in both packages


@pytest.fixture(scope="module")
def full_runs(tmp_path_factory):
    from ont_tcrconsensus_tpu.io import fastx, simulator
    from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig
    from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

    tmp = tmp_path_factory.mktemp("torch_obs_full")
    lib = simulator.simulate_library(
        seed=23, num_regions=3, molecules_per_region=(2, 3), reads_per_molecule=(5, 7),
        sub_rate=0.006, ins_rate=0.003, del_rate=0.003, region_len=(700, 850),
    )
    nano = {}
    for side in ("jax", "port"):
        root = tmp / side
        (root / "fastq_pass" / "barcode01").mkdir(parents=True)
        fastx.write_fasta(root / "reference.fa", lib.reference.items())
        fastx.write_fastq(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz", lib.reads)
        cfg = {
            "reference_file": str(root / "reference.fa"),
            "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 600,
            "min_reads_per_cluster": 4, "read_batch_size": 64, "polish_method": "poa",
            "delete_tmp_files": False, "telemetry": "full",
        }
        if side == "jax":
            jax_run(JConfig.from_dict(cfg))
        else:
            trun.run_with_config(RunConfig.from_dict(cfg), device="cpu")
        nano[side] = root / "fastq_pass" / "nano_tcr"
    return nano


def _rows_and_spans(payload: dict) -> tuple[set[str], dict[str, str]]:
    """The trace's thread rows, and each span name's row kind. Worker rows
    are named after the first worker that used the thread id, and CPython
    reuses the ids of finished threads, so every ``stage-*`` row is one
    kind."""
    names = {e["tid"]: e["args"]["name"] for e in payload["traceEvents"] if e["ph"] == "M"}

    def kind(tid):
        return "stage-*" if names[tid].startswith("stage-") else names[tid]

    spans: dict[str, str] = {}
    for e in payload["traceEvents"]:
        if e["ph"] == "X":
            assert spans.setdefault(e["name"], kind(e["tid"])) == kind(e["tid"]), e["name"]
    return {kind(t) for t in names}, spans


def test_full_lane_trace_has_the_jax_spans_on_the_jax_rows(full_runs):
    payloads = {side: json.loads((nano / "logs" / "trace.json").read_text())
                for side, nano in full_runs.items()}
    for payload in payloads.values():
        validate_trace(payload)
    jrows, jspans = _rows_and_spans(payloads["jax"])
    trows, tspans = _rows_and_spans(payloads["port"])
    assert trows == jrows == {"MainThread", "obs-memory-sampler", "stage-*"}
    assert tspans == jspans
    assert tspans["round1_error_profile_bg"] == "stage-*"
    assert tspans["round1_polish"] == "MainThread"
    # the sampler's counters ride the port's trace too; the device gauge
    # only on the card
    counters = [e for e in payloads["port"]["traceEvents"] if e["ph"] == "C"]
    assert counters and all("hbm_bytes_in_use" not in e["args"] for e in counters)


def test_full_lane_telemetry_names_its_trace_and_the_stage_table(full_runs):
    nano = full_runs["port"]
    tel = json.loads((nano / "telemetry.json").read_text())
    assert tel["telemetry"] == "full" and tel["trace_json"] == "logs/trace.json"
    rows = (nano / "barcode01" / "logs" / "stage_timing.tsv").read_text().splitlines()[1:]
    table = {r.split("\t")[0] for r in rows}
    # the stage table is written inside round2_counts, as in the JAX package
    assert set(tel["stages"]) == table | {"round2_counts"}
    trace = json.loads((nano / "logs" / "trace.json").read_text())
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"} == set(tel["stages"])
    assert "device.hbm_bytes_in_use" not in tel["gauges"]  # no device gauge on the CPU
    assert tel["gauges"]["host.rss_bytes"] > 0


def test_telemetry_off_writes_no_obs_artifact(full_runs, tmp_path):
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

    src = full_runs["port"].parent.parent
    root = tmp_path / "off"
    root.mkdir()
    shutil.copy(src / "reference.fa", root / "reference.fa")
    (root / "fastq_pass" / "barcode01").mkdir(parents=True)
    shutil.copy(src / "fastq_pass" / "barcode01" / "barcode01.fastq.gz",
                root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz")
    trun.run_with_config(RunConfig.from_dict({
        "reference_file": str(root / "reference.fa"),
        "fastq_pass_dir": str(root / "fastq_pass"), "minimal_length": 600,
        "min_reads_per_cluster": 4, "read_batch_size": 64, "polish_method": "poa",
        "delete_tmp_files": False, "telemetry": "off",
    }), device="cpu")
    off = root / "fastq_pass" / "nano_tcr"
    full = full_runs["port"]
    for name in ("telemetry.json", "history.jsonl", "logs/trace.json"):
        assert not (off / name).exists() and (full / name).exists()
    for rel in ("barcode01/counts/umi_consensus_counts.csv",
                "barcode01/fasta/merged_consensus.fasta", "robustness_report.json"):
        assert (off / rel).read_bytes() == (full / rel).read_bytes()
    assert tmetrics._ARMED is None and ttrace._ARMED is None  # disarmed after the runs


_REPORT_PROBE = r"""
import sys
sys.argv = ["ont_tcrconsensus_tpu_torch", "--report", sys.argv[1]] + sys.argv[2:]
import runpy
try:
    runpy.run_module("ont_tcrconsensus_tpu_torch", run_name="__main__")
    rc = 0
except SystemExit as exc:
    rc = exc.code or 0
bad = sorted(m for m in sys.modules if m == "torch" or m.startswith("torch."))
sys.stderr.write("LOADED:" + ",".join(bad) + "\n")
sys.exit(rc)
"""


@pytest.mark.parametrize("flags", [[], ["--json"], ["--critical-path"], ["--memory"]],
                         ids=["text", "json", "critical-path", "memory"])
def test_report_loads_no_torch_and_renders_as_jax_does(full_runs, flags):
    import os
    import subprocess
    import sys

    from ont_tcrconsensus_tpu.obs import report as jreport

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    target = str(full_runs["port"].parent)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", _REPORT_PROBE, target, *flags],
                         capture_output=True, text=True, env=env, cwd=repo, timeout=120)
    assert "LOADED:\n" in out.stderr, out.stderr[-2000:]
    nano = jreport.resolve_nano_dir(target)
    critical, memory = "--critical-path" in flags, "--memory" in flags
    if "--json" in flags:
        data, rc = jreport.collect_report(nano, critical_path=critical, memory=memory)
        assert json.loads(out.stdout) == json.loads(json.dumps(data))
    else:
        text, rc = jreport.render_report(nano, critical_path=critical, memory=memory)
        assert out.stdout == text
    assert out.returncode == rc


def test_compile_cache_dir_picks_the_kernels_build_directory(tmp_path):
    from ont_tcrconsensus_tpu_torch.ops import _build
    from ont_tcrconsensus_tpu_torch.pipeline import run as trun

    try:
        assert trun.enable_build_cache(None) == {"armed": True, "dir": _build.DEFAULT_BUILD_DIR}
        assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
        assert trun.enable_build_cache(str(tmp_path)) == {"armed": True, "dir": str(tmp_path)}
        assert _build.library_path("sw_banded").startswith(str(tmp_path))
        assert trun.enable_build_cache("off") == {"armed": False, "dir": None}
        assert _build.BUILD_DIR not in (str(tmp_path), _build.DEFAULT_BUILD_DIR)
    finally:
        _build.use_build_dir(_build.DEFAULT_BUILD_DIR)


def test_a_cpu_run_samples_no_card_in_a_process_that_used_one(monkeypatch):
    """The run declares its cards: a CPU run after a card run in one
    process takes no node-boundary memory sample, as the JAX package's CPU
    backend takes none."""
    monkeypatch.setattr(tdevice.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(tdevice.torch.cuda, "device_count", lambda: 1)
    assert tdevice.run_devices() == [tdevice.torch.device("cuda", 0)]
    reg = tmetrics.arm()
    tdevice.set_run_devices([])
    try:
        assert tdevice.run_devices() == []
        ttransfers.node_hbm_boundary("round1_polish")
        assert "node_hbm" not in reg.summary().get("transfers", {})
        assert "memory.reconcile" not in reg.summary()["counters"]
    finally:
        tdevice.set_run_devices(None)
        tmetrics.disarm()
