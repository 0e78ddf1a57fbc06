"""The port's QC and report layers against the JAX package: the error
profile's cs strings (numpy single-read and batch fills, and the device
path on CPU tensors) equal the JAX package's batch fill and its jitted
device path string for string, degenerate rows and band outliers
included; the artifact writers give the JAX package's bytes on the same
inputs; the contracts in their three modes, the retry classifier and the
robustness report behave as the JAX package's; the overlapped QC worker
gives the serial run's logs, and its failures reach the main thread at the
commit. A ``gpu`` case holds the device path on the card to numpy."""

import json
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the JAX reference; a card machine without JAX runs the gpu case only
    from ont_tcrconsensus_tpu.pipeline import assign as jassign
    from ont_tcrconsensus_tpu.qc import artifacts as jartifacts
    from ont_tcrconsensus_tpu.qc import error_profile as jep
    from ont_tcrconsensus_tpu.qc import timing as jtiming
    from ont_tcrconsensus_tpu.qc import umi_overlap as jumi_overlap
    from ont_tcrconsensus_tpu.robustness import contracts as jcontracts
    from ont_tcrconsensus_tpu.robustness import retry as jretry
except ImportError:
    jassign = jartifacts = jep = jtiming = jumi_overlap = jcontracts = jretry = None
from ont_tcrconsensus_tpu_torch.io.dp_cases import noisy_copy  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import encode  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import assign, overlap, stages  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import run as trun  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc import artifacts, error_profile, umi_overlap  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc.timing import StageTimer  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import contracts, jobscope, retry  # noqa: E402


def cs_inputs(seed: int):
    """Ragged reads with substitutions, deletions and insertions against
    their references (1-400 nt), then the degenerate rows (empty query,
    empty reference) and two band outliers (|n - m| far above the band)."""
    rng = np.random.default_rng(seed)
    queries, refs = [], []
    for _ in range(40):
        m = int(rng.integers(1, 400))
        r = rng.integers(0, 4, size=m).astype(np.uint8)
        out = []
        for base in r:
            roll = rng.random()
            if roll < 0.02:
                out.append(int(rng.integers(0, 4)))  # substitution
            elif roll < 0.04:
                pass  # deletion
            elif roll < 0.06:
                out.extend([int(base), int(rng.integers(0, 4))])  # insertion
            else:
                out.append(int(base))
        if rng.random() < 0.2:  # an N in the query
            out[int(rng.integers(0, len(out)))] = 4
        queries.append(np.array(out, np.uint8))
        refs.append(r)
    queries += [np.zeros(0, np.uint8), np.array([1, 2], np.uint8)]
    refs += [np.array([1, 2, 3], np.uint8), np.zeros(0, np.uint8)]
    queries += [np.array([2], np.uint8), rng.integers(0, 4, 300).astype(np.uint8)]
    refs += [rng.integers(0, 4, 260).astype(np.uint8), np.array([3], np.uint8)]
    return queries, refs


_JAX_CS: dict = {}


def jax_cs(seed: int):
    """The JAX package's strings: its numpy batch fill, and its jitted
    device path (on the CPU backend) in tiles of 16."""
    if seed not in _JAX_CS:
        q, r = cs_inputs(seed)
        batch = jep.banded_cs_batch(q, r)
        assert jep.banded_cs_batch_device(q, r, tile=16) == batch
        _JAX_CS[seed] = batch
    return _JAX_CS[seed]


ROUTES = {
    "single": lambda q, r: [error_profile.banded_cs(a, b) for a, b in zip(q, r)],
    "batch": error_profile.banded_cs_batch,
    "device_tile16": lambda q, r: error_profile.banded_cs_batch_device(q, r, tile=16,
                                                                       device="cpu"),
    "device_tile512": lambda q, r: error_profile.banded_cs_batch_device(q, r, device="cpu"),
}


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("route", ROUTES)
def test_cs_strings_equal_the_jax_package(route, seed):
    q, r = cs_inputs(seed)
    assert ROUTES[route](q, r) == jax_cs(seed)


def test_device_path_stops_when_every_walk_ended():
    """The traceback stops at the first check after every walk ended, not
    at N + M steps, and the strings do not change."""
    q, r = cs_inputs(9)
    calls = []
    real = error_profile._device_cs_core

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((out[0].shape[0], args[0].shape[1] + args[1].shape[1]))
        return out

    error_profile._device_cs_core = spy
    try:
        got = error_profile.banded_cs_batch_device(q, r, device="cpu")
    finally:
        error_profile._device_cs_core = real
    assert got == error_profile.banded_cs_batch(q, r)
    assert calls and all(steps < n_plus_m for steps, n_plus_m in calls)


# -- the profile over a read store ----------------------------------------


def _store_and_panel(seed: int = 3, n_reads: int = 40):
    """A two-block store of reads aligned to spans of three references,
    some reverse-strand, some with a NaN blast id (synthesized rows)."""
    rng = np.random.default_rng(seed)
    ref_seqs = [rng.integers(0, 4, int(rng.integers(300, 400))).astype(np.uint8)
                for _ in range(3)]
    panel_codes = np.full((3, 512), encode.PAD_CODE, np.uint8)
    for i, s in enumerate(ref_seqs):
        panel_codes[i, : len(s)] = s
    panel = types.SimpleNamespace(codes=panel_codes, names=["TCR_a", "TCR_b", "TCR_c"])
    blocks = []
    for width, n in ((512, n_reads // 2), (1024, n_reads - n_reads // 2)):
        codes = np.full((n, width), encode.PAD_CODE, np.uint8)
        lens = np.zeros(n, np.int32)
        ridx = rng.integers(0, 3, n).astype(np.int32)
        starts = np.zeros(n, np.int32)
        ends = np.zeros(n, np.int32)
        is_rev = rng.random(n) < 0.4
        for k in range(n):
            ref = ref_seqs[ridx[k]]
            s = int(rng.integers(0, 20))
            e = len(ref) - int(rng.integers(0, 20))
            read = noisy_copy(rng, ref[s:e], 0.05)
            if is_rev[k]:
                read = encode.revcomp_codes(read)
            codes[k, : len(read)] = read
            lens[k], starts[k], ends[k] = len(read), s, e
        blast = np.round(rng.uniform(0.9, 1.0, n), 3).astype(np.float32)
        blast[rng.random(n) < 0.3] = np.nan
        blocks.append(assign.ReadBlock(
            width=width, codes=codes, lens=lens, names=[f"r{i}" for i in range(n)],
            is_rev=is_rev, region_idx=ridx, blast_id=blast, ref_start=starts, ref_end=ends,
            umi={}))
    return assign.ReadStore(blocks=blocks), panel


def test_profile_store_and_its_log_equal_the_jax_package(tmp_path):
    store, panel = _store_and_panel()
    got = error_profile.profile_store(store, panel, sample_size=25, seed=4, chunk=8,
                                      device="cpu")
    want = jep.profile_store(store, panel, sample_size=25, seed=4, chunk=8)
    assert got == want
    error_profile.write_error_profile_log(*got, str(tmp_path / "port.log"))
    jep.write_error_profile_log(*want, str(tmp_path / "jax.log"))
    assert (tmp_path / "port.log").read_bytes() == (tmp_path / "jax.log").read_bytes()


def test_profile_store_device_path_on_cpu_tensors_gives_the_same_counters(monkeypatch):
    """The route profile_store takes on the card, run on CPU tensors."""
    store, panel = _store_and_panel(seed=5)
    want = error_profile.profile_store(store, panel, sample_size=30, device="cpu")
    real = error_profile.banded_cs_batch_device
    monkeypatch.setattr(error_profile, "banded_cs_batch",
                        lambda q, r: real(q, r, tile=16, device="cpu"))
    assert error_profile.profile_store(store, panel, sample_size=30, device="cpu") == want


# -- artifact writers -----------------------------------------------------


def _qc_rows():
    return [
        {"name": "rc0_cluster0_8", "region": "TCR1", "ref_span": 1500, "read_len": 1600,
         "region_len": 1500, "blast_id": 0.999, "status": "pass"},
        {"name": "rc0_cluster1_5", "region": "TCR1", "ref_span": 1200, "read_len": 1600,
         "region_len": 1500, "blast_id": 0.99, "status": "short", "nt_short": 225.0},
        {"name": "rc1_cluster0_4", "region": "TCR2", "ref_span": 1500, "read_len": 3400,
         "region_len": 1500, "blast_id": 0.99, "status": "long", "nt_long": 1743.0},
        {"name": "rc1_cluster2_6", "region": "TCR2", "ref_span": 1510, "read_len": 1610,
         "region_len": 1500, "blast_id": 0.97, "status": "low_blast_id"},
    ]


def _align_stats(mod):
    stats = mod.AlignStats(n_total=100, n_ee_fail=5, n_trimmed=90, n_aligned=92,
                           n_short=2, n_long=1, n_low_blast=3, n_pass=86)
    stats.pre_filter.update(np.array([100, 200, 300]), np.array([10.0, 12.5, 14.25]))
    stats.post_filter.update(np.array([200, 300]), np.array([12.5, 14.25]))
    return stats


def _write_consensus_filter(pkg, out_dir, _mod):
    pkg.write_consensus_filter_artifacts(
        _qc_rows(), {"TCR1": 1500, "TCR2": 1480, "TCR3_v_n": 900}, str(out_dir),
        "merged_consensus", blast_id_threshold=0.995, minimal_region_overlap=0.95)


def _write_region_split(pkg, out_dir, mod):
    blocks = [types.SimpleNamespace(region_idx=np.array([0, 0, 2, 1, 2], np.int32)),
              types.SimpleNamespace(region_idx=np.array([2, 2], np.int32))]
    groups = {0: [(0, np.array([0, 1]))], 1: [(0, np.array([2, 4])), (1, np.array([0, 1]))]}
    pkg.write_region_split_log(
        _align_stats(mod), groups, types.SimpleNamespace(blocks=blocks),
        ["TCR1", "TCR2", "TCR3", "TCR4", "ctl_v_n"],
        {"TCR1": 800, "TCR2": 810, "TCR3": 790, "TCR4": 805, "ctl_v_n": 700},
        ("_v_n", "cdr3j_n", "full_n"), str(out_dir / "split.err"))


def _write_stats_logs(pkg, out_dir, mod):
    stats = _align_stats(mod)
    pkg.write_fastq_stats_log(stats, str(out_dir / "fastq_stats.log"))
    pkg.write_flagstat_log(stats, str(out_dir / "flagstat.log"))
    pkg.write_flagstat_log(mod.AlignStats(), str(out_dir / "flagstat_empty.log"))


def _write_self_homology(pkg, out_dir, _mod):
    pkg.write_self_homology_log({"num_pairs_prefilter": 12, "median_blast_id": 0.91,
                                 "q925_blast_id": 0.95, "q950_blast_id": 0.96,
                                 "q975_blast_id": 0.97, "q990_blast_id": 0.985,
                                 "max_blast_id": 0.99}, str(out_dir / "homology.log"))
    pkg.write_self_homology_log({}, str(out_dir / "homology_empty.log"))


WRITERS = {
    "consensus_filter": _write_consensus_filter,
    "region_split": _write_region_split,
    "fastq_stats_and_flagstat": _write_stats_logs,
    "self_homology": _write_self_homology,
}


@pytest.mark.parametrize("writer", WRITERS)
def test_artifact_writers_give_the_jax_bytes(writer, tmp_path):
    for side, pkg, mod in (("port", artifacts, assign), ("jax", jartifacts, jassign)):
        (tmp_path / side).mkdir()
        WRITERS[writer](pkg, tmp_path / side, mod)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_umi_overlap_audit_gives_the_jax_bytes(tmp_path):
    region_umis = {"TCR1": ["AAC", "AAC", "GGT"], "TCR2": ["AAC", "TTT"], "TCR3": ["AAC"],
                   "TCR4": ["CCC"]}
    outs = {}
    for side, pkg in (("port", umi_overlap), ("jax", jumi_overlap)):
        (tmp_path / side).mkdir()
        outs[side] = pkg.count_overlapping_umis(region_umis, str(tmp_path / side))
    assert outs["port"] == outs["jax"]
    for name in ("regions_w_overlapping_umis.tsv", "region_region_umi_comparison.stderr"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_stage_timing_table_matches_the_jax_format(tmp_path):
    port, jax = StageTimer(), jtiming.StageTimer()
    for timer in (port, jax):
        for name, s in (("round1_polish", 3.25), ("round1_fused_assign", 1.5),
                        ("round1_polish", 0.5), ("round1_error_profile_bg", 2.0)):
            timer.add(name, s)
        timer.write_tsv(str(tmp_path / f"{type(timer).__module__.split('.')[0]}.tsv"))
    assert dict(port.seconds) == dict(jax.seconds) and dict(port.calls) == dict(jax.calls)
    files = sorted(tmp_path.iterdir())
    assert len(files) == 2 and files[0].read_bytes() == files[1].read_bytes()


# -- contracts, retry, the report -----------------------------------------


def _exercise_contracts(mod, mode: str):
    mod.set_mode(mode)
    mod.reset()
    held = [mod.check_equal("ingest", "a", 3, "b", 3),
            mod.check_equal("umi", "a", 2, "b", 2, detail={"group": "g"})]
    raised = None
    try:
        held.append(mod.check_equal("counts", "csv", {"x": 1}, "memory", {"x": 2}))
    except Exception as exc:  # strict
        raised = type(exc).__name__
    return held, raised, mod.summary()


@pytest.mark.parametrize("mode", ["warn", "strict", "off"])
def test_contract_modes_behave_as_the_jax_package(mode):
    rec = retry.recorder()
    rec.reset()
    try:
        got = _exercise_contracts(contracts, mode)
        sites = [e["site"] for e in rec.events]
        want = _exercise_contracts(jcontracts, mode)
    finally:
        for mod, rec_mod in ((contracts, retry), (jcontracts, jretry)):
            mod.set_mode("warn")
            mod.reset()
            rec_mod.recorder().reset()
    assert got == want
    held, raised, summary = got
    assert summary["mode"] == mode
    if mode == "off":
        assert summary["checked"] == {} and held == [True, True, True]
    else:
        assert summary["checked"] == {"ingest": 1, "umi": 1, "counts": 1}
        assert summary["violated"] == {"counts": 1}
        assert raised == ("ContractViolation" if mode == "strict" else None)
        assert sites == ["contracts.counts"]


def test_a_job_scope_keeps_its_own_contracts_and_recorder():
    """A thread inside a job scope binds its own contract counters and
    recorder; the process-wide ones do not see them."""
    contracts.set_mode("warn")
    contracts.reset()
    retry.recorder().reset()
    seen = []

    def job():
        jobscope.enter()
        try:
            contracts.set_mode("strict")
            contracts.reset()
            contracts.check_equal("umi", "a", 1, "b", 1)
            retry.recorder().record("assign.round1", classification="transient",
                                    outcome="retried")
            seen.append((contracts.summary(), len(retry.recorder().events)))
        finally:
            jobscope.exit()

    worker = threading.Thread(target=job)
    worker.start()
    worker.join()
    assert seen == [({"mode": "strict", "checked": {"umi": 1}, "violated": {}}, 1)]
    assert contracts.summary() == {"mode": "warn", "checked": {}, "violated": {}}
    assert retry.recorder().events == []


@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (ConnectionResetError("peer reset"), "transient"),
    (RuntimeError("UNAVAILABLE: socket closed"), "transient"),
    (RuntimeError("DEVICE_LOST: slice 1"), "device_lost"),
    (ValueError("a deterministic bug"), "fatal"),
])
def test_classify_knows_the_cards_errors(exc, want):
    assert retry.classify(exc) == want
    if not isinstance(exc, torch.cuda.OutOfMemoryError) and "CUDA" not in str(exc):
        assert jretry.classify(exc) == want  # the JAX package's on the shared cases


def test_call_with_retry_retries_a_transient_on_the_same_callable():
    rec = retry.RobustnessRecorder()
    calls, resets = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("connection reset by peer")
        return "done"

    pol = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)
    assert retry.call_with_retry("assign.round1", flaky, policy=pol, recorder=rec,
                                 sleep=lambda s: None, reset=lambda: resets.append(1)) == "done"
    assert len(calls) == 3 and len(resets) == 2
    assert [e["outcome"] for e in rec.events] == ["retried", "retried", "recovered"]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        retry.call_with_retry("assign.round2", lambda: (_ for _ in ()).throw(
            torch.cuda.OutOfMemoryError("out of memory")), policy=pol, recorder=rec)
    assert rec.events[-1]["outcome"] == "not_retryable"


def test_report_bytes_equal_the_jax_package(tmp_path):
    """A run with no event: the policy, ``"chaos": null``, the contract
    counters and empty sites and events, as the JAX package writes them."""
    summary = {"mode": "warn", "checked": {"ingest": 2, "counts": 1}, "violated": {}}
    retry.RobustnessRecorder().write(str(tmp_path / "port.json"),
                                     policy=retry.RetryPolicy(max_attempts=4),
                                     contracts=summary)
    jretry.RobustnessRecorder().write(str(tmp_path / "jax.json"),
                                      policy=jretry.RetryPolicy(max_attempts=4),
                                      contracts=summary)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text())["chaos"] is None


def test_polish_dispatch_retries_a_transient_fault(monkeypatch):
    """A transient fault in one chunk's dispatch is retried on the same
    device; the consensus does not change and the report records it."""
    rng = np.random.default_rng(12)
    rows, selected = [], []
    for c in range(3):
        tpl = rng.integers(0, 4, 200).astype(np.uint8)
        members = [stages.UmiRecord(name=f"c{c}s{s}", strand="+", umi_fwd_dist=0,
                                    umi_rev_dist=0, umi_fwd_seq="", umi_rev_seq="",
                                    combined="", block=0, row=len(rows) + s)
                   for s in range(4)]
        rows += [noisy_copy(rng, tpl, 0.05) for _ in members]
        selected.append(stages.SelectedCluster(cluster_id=c, members=members, n_fwd=4,
                                               n_rev=0, written_fwd=4, written_rev=0,
                                               n_found=4))
    codes, lens = encode.pad_batch(rows, pad_to=512, multiple=128)
    n = len(rows)
    zeros = np.zeros(n, np.int32)
    store = assign.ReadStore(blocks=[assign.ReadBlock(
        width=512, codes=codes, lens=lens, names=[f"r{i}" for i in range(n)],
        is_rev=np.zeros(n, bool), region_idx=zeros, blast_id=np.ones(n, np.float32),
        ref_start=zeros, ref_end=lens.copy(), umi={})])
    groups = [("region_cluster0", selected)]
    want = stages.polish_clusters_all(groups, store, cluster_batch=2, device="cpu")
    real = stages._dispatch_polish_packed
    failed = []

    def flaky(packed, C, **kw):
        if not failed:
            failed.append(C)
            raise ConnectionError("connection reset by peer")
        return real(packed, C, **kw)

    monkeypatch.setattr(stages, "_dispatch_polish_packed", flaky)
    rec = retry.recorder()
    rec.reset()
    retry.set_policy(retry.RetryPolicy(base_delay_s=0.0))
    try:
        assert stages.polish_clusters_all(groups, store, cluster_batch=2, device="cpu") == want
    finally:
        retry.set_policy(retry.RetryPolicy())
    assert failed == [2]
    assert [(e["site"], e["outcome"], e["attempt"]) for e in rec.events] == [
        ("polish.dispatch", "retried", 1), ("polish.dispatch", "recovered", 2)]
    rec.reset()


# -- the overlapped QC worker ---------------------------------------------


def test_a_worker_failure_surfaces_at_commit():
    ex = overlap.StageExecutor()

    def boom():
        raise ValueError("worker died")

    stage = ex.submit("round1_error_profile", boom)
    timer = StageTimer()
    with pytest.raises(ValueError, match="worker died"):
        ex.commit(stage, timer)
    assert set(timer.seconds) == {"round1_error_profile", "round1_error_profile_bg"}
    assert ex.wait_all() == []  # retired: not reported a second time


def test_wait_all_drains_without_raising():
    ex = overlap.StageExecutor(max_in_flight=2)
    gate = threading.Event()
    ex.submit("a", lambda: gate.wait(5))
    ex.submit("b", lambda: (_ for _ in ()).throw(RuntimeError("b failed")))
    gate.set()
    failures = ex.wait_all()
    assert [(n, str(e)) for n, e in failures] == [("b", "b failed")]


@pytest.mark.parametrize("error,outcomes", [
    (ConnectionError("connection reset"), ["retried", "recovered"]),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), ["fatal"]),
])
def test_commit_recomputes_a_transient_worker_failure_and_raises_a_fatal_one(error, outcomes):
    rec = retry.recorder()
    rec.reset()
    main = threading.current_thread()

    def stage_fn(x):
        if threading.current_thread() is not main:
            raise error
        return x * 2

    ex = overlap.StageExecutor()
    committed = []
    pending = [(ex.submit("round2_error_profile", stage_fn, 21), committed.append)]
    timer = StageTimer()
    if outcomes == ["fatal"]:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            trun._commit_pending_qc(ex, pending, timer)
        assert committed == []
    else:
        trun._commit_pending_qc(ex, pending, timer)
        assert committed == [42] and pending == []
    assert [e["site"] for e in rec.events] == ["overlap.worker"] * len(outcomes)
    assert [e["outcome"] for e in rec.events] == outcomes
    rec.reset()


def _tiny_lane(root, knobs):
    from ont_tcrconsensus_tpu_torch.io import fastx, simulator

    lib = simulator.simulate_library(seed=41, num_regions=2, molecules_per_region=(2, 2),
                                     reads_per_molecule=(5, 6), region_len=(600, 700))
    (root / "fastq_pass" / "barcode01").mkdir(parents=True)
    fastx.write_fasta(str(root / "reference.fa"), lib.reference.items())
    fastx.write_fastq(str(root / "fastq_pass" / "barcode01" / "barcode01.fastq.gz"), lib.reads)
    cfg = trun.RunConfig.from_dict({
        "reference_file": str(root / "reference.fa"), "fastq_pass_dir": str(root / "fastq_pass"),
        "minimal_length": 500, "read_batch_size": 32, "polish_method": "poa",
        "delete_tmp_files": False, "compare_umi_overlap_between_regions": True, **knobs})
    got = trun.run_with_config(cfg, device="cpu")
    assert got["barcode01"] == lib.true_counts
    nano = root / "fastq_pass" / "nano_tcr"
    return {p.relative_to(nano).as_posix(): p.read_bytes()
            for p in sorted(nano.rglob("*")) if p.is_file()}


def test_overlap_qc_on_and_off_write_the_same_artifacts(tmp_path):
    """The worker changes when the profiles run, not what they write; a
    clean lane also holds under ``contracts: strict``. Both runs audit the
    regions' UMI overlap."""
    on = _tiny_lane(tmp_path / "on", {})
    off = _tiny_lane(tmp_path / "off", {"overlap_qc": False, "contracts": "strict"})
    timing = "barcode01/logs/stage_timing.tsv"
    # files of timings: the stage table, the manifest's timestamps, the
    # report's event clocks and the telemetry roll-up with its ledger entry
    skip = {"barcode01/stage_manifest.json", timing, "robustness_report.json",
            "telemetry.json", "history.jsonl"}
    assert set(on) == set(off)
    assert {"telemetry.json", "history.jsonl"} <= set(on)
    assert "barcode01/logs/barcode01_align_error_profile.log" in on
    assert "barcode01/logs/merged_consensus_align_error_profile.log" in on
    assert on["barcode01/logs/regions_w_overlapping_umis.tsv"].startswith(b"region_1\t")
    for rel in sorted(set(on) - skip):
        assert on[rel] == off[rel], rel
    names = {side: sorted(r.split("\t")[0] for r in tree[timing].decode().splitlines()[1:])
             for side, tree in (("on", on), ("off", off))}
    assert {"round1_error_profile_bg", "round2_error_profile_bg"} <= set(names["on"])
    assert set(names["on"]) - set(names["off"]) == {
        "round1_error_profile_bg", "round2_error_profile_bg", "write_region_fastas_bg"}
    reports = {side: json.loads(tree["robustness_report.json"])
               for side, tree in (("on", on), ("off", off))}
    assert reports["on"]["contracts"]["checked"] == reports["off"]["contracts"]["checked"]
    assert reports["off"]["contracts"]["mode"] == "strict"
    assert reports["on"]["events"] == reports["off"]["events"] == []


# -- the card ---------------------------------------------------------------


@pytest.mark.gpu
def test_device_path_on_the_card_equals_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device path's card run")
    q, r = cs_inputs(7)
    assert error_profile.banded_cs_batch_device(q, r, tile=16, device="cuda") == \
        error_profile.banded_cs_batch(q, r)
    store, panel = _store_and_panel()
    assert error_profile.profile_store(store, panel, sample_size=25, device="cuda") == \
        error_profile.profile_store(store, panel, sample_size=25, device="cpu")
