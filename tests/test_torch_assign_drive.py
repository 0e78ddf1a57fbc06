"""The port's host/device overlaps against the JAX package's, on the CPU:
``run_assign``'s pipelined drive (a prefetch worker parsing ahead, the
launches on the calling thread, a readback thread consuming in batch
order, two batches' outputs alive at most) and the polish stage's one-slot
pack prefetch (a ``polish-pack`` worker packing chunk N+1 while chunk N
runs). Stores, stats, guard counts and polished consensus equal the JAX
package's; errors of every thread reach the caller; no thread outlives a
normal or failed drive."""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.cluster import regions as jregions  # noqa: E402
from ont_tcrconsensus_tpu.io import fastx as jfastx  # noqa: E402
from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.io import validate as jvalidate  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import assign as jassign  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import stages as jstages  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.assign import ReadBlock as JReadBlock  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.assign import ReadStore as JReadStore  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu_torch import convert  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import dp_cases, fastx, validate  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import assign, stages  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults  # noqa: E402

UMI_FWD = "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT"
UMI_REV = "AAABBBBAABBBBAABBBBAABBBBAABBAAA"
KW = dict(max_ee_rate=0.07, min_len=200, minimal_region_overlap=0.95,
          max_softclip_5_end=81, max_softclip_3_end=76, batch_size=4)
OURS = ("assign-prefetch", "assign-readback", "polish-pack")


def _our_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name.startswith(OURS)]


@pytest.fixture(autouse=True)
def _no_thread_left():
    """No drive leaves a thread behind; one intra-op thread runs the
    plain loops as fast as eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert _our_threads() == []


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """Untrimmed reads of 2 regions (5-6 read batches of 4), both packages'
    engines, the JAX package's store and stats, and the port's default
    drive at depth 2 with each batch's device outputs recorded in order
    (:func:`_replay` serves them to the cheaper drives below)."""
    lib = jsim.simulate_library(
        seed=21, num_regions=2, molecules_per_region=(2, 3), reads_per_molecule=(4, 6),
        sub_rate=0.01, ins_rate=0.004, del_rate=0.004, region_len=(260, 300),
        with_adapters=True,
    )
    homology = jregions.self_homology_map(lib.reference, 0.93)
    jpanel = jassign.ReferencePanel.build(lib.reference, homology.region_cluster)
    tpanel = convert.panel_from_numpy(
        jpanel.codes, jpanel.lens, jpanel.profiles, jpanel.names, jpanel.region_cluster,
        device="cpu", seqs=jpanel.seqs,
    )
    path = tmp_path_factory.mktemp("drive") / "reads.fastq.gz"
    jfastx.write_fastq(path, lib.reads)
    primers = JConfig(reference_file="r", fastq_pass_dir="f").primer_sequences()
    je = jassign.AssignEngine(jpanel, UMI_FWD, UMI_REV, primers=primers)
    te = assign.AssignEngine(tpanel, UMI_FWD, UMI_REV, primers=primers, device="cpu")
    want = jassign.run_assign(str(path), je, **KW)
    outs = []
    real = te.run_batch_async

    def recording(*args, **kwargs):
        outs.append(real(*args, **kwargs))
        return outs[-1]

    te.run_batch_async = recording
    try:
        got = assign.run_assign(str(path), te, prefetch_depth=2, **KW)
    finally:
        del te.run_batch_async
    return lib, path, je, te, want, got, outs


def _replay(outs, calls=None, fail_at=None):
    """A ``dispatch=`` that serves the recorded outputs in order (raising
    at call ``fail_at``), appending each call's thread name to ``calls``."""
    served = []

    def dispatch(batch, max_ee_rate, min_len):
        if calls is not None:
            calls.append(threading.current_thread().name)
        if len(served) + 1 == fail_at:
            raise ValueError("dispatch failed")
        served.append(1)
        return outs[len(served) - 1]

    return dispatch


def _assert_same_store(got, want):
    (tstore, tstats), (jstore, jstats) = got, want
    for f in dataclasses.fields(tstats):
        a, b = getattr(tstats, f.name), getattr(jstats, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert len(tstore.blocks) == len(jstore.blocks)
    for tb, jb in zip(tstore.blocks, jstore.blocks):
        assert tb.width == jb.width and tb.names == jb.names
        for f in ("codes", "lens", "is_rev", "region_idx", "ref_start", "ref_end", "quals",
                  "sw_done"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
        np.testing.assert_allclose(tb.blast_id, jb.blast_id, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("depth", [1, 2])
def test_run_assign_equals_jax_at_each_prefetch_depth(lane, depth):
    """Depth 2 is the fixture's default drive; depth 1 serves its outputs
    through the engine's own call again."""
    _, path, _, te, want, got, outs = lane
    if depth == 1:
        replay = _replay(outs)
        te.run_batch_async = lambda batch, max_ee_rate, min_len, **_: replay(
            batch, max_ee_rate, min_len)
        try:
            got = assign.run_assign(str(path), te, prefetch_depth=1, **KW)
        finally:
            del te.run_batch_async
    assert len(outs) >= 5 and got[1].n_pass > 0
    _assert_same_store(got, want)


def test_a_record_iterable_through_a_dispatch_override(lane):
    """Round 2's shape: a record iterable and a ``dispatch=`` override
    (launched on the calling thread) give the path's store."""
    _, path, _, te, want, _, outs = lane
    calls = []
    got = assign.run_assign(list(fastx.read_fastx(str(path))), te,
                            dispatch=_replay(outs, calls), **KW)
    _assert_same_store(got, want)
    assert len(calls) == len(outs) and set(calls) == {threading.current_thread().name}


def test_an_error_in_consume_reaches_the_caller(lane):
    _, path, _, te, _, _, outs = lane

    class Refusing(list):
        def append(self, row):
            raise RuntimeError("refused QC row")

    with pytest.raises(RuntimeError, match="refused QC row"):
        assign.run_assign(str(path), te, collect_qc=Refusing(), dispatch=_replay(outs), **KW)


def test_an_error_in_the_source_reaches_the_caller(lane):
    _, path, _, te, _, _, outs = lane
    records = list(fastx.read_fastx(str(path)))

    def source():
        yield from records[:10]
        raise OSError("the source broke")

    with pytest.raises(OSError, match="the source broke"):
        assign.run_assign(source(), te, dispatch=_replay(outs), **KW)


def test_a_source_failing_at_its_first_pull_leaves_no_thread(lane, monkeypatch):
    """A path's first chunk is pulled when the batch iterator is built (a
    truncated gzip raises there): the error reaches the caller and no
    readback thread is left waiting (``_no_thread_left`` checks)."""
    _, path, _, te, _, _, outs = lane

    def first_chunk_fails(*args, **kwargs):
        raise ValueError("truncated or corrupt gzip stream")

    monkeypatch.setattr(assign, "_batches_from_source", first_chunk_fails)
    with pytest.raises(ValueError, match="truncated or corrupt gzip"):
        assign.run_assign(str(path), te, dispatch=_replay(outs), **KW)


def test_an_error_in_the_dispatch_reaches_the_caller(lane):
    _, path, _, te, _, _, outs = lane
    with pytest.raises(ValueError, match="dispatch failed"):
        assign.run_assign(str(path), te, dispatch=_replay(outs, fail_at=3), **KW)


def test_live_batches_never_exceed_two(lane, monkeypatch):
    """A slow readback thread: the launches run ahead of it by two
    batches, never three."""
    _, path, _, te, want, _, outs = lane
    read, live = [0], []
    real_get = assign.obs_device.timed_get
    replay = _replay(outs)

    def slow_get(site, value, ready=None):
        time.sleep(0.05)
        out = real_get(site, value, ready=ready)
        read[0] += 1
        return out

    def dispatch(batch, max_ee_rate, min_len):
        live.append(len(live) + 1 - read[0])
        return replay(batch, max_ee_rate, min_len)

    monkeypatch.setattr(assign.obs_device, "timed_get", slow_get)
    got = assign.run_assign(str(path), te, dispatch=dispatch, **KW)
    _assert_same_store(got, want)
    assert max(live) == 2 and read[0] == len(live) == len(outs)


def test_an_abandoned_drive_leaves_the_guard_as_jax_leaves_it(lane, tmp_path):
    """A dispatch that fails at the second batch under a dropping guard:
    once the drive has raised, the guard counts what JAX's counts, and no
    worker adds to it afterwards."""
    lib, _, je, te, _, _, outs = lane
    src = tmp_path / "bad.fastq"
    with open(src, "w") as fh:
        for i, (header, seq, qual) in enumerate(lib.reads):
            if i in (3, 9, 14):
                fh.write(f"@broken{i}\nACGT\n+\nII\n")  # length mismatch
            fh.write(f"@{header}\n{seq}\n+\n{qual}\n")
    n = []

    def jax_dispatch(batch, max_ee_rate, min_len):
        n.append(1)
        if len(n) == 2:
            raise ValueError("dispatch failed")
        return je.run_batch_async(batch, max_ee_rate, min_len)

    guards = {}
    for name, mod, vmod, engine, dispatch in (
            ("jax", jassign, jvalidate, je, jax_dispatch),
            ("port", assign, validate, te, _replay(outs, fail_at=2))):
        guard = vmod.IngestGuard("drop", source=str(src))
        with pytest.raises(ValueError, match="dispatch failed"):
            mod.run_assign(str(src), engine, dispatch=dispatch, guard=guard, **KW)
        first = (guard.n_bad, dict(guard.by_reason))
        time.sleep(0.6)  # longer than a worker's put wait
        assert (guard.n_bad, dict(guard.by_reason)) == first
        guards[name] = first
    assert guards["port"] == guards["jax"] and guards["port"][0] == 3


# ---------------------------------------------------------------------------
# the polish stage's pack prefetch


@pytest.fixture(scope="module")
def polish_case():
    """One group of 6 selected clusters over a one-block store (two depth
    buckets of 3 at width 256), in both packages' types, and the port's
    consensus of them in chunks of 2."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port, jax_side = _polish_inputs()
        got = stages.polish_clusters_all(port[1], port[0], cluster_batch=2, device="cpu")
    finally:
        torch.set_num_threads(n)
    return port, jax_side, got


def _polish_inputs(n_clusters: int = 6, S: int = 3, L: int = 120):
    rng = np.random.default_rng(12)
    rows, selected, jselected = [], [], []
    for c in range(n_clusters):
        tpl = rng.integers(0, 4, int(rng.integers(L // 2, L - 10))).astype(np.uint8)
        members = []
        for s in range(S - c % 2):
            members.append(dict(name=f"c{c}s{s}", strand="+", umi_fwd_dist=0,
                                umi_rev_dist=0, umi_fwd_seq="", umi_rev_seq="", combined="",
                                block=0, row=len(rows)))
            rows.append(dp_cases.noisy_copy(rng, tpl, 0.06))
        n = len(members)
        for mod, out in ((stages, selected), (jstages, jselected)):
            out.append(mod.SelectedCluster(
                cluster_id=c, members=[mod.UmiRecord(**m) for m in members], n_fwd=n,
                n_rev=0, written_fwd=n, written_rev=0, n_found=n))
    codes, lens = dp_cases.pack(rows, 256)
    n = len(rows)
    quals = rng.integers(5, 40, codes.shape).astype(np.uint8)
    zeros = np.zeros(n, np.int32)
    block = dict(width=256, codes=codes, lens=lens, names=[f"r{i}" for i in range(n)],
                 is_rev=np.zeros(n, bool), region_idx=zeros, blast_id=np.ones(n, np.float32),
                 ref_start=zeros, ref_end=lens.copy(), umi={}, quals=quals)
    store = assign.ReadStore(blocks=[assign.ReadBlock(**block)])
    jstore = JReadStore(blocks=[JReadBlock(**block)])
    return (store, [("region_cluster0", selected)]), (jstore, [("region_cluster0", jselected)])


def _counting_packs(monkeypatch):
    packs = []
    real = stages._pack_polish_chunk

    def counting(chunk, *args):
        packs.append((chunk[0][1].cluster_id, threading.current_thread().name))
        return real(chunk, *args)

    monkeypatch.setattr(stages, "_pack_polish_chunk", counting)
    return packs


def test_polish_with_the_packer_equals_jax(polish_case, monkeypatch):
    (store, selected), (jstore, jselected), _ = polish_case
    packs = _counting_packs(monkeypatch)
    got = stages.polish_clusters_all(selected, store, cluster_batch=2, device="cpu")
    want = jstages.polish_clusters_all(jselected, jstore, cluster_batch=2)
    assert got == want
    assert got[1] == {} and len(got[0]["region_cluster0"]) == 6
    # each chunk packed once: the first of its bucket inline, the rest on the worker
    assert sorted(c for c, _ in packs) == sorted({c for c, _ in packs})
    on_worker = [c for c, t in packs if t.startswith("polish-pack")]
    assert len(packs) == 4 and len(on_worker) == 2  # two depth buckets of 3 clusters


@pytest.mark.parametrize("where", ["site", "dispatch"])
def test_a_transient_fault_packs_its_chunk_once(polish_case, monkeypatch, where):
    """A transient fault at the ``polish.dispatch`` site (the second chunk,
    packed on the worker) or raised inside the dispatch after the pack
    (the first chunk, packed inline) retries the chunk on the same tile."""
    (store, selected), _, want = polish_case
    packs = _counting_packs(monkeypatch)
    if where == "site":
        faults.arm([{"site": "polish.dispatch", "kind": "transient", "skip": 1}])
    else:
        real = stages._dispatch_polish_packed
        raised = []

        def flaky(packed, C, **kw):
            if not raised:
                raised.append(1)
                raise faults.TransientChaosError("transient after the pack")
            return real(packed, C, **kw)

        monkeypatch.setattr(stages, "_dispatch_polish_packed", flaky)
    try:
        got = stages.polish_clusters_all(selected, store, cluster_batch=2, device="cpu")
        fired = faults.fired("polish.dispatch") if where == "site" else len(raised)
    finally:
        faults.disarm()
    assert got == want and fired == 1
    clusters = [c for c, _ in packs]
    assert len(clusters) == len(set(clusters)) == 4  # two buckets of 3, in chunks of 2
