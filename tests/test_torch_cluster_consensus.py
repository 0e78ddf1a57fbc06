"""UMI clustering, subread selection and vote consensus: the PyTorch port
against the JAX package on the same seeded inputs. Every output here is
integer or string, so all must be equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import noisy_copy, pack  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    from ont_tcrconsensus_tpu.cluster import umi as jumi
    from ont_tcrconsensus_tpu.ops import consensus as jconsensus
    from ont_tcrconsensus_tpu.ops import edit_distance as jed
    from ont_tcrconsensus_tpu.pipeline import stages as jstages
except ImportError:
    jumi = jconsensus = jed = jstages = None
from ont_tcrconsensus_tpu_torch.cluster import umi  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import simulator  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import consensus, edit_distance  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import stages  # noqa: E402

UMI_PATTERN = "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT" + "AAABBBBAABBBBAABBBBAABBBBAABBAAA"


def _t(x):
    return torch.from_numpy(np.array(x))


def _umi_groups(seed: int, n_groups: int, molecules: tuple[int, int], reads: tuple[int, int]):
    """Per group, records of noisy copies of molecule UMIs: mostly 0-2
    edits, some 4-6 (the rescue's sub-threshold fragments), both strands."""
    rng = np.random.default_rng(seed)
    groups = []
    for g in range(n_groups):
        recs = []
        for m in range(int(rng.integers(*molecules))):
            true = simulator.instantiate_iupac(rng, UMI_PATTERN)
            for r in range(int(rng.integers(*reads))):
                s = list(true)
                for _ in range(int(rng.choice([0, 0, 1, 2, 5]))):
                    p = int(rng.integers(len(s)))
                    op = int(rng.integers(3))
                    if op == 0:
                        s[p] = "ACGT"[int(rng.integers(4))]
                    elif op == 1:
                        del s[p]
                    else:
                        s.insert(p, "ACGT"[int(rng.integers(4))])
                recs.append(dict(
                    name=f"g{g}m{m}r{r}", strand="+-"[int(rng.integers(2))], umi_fwd_dist=0,
                    umi_rev_dist=0, umi_fwd_seq="", umi_rev_seq="", combined="".join(s),
                    block=0, row=len(recs),
                ))
        order = rng.permutation(len(recs))
        groups.append((f"region_cluster{g}", [recs[i] for i in order]))
    return groups


def _summary(result):
    return {
        name: ([(c.cluster_id, [m.name for m in c.members], c.n_fwd, c.n_rev, c.written_fwd,
                 c.written_rev, c.n_found) for c in selected], rows)
        for name, (selected, rows) in result.items()
    }


@pytest.mark.parametrize(
    "seed,n_groups,molecules,reads",
    [(0, 3, (2, 5), (1, 9)),      # full identity matrix (few uniques)
     (1, 4, (10, 14), (4, 9))],   # > 256 uniques: shortlist + merge repair
)
def test_cluster_and_select_grouped_matches_jax(seed, n_groups, molecules, reads):
    groups = _umi_groups(seed, n_groups, molecules, reads)
    kw = dict(identity=0.93, min_umi_length=58, max_umi_length=68, min_reads_per_cluster=4,
              max_reads_per_cluster=6, balance_strands=False)
    want = jstages.cluster_and_select_grouped(
        [(n, [jstages.UmiRecord(**r) for r in recs]) for n, recs in groups], **kw)
    got = stages.cluster_and_select_grouped(
        [(n, [stages.UmiRecord(**r) for r in recs]) for n, recs in groups], device="cpu", **kw)
    assert _summary(got) == _summary(want)
    assert sum(len(s) for s, _ in got.values()) > 0


def test_cluster_umis_grouped_labels_match_jax():
    groups = [[r["combined"] for r in recs] for _, recs in _umi_groups(2, 3, (3, 6), (2, 7))]
    want = jumi.cluster_umis_grouped(groups, 0.93)
    got = umi.cluster_umis_grouped(groups, 0.93, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.centroid_of, w.centroid_of)
        assert g.num_clusters == w.num_clusters


@pytest.mark.parametrize("k_end", (8, 16))
def test_dovetail_distances_match_jax(k_end):
    rng = np.random.default_rng(k_end)
    rows_a, rows_b = [], []
    for _ in range(48):
        a = rng.integers(0, 4, int(rng.integers(0, 70))).astype(np.uint8)
        rows_a.append(a)
        rows_b.append(noisy_copy(rng, a, 0.1) if rng.random() < 0.7
                      else rng.integers(0, 4, int(rng.integers(0, 70))).astype(np.uint8))
    a, al = pack(rows_a, 128)
    b, bl = pack(rows_b, 128)
    want = jed.pairwise_dovetail(a, al, b, bl, k_end=k_end)
    got = edit_distance.pairwise_dovetail(_t(a), _t(al), _t(b), _t(bl), k_end=k_end)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_m = jed.many_vs_many_dovetail(a[:12], al[:12], b[:10], bl[:10], k_end=k_end)
    got_m = edit_distance.many_vs_many_dovetail(_t(a[:12]), _t(al[:12]), _t(b[:10]),
                                                _t(bl[:10]), k_end=k_end)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def _cluster_tile(seed: int, C: int, S: int, W: int, err: float):
    """(C, S, W) subreads: noisy copies of one template per cluster, with
    padded subread slots and one empty cluster."""
    rng = np.random.default_rng(seed)
    subs, lens = [], []
    for c in range(C):
        tpl = rng.integers(0, 4, int(rng.integers(W // 2, W - 140))).astype(np.uint8)
        tpl[30:38] = c % 4  # a homopolymer run
        n = 0 if c == C - 1 else int(rng.integers(2, S + 1))
        s, sl = pack([noisy_copy(rng, tpl, err) for _ in range(n)], W)
        pad = S - n
        subs.append(np.concatenate([s.reshape(n, W), np.full((pad, W), 5, np.uint8)]))
        lens.append(np.concatenate([sl, np.zeros(pad, np.int32)]))
    return np.stack(subs), np.stack(lens)


@pytest.mark.parametrize("band,W", [(64, 512), (128, 512), (64, 1024)])
def test_consensus_clusters_batch_matches_jax(band, W):
    """At W=1024 both packages run their fused round pairs on the CPU
    (below it, one round a readback); the drafts must be equal."""
    sub, lens = _cluster_tile(band, C=5, S=6, W=W, err=0.08)
    jd, jl = jconsensus.consensus_clusters_batch(sub, lens, rounds=4, band_width=band)
    td, tl = consensus.consensus_clusters_batch(sub, lens, rounds=4, band_width=band,
                                                device="cpu")
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_array_equal(td, np.asarray(jd))
    assert (tl[:-1] > 0).all() and tl[-1] == 0


@pytest.mark.parametrize("W,rounds,keep_pos", [
    (512, 4, True), (512, 4, False), (1024, 4, True), (512, 1, True),
])
def test_kept_final_pileup_matches_jax(W, rounds, keep_pos):
    """Each cluster's pileup from the round its draft stopped changing,
    scattered into full planes (empty clusters uncovered); None on both
    sides when the rounds run out first (one round here). At W=1024 the
    JAX package keeps the pileup of its fused round pairs."""
    sub, lens = _cluster_tile(20 + rounds, C=5, S=6, W=W, err=0.08)
    jd, jl, jp = jconsensus.consensus_clusters_batch(
        sub, lens, rounds=rounds, band_width=64, keep_final_pileup=True, keep_pos=keep_pos)
    td, tl, tp = consensus.consensus_clusters_batch(
        sub, lens, rounds=rounds, band_width=64, keep_final_pileup=True, keep_pos=keep_pos,
        device="cpu")
    np.testing.assert_array_equal(td, np.asarray(jd))
    np.testing.assert_array_equal(tl, np.asarray(jl))
    if rounds == 1:
        assert jp is None and tp is None
        return
    assert jp is not None and tp is not None
    for name, t, j in zip(("base_at", "ins_cnt", "ins_base"), tp, jp):
        assert t.dtype == {"base_at": torch.uint8, "ins_cnt": torch.int32,
                           "ins_base": torch.uint8}[name]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    if keep_pos:
        np.testing.assert_array_equal(tp[3].numpy(), np.asarray(jp[3]))
    else:
        assert tp[3] is None and jp[3] is None
    assert (tp[0][-1] == 5).all()  # the empty cluster reads uncovered


def test_vote_columns_batch_matches_jax():
    rng = np.random.default_rng(6)
    C, S, Ld = 4, 7, 96
    base_at = rng.choice([0, 1, 2, 3, 4, 5], p=[.2, .2, .2, .2, .1, .1], size=(C, S, Ld))
    base_at = base_at.astype(np.uint8)
    ins_cnt = (rng.random((C, S, Ld)) < 0.3).astype(np.int32) * rng.integers(1, 3, (C, S, Ld))
    ins_base = rng.integers(0, 4, (C, S, Ld)).astype(np.uint8)
    drafts = rng.integers(0, 4, (C, Ld)).astype(np.uint8)
    dlens = np.array([96, 80, 1, 0], np.int32)
    jd, jl = jconsensus._vote_columns_batch(base_at, ins_cnt, ins_base, drafts, dlens)
    td, tl = consensus.vote_columns_batch(_t(base_at), _t(ins_cnt), _t(ins_base), _t(drafts),
                                          _t(dlens))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for c in range(C):  # slots past each new length are padding on both sides
        np.testing.assert_array_equal(td[c, : tl[c]].numpy(), np.asarray(jd)[c, : tl[c]])


@pytest.mark.gpu
def test_consensus_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B2 has no CPU mode")
    sub, lens = _cluster_tile(7, C=6, S=6, W=1024, err=0.08)
    for band in (64, 128):
        gd, gl = consensus.consensus_clusters_batch(sub, lens, band_width=band, device="cuda")
        cd, cl = consensus.consensus_clusters_batch(sub, lens, band_width=band, device="cpu")
        np.testing.assert_array_equal(gl, cl)
        np.testing.assert_array_equal(gd, cd)


def _polish_inputs(seed: int = 9, n_clusters: int = 6, S: int = 5, L: int = 360):
    """A one-block ReadStore and one group of selected clusters over it."""
    from ont_tcrconsensus_tpu_torch.pipeline.assign import ReadBlock, ReadStore

    rng = np.random.default_rng(seed)
    rows, selected = [], []
    for c in range(n_clusters):
        tpl = rng.integers(0, 4, int(rng.integers(L - 200, L - 20))).astype(np.uint8)
        members = []
        for s in range(S - c % 2):
            members.append(stages.UmiRecord(
                name=f"c{c}s{s}", strand="+", umi_fwd_dist=0, umi_rev_dist=0, umi_fwd_seq="",
                umi_rev_seq="", combined="", block=0, row=len(rows)))
            rows.append(noisy_copy(rng, tpl, 0.06))
        selected.append(stages.SelectedCluster(cluster_id=c, members=members, n_fwd=len(members),
                                               n_rev=0, written_fwd=len(members), written_rev=0,
                                               n_found=len(members)))
    codes, lens = pack(rows, 512)
    n = len(rows)
    zeros = np.zeros(n, np.int32)
    block = ReadBlock(width=512, codes=codes, lens=lens, names=[f"r{i}" for i in range(n)],
                      is_rev=np.zeros(n, bool), region_idx=zeros, blast_id=np.ones(n, np.float32),
                      ref_start=zeros, ref_end=lens.copy(), umi={})
    return ReadStore(blocks=[block]), [("region_cluster0", selected)]


def test_polish_out_of_memory_ladder_gives_the_same_consensus(monkeypatch):
    """An out-of-memory error shrinks the cluster batch from the halved
    budget and requeues the chunk; the consensus does not change."""
    from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel

    store, selected = _polish_inputs()
    want = stages.polish_clusters_all(selected, store, cluster_batch=8, device="cpu")
    real = stages._dispatch_polish_packed
    seen = []

    def flaky(packed, C, **kw):
        seen.append(packed[0].shape[0])
        if packed[0].shape[0] > 2:
            raise torch.cuda.OutOfMemoryError("fake out of memory")
        return real(packed, C, **kw)

    monkeypatch.setattr(stages, "_dispatch_polish_packed", flaky)
    # a budget that first packs each (depth, width) bucket's 3 clusters into 4
    got = stages.polish_clusters_all(selected, store, budget=BudgetModel(hbm_gb=0.04),
                                     device="cpu")
    assert got == want
    assert seen[0] == 4 and seen[-1] == 2  # the ladder shrank, then ran
    by_group, failed = got
    assert failed == {}  # the ladder absorbed the error: no group degraded
    assert all(len(seq) > 0 for _, seq in by_group["region_cluster0"])


def test_polisher_path_through_the_out_of_memory_ladder(monkeypatch):
    """With the polisher (depth-2 pass on, so the v4 features need the
    read positions), the budget and the shrink ladder size the kept
    pileup with its pos_at plane, and the polished consensus does not
    depend on the batch."""
    from ont_tcrconsensus_tpu_torch.models import polisher
    from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel

    store, selected = _polish_inputs(seed=10)
    pol = polisher.make_pipeline_polisher(
        polisher.load_default_params(), low_depth_params=polisher.load_low_depth_params(),
        device="cpu")
    assert pol.wants_v4
    want = stages.polish_clusters_all(selected, store, polisher=pol, cluster_batch=8,
                                      device="cpu")
    asked = []
    real_batch = BudgetModel.cluster_batch

    def recording(self, *args, **kwargs):
        asked.append((kwargs["keep_final_pileup"], kwargs["keep_pos"]))
        return real_batch(self, *args, **kwargs)

    monkeypatch.setattr(BudgetModel, "cluster_batch", recording)
    real = stages._dispatch_polish_packed

    def flaky(packed, C, **kw):
        if packed[0].shape[0] > 2:
            raise torch.cuda.OutOfMemoryError("fake out of memory")
        return real(packed, C, **kw)

    monkeypatch.setattr(stages, "_dispatch_polish_packed", flaky)
    got = stages.polish_clusters_all(selected, store, polisher=pol,
                                     budget=BudgetModel(hbm_gb=0.04), device="cpu")
    assert got == want
    assert len(asked) >= 2 and set(asked) == {(True, True)}  # budget, then the ladder
    vote = stages.polish_clusters_all(selected, store, cluster_batch=8, device="cpu")
    assert got != vote  # the polisher changed a consensus
