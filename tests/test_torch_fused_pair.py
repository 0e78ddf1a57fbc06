"""The port's fused pair of vote rounds (``ops/consensus._pair_program``:
two rounds, their end extensions, overflow and stability flags on the
device, one readback) against the JAX package's ``_fused_pair_fn`` and the
port's round-at-a-time loop, on the CPU: drafts, lengths and the kept
pileup bit for bit, on converge-early, converge-late, empty and
end-erosion clusters; the device end extension against the host one; the
overflow error on both paths; and the ``consensus.get`` readbacks of a call
against the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import simulator as jsim  # noqa: E402
from ont_tcrconsensus_tpu.obs import metrics as jmetrics  # noqa: E402
from ont_tcrconsensus_tpu.ops import consensus as jconsensus  # noqa: E402
from ont_tcrconsensus_tpu.ops import encode as jencode  # noqa: E402
from ont_tcrconsensus_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import consensus  # noqa: E402

PAD = 5
PLANES = ("base_at", "ins_cnt", "ins_base", "pos_at")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain traceback is a loop of small launches: one intra-op
    thread runs it as fast as eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eroded_cluster(rng, W: int, S: int):
    """One cluster whose seed (the lower-median length) lacks both end
    bases of the template the other subreads carry whole: the end
    extension must regrow them."""
    L = W - 150
    t = jencode.encode_seq(jsim._rand_seq(rng, L))
    mid = L // 2

    def edit(seq, n_ins, n_del):
        seq = list(seq)
        for _ in range(n_del):
            del seq[mid]
        for _ in range(n_ins):
            seq.insert(mid, int(rng.integers(0, 4)))
        return np.array(seq, np.uint8)

    # lengths L-1, L (the seed: the template without its end bases, two
    # bases inserted), L+1, L+2: the lower median is the eroded row
    rows = [edit(t, 0, 1), edit(t[1:-1], 2, 0), edit(t, 1, 0), edit(t, 2, 0)]
    sub = np.full((S, W), PAD, np.uint8)
    lens = np.zeros(S, np.int32)
    for i, r in enumerate(rows):
        sub[i, : len(r)], lens[i] = r, len(r)
    return sub, lens


def _tile(seed: int, W: int, C: int = 4, S: int = 4):
    """C clusters of up to S subreads: iid-error copies of a template each
    (some converge in a round, some take three or four at a high error
    rate), one empty cluster and one end-eroded one."""
    rng = np.random.default_rng(seed)
    sub = np.full((C, S, W), PAD, np.uint8)
    lens = np.zeros((C, S), np.int32)
    for c in range(C - 2):
        template = jsim._rand_seq(rng, int(rng.integers(W - 200, W - 140)))
        rates = (0.005, 0.002, 0.002) if c % 2 == 0 else (0.06, 0.03, 0.03)
        for i in range(int(rng.integers(3, S + 1)) if c else S):
            s, _ = jsim.mutate(rng, template, *rates)
            e = jencode.encode_seq(s)[:W]
            sub[c, i, : len(e)], lens[c, i] = e, len(e)
    # cluster C - 2 stays empty
    sub[C - 1], lens[C - 1] = _eroded_cluster(rng, W, S)
    return sub, lens


def _unfused(monkeypatch):
    monkeypatch.setattr(consensus, "_use_fused", lambda *a: False)


def _assert_same(got, want, kept: bool):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]), err_msg="drafts")
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]), err_msg="lens")
    if not kept:
        return
    assert (got[2] is None) == (want[2] is None)
    if want[2] is None:
        return
    for name, g, w in zip(PLANES, got[2], want[2]):
        if g is None or w is None:
            assert g is None and w is None, name
            continue
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _gets(mod, run, *args, **kw) -> tuple:
    """``run``'s result and its ``consensus.get`` readbacks under an armed
    registry of ``mod`` (either package's obs.metrics)."""
    reg = mod.arm()
    try:
        out = run(*args, **kw)
    finally:
        mod.disarm()
    return out, reg.dispatch["consensus.get"][1]


CASES = [(512, 4, True), (512, 3, False), (512, 1, True), (1024, 4, False)]


@pytest.mark.parametrize("W,rounds,keep_pos", CASES)
def test_fused_pair_equals_jax_and_the_unfused_loop(monkeypatch, W, rounds, keep_pos):
    """Port fused = JAX fused = port unfused: drafts, lengths, the kept
    pileup; and the fused call's readbacks are JAX's, one a pair (and one
    for an odd last round)."""
    sub, lens = _tile(W + rounds, W)
    kw = dict(rounds=rounds, band_width=64, keep_final_pileup=True, keep_pos=keep_pos)
    jax_out, jax_gets = _gets(jmetrics, jconsensus.consensus_clusters_batch, sub, lens,
                              force_fused=True, **kw)
    fused, gets = _gets(tmetrics, consensus.consensus_clusters_batch, sub, lens,
                        force_fused=True, device="cpu", **kw)
    with monkeypatch.context() as m:
        _unfused(m)
        plain = consensus.consensus_clusters_batch(sub, lens, device="cpu", **kw)
    _assert_same(fused, jax_out, kept=True)
    _assert_same(plain, fused, kept=True)
    assert gets == jax_gets <= (rounds + 1) // 2
    lens_out = np.asarray(fused[1])
    assert lens_out[-2] == 0 and (np.delete(lens_out, -2) > 0).all()
    if rounds > 1:  # the eroded seed grew back both end bases
        draft, n = np.asarray(fused[0])[-1], lens_out[-1]
        assert draft[0] == sub[-1, 0, 0] and draft[n - 1] == sub[-1, 0, lens[-1, 0] - 1]


def test_fused_pair_without_a_kept_pileup_equals_jax():
    sub, lens = _tile(512 + 3, 512)
    want = jconsensus.consensus_clusters_batch(sub, lens, rounds=3, band_width=64,
                                               force_fused=True)
    got = consensus.consensus_clusters_batch(sub, lens, rounds=3, band_width=64,
                                             force_fused=True, device="cpu")
    assert len(got) == 2
    _assert_same(got, want, kept=False)


def test_unfused_consensus_get_count_equals_jax():
    """Below width 1024 on the CPU neither package fuses: one readback a
    round in both."""
    sub, lens = _tile(512 + 3, 512)
    _, jax_gets = _gets(jmetrics, jconsensus.consensus_clusters_batch, sub, lens, rounds=3,
                        band_width=64)
    _, gets = _gets(tmetrics, consensus.consensus_clusters_batch, sub, lens, rounds=3,
                    band_width=64, device="cpu")
    assert gets == jax_gets > 1


def _span_case(seed: int):
    rng = np.random.default_rng(seed)
    C, S, W = 8, 5, 64
    sub = rng.integers(0, 4, (C, S, W)).astype(np.uint8)
    slens = rng.integers(W // 2, W, (C, S)).astype(np.int32)
    drafts = rng.integers(0, 4, (C, W)).astype(np.uint8)
    dlens = rng.integers(W // 2, W - 1, (C,)).astype(np.int32)
    dlens[5] = W  # at the width cap: no extension
    spans = np.zeros((C, S, 4), np.int32)
    spans[:, :, 0] = rng.integers(0, 3, (C, S))
    spans[:, :, 1] = slens - rng.integers(0, 3, (C, S))
    spans[:, :, 2] = rng.integers(0, 2, (C, S))
    spans[:, :, 3] = dlens[:, None] - rng.integers(0, 2, (C, S))
    # clusters 6 and 7: every subread at both boundaries with a base
    # beyond it, votes tied two against two (A, C left; G, T right): the
    # smaller code wins; in cluster 7 one subread of five has a base
    # beyond the left end: no majority, no left extension
    for c in (6, 7):
        spans[c, :, 0], spans[c, :, 2] = 2, 0
        spans[c, :, 1], spans[c, :, 3] = slens[c] - 1, dlens[c]
    sub[6, :, 1] = [1, 0, 1, 0, 3]
    sub[6, np.arange(S), slens[6] - 1] = [3, 2, 3, 2, 1]
    spans[7, 1:, 0] = 0
    sub[7, 0, 1] = 0
    return sub, slens, drafts, dlens, spans, dlens.copy()


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_extend_ends_device_equals_the_host_extension(seed):
    sub, slens, drafts, dlens, spans, aligned = _span_case(seed)
    want_d, want_l = consensus._extend_ends_batch(drafts.copy(), dlens.copy(), sub, slens,
                                                  spans, aligned)
    jd, jl = jconsensus._extend_ends_batch(drafts.copy(), dlens.copy(), sub, slens, spans,
                                           aligned)
    got_d, got_l = consensus._extend_ends_device(*(torch.from_numpy(x) for x in (
        drafts, dlens, sub, slens, spans, aligned)))
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(want_d, jd)
    assert got_l[5] == 64  # the cap held
    assert got_d[6, 0] == 0 and got_d[6, int(dlens[6]) + 1] == 2  # ties: the smaller code


def _overflowing():
    """Every subread but the seed carries one base more than the seed in
    its middle and stops one base short of its end: the vote splices the
    base in and keeps the uncovered last base, one past the width."""
    rng = np.random.default_rng(5)
    W, S = 256, 5
    seed = rng.integers(0, 4, W).astype(np.uint8)
    longer = np.concatenate([seed[:100], [(seed[100] + 1) % 4], seed[100:-1]]).astype(np.uint8)
    sub = np.stack([longer, longer, seed, longer, longer])[None]
    return sub, np.full((1, S), W, np.int32)


@pytest.mark.parametrize("fused", [True, False])
def test_overflow_raises_on_both_paths(monkeypatch, fused):
    sub, lens = _overflowing()
    with pytest.raises(ValueError, match="grew past the padded width"):
        jconsensus.consensus_clusters_batch(sub, lens, rounds=2, band_width=64,
                                            force_fused=fused)
    if not fused:
        _unfused(monkeypatch)
    with pytest.raises(ValueError, match="grew past the padded width"):
        consensus.consensus_clusters_batch(sub, lens, rounds=2, band_width=64,
                                           force_fused=fused, device="cpu")
