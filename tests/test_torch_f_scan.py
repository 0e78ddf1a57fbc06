"""The ref-gap F schedule of kernels B1 and B2 (``csrc/dp_common.cuh``),
modelled step for step in numpy and held against the JAX package.

The kernels do not run the JAX package's log2(W) shift-doubling. Each lane
owns NS contiguous band slots and runs R[b] = max(tmp[b], R[b-1] - ext)
(ties kept at b, the nearer origin) over them; a 5-step Kogge-Stone max of
packed keys carries each lane's result to the lanes on its right; across
the warps of a wide band the carries pass through shared memory; and a
second pass over the lane's slots, started from that carry, gives
F[b] = R[b-1] - open - ext with the gap length and the channels of the
origin it came from. :func:`f_scan` is that order, written out with the
kernels' integer packing; the tests hold it to ``_f_cascade`` (values,
four channels, gap length) and, inside a model of kernel B2's row loop, to
the plain forward's planes.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import dp_case  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import pileup  # noqa: E402

try:  # the JAX reference
    import jax.numpy as jnp

    from ont_tcrconsensus_tpu.ops import sw_align as jsw
except ImportError:
    jnp = jsw = None

NEG = -(1 << 24)
GAP_OPEN, GAP_EXT = 4, 2
LANES = 32


def _up(x: np.ndarray, d: int) -> np.ndarray:
    """``__shfl_up_sync(x, d)`` along the last (lane) axis: lanes below d
    keep their own value."""
    return np.concatenate([x[..., :d], x[..., :-d]], axis=-1)


def _at(x: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """``__shfl_sync(x, lane)``: each lane reads x at its own source lane."""
    return np.take_along_axis(x, lane, axis=-1)


def f_scan(tmp, ch, gap_open, gap_ext, ns, nw):
    """The kernels' F schedule over rows ``tmp`` (N, W), W = 32 * ns * nw,
    with channels ``ch`` (C, N, W). Returns F (N, W), its channels (C, N, W)
    (channel 1, the column count, grown by the gap as ``_f_cascade`` does
    when C == 4) and the gap run Fgap (N, W), each as int32."""
    N, W = tmp.shape
    assert W == LANES * ns * nw
    C = ch.shape[0]
    i32 = np.int32
    t = tmp.astype(i32).reshape(N, nw, LANES, ns)
    tc = ch.astype(i32).reshape(C, N, nw, LANES, ns)
    lane = np.arange(LANES, dtype=i32)
    ext = i32(gap_ext)

    # 1. each lane's local carry at its last slot
    lv, lg, lch = t[..., 0].copy(), np.zeros_like(t[..., 0]), tc[..., 0].copy()
    for k in range(1, ns):
        cand = lv - ext
        take = cand > t[..., k]
        lv = np.where(take, cand, t[..., k])
        lg = np.where(take, lg + 1, 0).astype(i32)
        lch = np.where(take, lch, tc[..., k])

    # 2. packed keys, Kogge-Stone max, one more shuffle for the exclusive
    # carry, the winner's gap and channels from its lane
    z = (lv + ext * ns * lane) * 32 + lane
    assert np.abs(z.astype(np.int64)).max() < 2**31
    d = 1
    while d < LANES:
        z = np.maximum(z, _up(z, d))
        d *= 2
    zx = _up(z, 1)
    src = zx & 31
    rv = (zx >> 5) - ext * ns * (lane - 1)
    rg = _at(lg, src) + (lane - 1 - src) * ns
    rch = np.stack([_at(lch[q], src) for q in range(C)]) if C else lch
    # the carry into each warp's first slot: the band's edge for warp 0,
    # else the warps to the left, each at its last slot, nearer ones last
    iv = np.full((N, nw), NEG, i32)
    ig = np.zeros((N, nw), i32)
    ich = np.zeros((C, N, nw), i32)
    if nw > 1:
        zl = z[..., 31]
        sl = zl & 31
        wv = (zl >> 5) - ext * ns * 31
        wg = _at(lg, sl[..., None])[..., 0] + (31 - sl) * ns
        wch = np.stack([_at(lch[q], sl[..., None])[..., 0] for q in range(C)]) if C else ich
        for w in range(1, nw):
            for u in range(w):
                dist = (w - 1 - u) * LANES * ns
                v = wv[:, u] - ext * dist
                take = np.full(N, u == 0) | (v >= iv[:, w])
                iv[:, w] = np.where(take, v, iv[:, w])
                ig[:, w] = np.where(take, wg[:, u] + dist, ig[:, w])
                ich[:, :, w] = np.where(take, wch[:, :, u], ich[:, :, w])
        # lanes to the left inside the warp are nearer: the warp's carry
        # wins only when strictly greater
        dist = lane * ns
        v = iv[..., None] - ext * dist
        take = (lane > 0) & (v > rv)
        rv = np.where(take, v, rv)
        rg = np.where(take, ig[..., None] + dist, rg)
        rch = np.where(take, ich[..., None], rch)
    first = lane == 0
    rv = np.where(first, iv[..., None], rv)
    rg = np.where(first, ig[..., None], rg)
    rch = np.where(first, ich[..., None], rch)

    # 3. F over the lane's slots from that carry
    F = np.empty_like(t)
    Fgap = np.empty_like(t)
    Fch = np.empty_like(tc)
    for k in range(ns):
        F[..., k] = rv - gap_open - ext
        Fgap[..., k] = rg + 1
        Fch[..., k] = rch
        cand = rv - ext
        take = cand > t[..., k]
        rv = np.where(take, cand, t[..., k])
        rg = np.where(take, rg + 1, 0).astype(i32)
        rch = np.where(take, rch, tc[..., k])
    if C == 4:
        Fch[1] += Fgap
    return F.reshape(N, W), Fch.reshape(C, N, W), Fgap.reshape(N, W)


LAYOUTS = [(ns, 1) for ns in (1, 2, 4, 8, 12, 16)] + [(4, nw) for nw in (2, 3, 4)]


def _rows(W: int, seed: int):
    """The tie-heavy rows of ``test_torch_sw``'s cascade test, plus a row
    that is NEG (outside the band) but for a few islands."""
    rng = np.random.default_rng(seed)
    island = np.full(W, NEG, np.int32)
    at = rng.choice(W, size=max(W // 16, 2), replace=False)
    island[at] = rng.integers(0, 30, len(at))
    return [np.zeros(W, np.int32), np.full(W, 7, np.int32),
            (np.arange(W) * -2).astype(np.int32),  # exactly the ext slope
            rng.integers(-4, 5, W).astype(np.int32) * 2, island]


def _assert_matches_cascade(tmp: np.ndarray, ch: np.ndarray, ns: int, nw: int, ext: int):
    W = tmp.shape[0]
    F, Fch, Fgap = f_scan(tmp[None], ch[:, None], GAP_OPEN, ext, ns, nw)
    jF, jch = jsw._f_cascade(jnp.asarray(tmp), jnp.asarray(ch), GAP_OPEN, ext, W)
    np.testing.assert_array_equal(F[0], np.asarray(jF), err_msg="F")
    np.testing.assert_array_equal(Fch[:, 0], np.asarray(jch), err_msg="channels")
    # the gap length: the column channel of a zero-channel cascade
    _, jgap = jsw._f_cascade(jnp.asarray(tmp), jnp.zeros_like(jnp.asarray(ch)), GAP_OPEN, ext, W)
    np.testing.assert_array_equal(Fgap[0], np.asarray(jgap)[1], err_msg="gap")


@pytest.mark.parametrize("ns,nw", LAYOUTS)
def test_f_scan_matches_cascade_on_tie_rows(ns, nw):
    W = LANES * ns * nw
    rng = np.random.default_rng(W + nw)
    for tmp in _rows(W, seed=ns + 10 * nw):
        ch = rng.integers(0, 50, (4, W)).astype(np.int32)
        _assert_matches_cascade(tmp, ch, ns, nw, GAP_EXT)


@settings(max_examples=40, deadline=None)
@given(
    layout=st.sampled_from(LAYOUTS),
    ext=st.sampled_from((0, 1, 2, 3)),
    seed=st.integers(0, 2**31 - 1),
    spread=st.sampled_from((2, 6, 40)),
    neg_share=st.sampled_from((0.0, 0.3, 0.9)),
)
def test_f_scan_matches_cascade_on_drawn_rows(layout, ext, seed, spread, neg_share):
    ns, nw = layout
    W = LANES * ns * nw
    rng = np.random.default_rng(seed)
    tmp = rng.integers(0, spread, W).astype(np.int32) * max(ext, 1)
    tmp[rng.random(W) < neg_share] = NEG
    ch = rng.integers(0, 1000, (4, W)).astype(np.int32)
    _assert_matches_cascade(tmp, ch, ns, nw, ext)


def forward_model(reads, rl, refs, tl, W, match=2, mismatch=4):
    """Kernel B2's row loop in numpy: F by :func:`f_scan`, the per-lane
    running best and its reduction, and the rows after ``rlen + 1`` written
    by the shortcut alone. Returns (best (N, 3), planes (N, L, W) int16)."""
    N, L = reads.shape
    Lr = refs.shape[1]
    c, ns = W // 2, W // LANES
    go = GAP_OPEN + GAP_EXT
    slots = np.arange(W)
    H = np.full((N, W), NEG, np.int32)
    E = H.copy()
    open_fill = NEG - go >= NEG - GAP_EXT
    e_fill = NEG - go if open_fill else NEG - GAP_EXT
    bs = np.zeros((N, LANES), np.int32)
    brow = np.full((N, LANES), -1, np.int32)
    bslot = np.zeros((N, LANES), np.int32)
    planes = np.zeros((N, L, W), np.int32)
    rl = rl[:, None]
    for i in range(L):
        o, e = H - go, E - GAP_EXT
        opened = o >= e
        En = np.concatenate([np.where(opened, o, e)[:, 1:], np.full((N, 1), e_fill)], 1)
        Eo = np.concatenate([opened[:, 1:], np.full((N, 1), open_fill)], 1)
        j = i - c + slots[None]
        valid = (j >= 0) & (j < tl[:, None]) & (i < rl)
        tb = np.where((j >= 0) & (j < Lr), refs[:, np.clip(j[0], 0, Lr - 1)], 5)
        rb = reads[:, i : i + 1].astype(np.int32)
        is_match = (tb == rb) & (rb < 4) & (tb < 4)
        sub = np.where(is_match, match, -mismatch)
        fresh = H < 0
        t = np.where(fresh, 0, H) + sub
        d = np.where(fresh, 4, 0)
        eb = En > t
        t, d = np.where(eb, En, t), np.where(eb, 1, d)
        neg = t < 0
        t, d = np.where(neg, 0, t), np.where(neg, 3, d)
        tmp = np.where(valid, t, NEG).astype(np.int32)
        cell = d | np.where(Eo, 8, 0)
        F, _, Fgap = f_scan(tmp, np.zeros((0, N, W), np.int32), GAP_OPEN, GAP_EXT, ns, 1)
        take_f = F > tmp
        H = np.where(valid, np.where(take_f, F, tmp), NEG).astype(np.int32)
        E = np.where(valid, En, NEG).astype(np.int32)
        cell = cell | np.where(take_f, (Fgap & 0xFF) << 4, 0)
        # past rlen + 1: the fresh-start direction of each cell only
        short = np.where(e_fill > sub, np.where(e_fill < 0, 3, 1), np.where(sub < 0, 3, 4))
        short = short | (8 if open_fill else 0)
        planes[:, i] = np.where(i > rl, short, cell)
        for k in range(ns):  # the lane's slots in order, strict improvement
            h = H[:, slots[k::ns]]
            imp = h > bs
            bs, brow = np.where(imp, h, bs), np.where(imp, i, brow)
            bslot = np.where(imp, slots[k::ns][None], bslot)
    best = np.zeros((N, 3), np.int32)
    for n in range(N):
        s, r, b = max(zip(bs[n], brow[n], bslot[n]), key=lambda x: (x[0], -x[1], -x[2]))
        best[n] = (s, r, b) if s > 0 else (0, -1, 0)
    return best, planes.astype(np.int16)


@pytest.mark.parametrize("W", (64, 128))
@pytest.mark.parametrize("kind", ("noisy", "homopolymer", "repeat", "pad", "zero"))
def test_forward_model_matches_plain_forward(kind, W):
    reads, rl, refs, tl, _ = dp_case(kind, n=5, L=150, W=W, seed=60 + W)
    best, planes = forward_model(reads, rl, refs, tl, W)
    t = (torch.from_numpy(x) for x in (reads, rl, refs, tl))
    best_p, planes_p = pileup._forward_batch(*t, band_width=W)
    np.testing.assert_array_equal(best, best_p.numpy(), err_msg="best")
    np.testing.assert_array_equal(planes, planes_p.numpy(), err_msg="planes")
