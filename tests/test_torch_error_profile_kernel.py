"""Kernel B4 (the QC error profile's DP, ``csrc/error_profile_cs.cu``): a
scalar model written in the kernel's order (one block a read: the
double-buffered shared row, the warp shuffle scan and the warps' totals of
the left chain, the plane row; then lane 0's walk) against the JAX
package's jitted ``_device_cs_core`` on the CPU backend and the port's
plain ``_device_cs_core``, op log for op log up to each walk's stop, and
its cs strings against ``banded_cs_batch``; the tie rules' mutations; the
wrapper's CPU refusal and the CPU dispatch; and, on a card, the kernel
against the plain core. Tolerance: exact."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the JAX reference; a card machine without JAX runs the gpu case only
    import jax.numpy as jnp

    from ont_tcrconsensus_tpu.qc import error_profile as jep
except ImportError:
    jnp = jep = None
from ont_tcrconsensus_tpu_torch.io.dp_cases import noisy_copy  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import cs_kernel  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc import error_profile  # noqa: E402

BIG = 1 << 20
INT_MAX = np.iinfo(np.int32).max
K_MATCH, K_SUB, K_INS, K_DEL, K_STOP = 0, 1, 2, 3, 4
UNWRITTEN = 7  # what the model's scratch plane holds where the fill wrote nothing


def _shfl_up(v: np.ndarray, o: int, wl: np.ndarray) -> np.ndarray:
    """``__shfl_up_sync(v, o)`` over 32-lane warps: lane l gets lane l - o's
    value, a lane with fewer than o lanes to its left in its warp its own."""
    return np.where(wl >= o, np.roll(v, o), v)


def kernel_model(qpad, rpad, n_arr, m_arr, lo_all, ws, w_pad: int,
                 up_wins=np.less, left_wins=np.less):
    """Kernel B4, block by block, in its order. Returns (kind, qb, rb),
    (N + M, L) uint8 with kind STOP past each walk, and the walks' counts
    of band exits and tail insertions. ``up_wins`` and ``left_wins`` are
    the tie rules (strict in the kernel)."""
    L, N = qpad.shape
    M = rpad.shape[1]
    kind = np.full((N + M, L), K_STOP, np.uint8)
    qb = np.zeros((N + M, L), np.uint8)
    rb = np.zeros((N + M, L), np.uint8)
    lanes = np.arange(w_pad, dtype=np.int64)
    wl, warp = lanes & 31, lanes >> 5
    stats: Counter = Counter()
    for b in range(L):
        n, m, w = int(n_arr[b]), int(m_arr[b]), int(ws[b])
        q, r = qpad[b].astype(np.int64), rpad[b].astype(np.int64)
        lo = lo_all[b].astype(np.int64)
        ptr = np.full((N + 1, w_pad), UNWRITTEN, np.uint8)
        rows = np.zeros((2, w_pad), np.int64)
        lane_ok = lanes < w
        js = lo[0] + lanes
        valid = lane_ok & (js <= m)
        rows[0] = np.where(valid, js, BIG)
        ptr[0] = np.where(valid, 2, 0)
        lo_prev = lo[0]
        for i in range(1, n + 1):
            prev = rows[(i - 1) & 1]
            nlo = lo[i]
            src = lanes + (nlo - lo_prev) - 1
            diag = np.where((src >= 0) & (src < w_pad), prev[np.clip(src, 0, w_pad - 1)], BIG)
            up = np.where((src + 1 >= 0) & (src + 1 < w_pad),
                          prev[np.clip(src + 1, 0, w_pad - 1)], BIG)
            js = nlo + lanes
            valid = lane_ok & (js <= m)
            qi = q[i - 1]
            rj = r[np.clip(js - 1, 0, M - 1)]
            sub = np.where((rj == qi) & (qi < 4) & (rj < 4), 0, 1)
            d = np.where(js >= 1, diag + sub, BIG)
            u = up + 1
            best = np.where(valid, np.minimum(d, u), BIG)
            p = np.where(up_wins(u, d), 1, 0)
            v = best - lanes
            for o in (1, 2, 4, 8, 16):
                v = np.where(wl >= o, np.minimum(v, _shfl_up(v, o, wl)), v)
            excl = _shfl_up(v, 1, wl)
            warp_min = v[wl == 31]  # each warp's total, through shared memory
            excl = np.where(wl == 0, INT_MAX, excl)
            for k in range(w_pad // 32):
                excl = np.where(warp > k, np.minimum(excl, warp_min[k]), excl)
            left = np.where(lanes == 0, BIG, excl + lanes)
            take = left_wins(left, best) & valid
            best = np.where(take, left, best)
            p = np.where(take, 2, p)
            rows[i & 1] = np.where(valid, best, BIG)
            ptr[i] = np.where(valid, p, 0)
            lo_prev = nlo
        i, j = n, m
        for s in range(N + M):
            qc, rc = q[max(i - 1, 0)], r[max(j - 1, 0)]
            qb[s, b], rb[s, b] = qc, rc
            t = j - lo[i]
            if (i == 0 and j == 0) or t < 0 or t >= w:
                stats["off_band"] += not (i == 0 and j == 0)
                break
            p = int(ptr[i, t])
            assert p != UNWRITTEN, f"read {b}'s walk read a cell the fill never wrote"
            is_diag = i > 0 and j > 0 and p == 0
            is_up = not is_diag and i > 0 and p == 1
            is_left = not is_diag and not is_up and j > 0
            stats["tail_ins"] += not (is_diag or is_up or is_left)
            if is_diag:
                kind[s, b] = K_MATCH if qc == rc and qc < 4 else K_SUB
            else:
                kind[s, b] = K_DEL if is_left else K_INS
            i -= not is_left
            j -= is_diag or is_left
    return kind, qb, rb, stats


def _stops(kind: np.ndarray) -> np.ndarray:
    """Each read's first STOP row (the log's length when there is none)."""
    stop = kind == K_STOP
    return np.where(stop.any(axis=0), stop.argmax(axis=0), kind.shape[0])


def assert_logs_equal(got, want, label: str) -> None:
    """Op logs equal up to and including each walk's first STOP."""
    gk, gq, gr = (np.asarray(x) for x in got[:3])
    wk, wq, wr = (np.asarray(x) for x in want[:3])
    gs, ws_ = _stops(gk), _stops(wk)
    np.testing.assert_array_equal(gs, ws_, err_msg=f"{label}: walk lengths")
    for b, s in enumerate(gs):
        end = min(s + 1, gk.shape[0], wk.shape[0])
        for name, g, w in (("kind", gk, wk), ("qb", gq, wq), ("rb", gr, wr)):
            np.testing.assert_array_equal(g[:end, b], w[:end, b], err_msg=f"{label}: {name}, read {b}")


def _ragged(rng, k: int):
    """Noisy reads of 1-400 nt (substitutions, deletions, insertions),
    some with N bases in the query or the reference."""
    qs, rs = [], []
    for _ in range(k):
        r = rng.integers(0, 4, int(rng.integers(1, 400))).astype(np.uint8)
        q = noisy_copy(rng, r, 0.08) if len(r) > 1 else r.copy()
        if rng.random() < 0.3 and len(q):
            q[rng.random(len(q)) < 0.05] = 4
        if rng.random() < 0.2:
            r = r.copy()
            r[rng.random(len(r)) < 0.05] = 4
        qs.append(q if len(q) else r[:1].copy())
        rs.append(r)
    return qs, rs


def _leading_insertions(rng, k: int):
    """Queries with 3-12 extra bases before the reference: walks that reach
    j == 0 with i > 0."""
    qs, rs = [], []
    for _ in range(k):
        r = rng.integers(0, 4, int(rng.integers(40, 200))).astype(np.uint8)
        qs.append(np.concatenate([rng.integers(0, 4, int(rng.integers(3, 13))).astype(np.uint8),
                                  noisy_copy(rng, r, 0.03)]))
        rs.append(r)
    return qs, rs


def _far_from_diagonal(rng, k: int):
    """A 55-70 base deletion early and as long an insertion late: equal
    lengths, but the true path runs farther from the interpolated diagonal
    than the band's half (48), so the band's edge shapes the alignment."""
    qs, rs = [], []
    for _ in range(k):
        r = rng.integers(0, 4, int(rng.integers(280, 360))).astype(np.uint8)
        cut = int(rng.integers(55, 71))
        q = np.concatenate([r[:30], r[30 + cut: 230],
                            rng.integers(0, 4, cut).astype(np.uint8), r[230:]])
        qs.append(q)
        rs.append(r)
    return qs, rs


def _wide_bands(rng):
    """|n - m| up to the live cap of 120 (ws 257, w_pad 320), on short
    reads whose band start moves 7-13 positions a row, both ways round."""
    qs, rs = [], []
    for n, m in ((10, 130), (15, 135), (20, 140), (130, 10), (140, 22), (380, 260),
                 (250, 370), (90, 200)):
        long_ = rng.integers(0, 4, max(n, m)).astype(np.uint8)
        short = long_[np.sort(rng.choice(max(n, m), min(n, m), replace=False))]
        q, r = (short, long_) if n < m else (long_, short.copy())
        flip = rng.random(len(r)) < 0.05  # substitutions, lengths kept
        r[flip] = (r[flip] + 1) % 4
        qs.append(q)
        rs.append(r)
    return qs, rs


def _tiles():
    """(label, queries, refs) of each tile, made from seed 13."""
    rng = np.random.default_rng(13)
    ragged = _ragged(rng, 24)
    lead = _leading_insertions(rng, 6)
    far = _far_from_diagonal(rng, 4)
    wide = _wide_bands(rng)
    return {
        # 34 live reads: 30 pad reads fill the tile's 64 rows
        "ragged_n_leading_far": tuple(a + b + c for a, b, c in zip(ragged, lead, far)),
        "wide_bands": wide,
    }


_CACHE: dict = {}


def _cases():
    """Each tile's inputs as banded_cs_batch_device lays them out, with the
    JAX package's op log (its jitted core on the CPU backend)."""
    if not _CACHE:
        for label, (qs, rs) in _tiles().items():
            qs16 = [np.asarray(q, np.int16) for q in qs]
            rs16 = [np.asarray(r, np.int16) for r in rs]
            ns = np.array([len(q) for q in qs]), np.array([len(r) for r in rs])
            halves = np.maximum(48, np.abs(ns[0] - ns[1]) + 8)
            assert (2 * halves + 1 <= 257).all(), "every read is live (no band outlier)"
            *arrays, w_pad = error_profile._tile_inputs(qs16, rs16, list(range(len(qs))), halves)
            want = [np.asarray(x) for x in jep._device_cs_core(
                *(jnp.asarray(a) for a in arrays), w_pad=w_pad)]
            _CACHE[label] = (qs, rs, arrays, w_pad, want)
    return _CACHE


@pytest.mark.parametrize("label", ("ragged_n_leading_far", "wide_bands"))
def test_kernel_model_matches_jax_and_the_plain_core(label):
    qs, rs, arrays, w_pad, want = _cases()[label]
    got = kernel_model(*arrays, w_pad)
    assert_logs_equal(got, want, f"{label} model vs JAX")
    plain = error_profile._device_cs_core(*(torch.from_numpy(a) for a in arrays), w_pad=w_pad,
                                          n_fill=int(arrays[2].max()))
    assert_logs_equal(plain, want, f"{label} plain vs JAX")
    stats = got[3]
    if label == "wide_bands":
        assert w_pad == 320 and arrays[5].max() == 257
        shifts = np.diff(arrays[4][: len(qs)], axis=1)
        assert shifts.max() >= 10, "no band start moving ten or more a row"
    else:
        assert w_pad == 128 and len(qs) % 64, "pad reads in the tile"
        assert (arrays[0] == 4).any() and (arrays[1] == 4).any(), "no N base"
        # walks that go up at j == 0 (leading insertions) are in the logs
        assert ((want[0] == K_INS).any(axis=0)).sum() >= 6
    # the model's strings are banded_cs_batch's
    kind, qb, rb = got[:3]
    strings = [error_profile._cs_from_oplog(kind[:, k], qb[:, k], rb[:, k])
               for k in range(len(qs))]
    assert strings == jep.banded_cs_batch(qs, rs)


def _crafted(case: str):
    """A tile whose band starts are not the host's. ``band_jump`` moves
    each read's first n / 2 rows right by more than the band: row n / 2
    cannot reach them (a shift below -ws), every cell below holds BIG or
    more, and the walk leaves the band there. ``negative_shift`` does that
    to rows 0 and 1 of reads with leading insertions: from row 2 down, lane
    0 (j == 0) is out of reach of the row above and its direction is 0, so
    the walk takes the tail insertion (i > 0, j == 0, p != 1) up to row 1.
    Host band starts are monotone and wide enough for neither to happen;
    the kernel takes any."""
    rng = np.random.default_rng(5)
    qs, rs = _leading_insertions(rng, 8) if case == "negative_shift" else _ragged(rng, 12)
    qs16 = [np.asarray(q, np.int16) for q in qs]
    rs16 = [np.asarray(r, np.int16) for r in rs]
    ns, ms = np.array([len(q) for q in qs]), np.array([len(r) for r in rs])
    halves = np.maximum(48, np.abs(ns - ms) + 8)
    *arrays, w_pad = error_profile._tile_inputs(qs16, rs16, list(range(len(qs))), halves)
    lo, ws = arrays[4], arrays[5]
    for k in range(len(qs)):
        lo[k, : 2 if case == "negative_shift" else ns[k] // 2] += ws[k] + 3
    return arrays, w_pad


@pytest.mark.parametrize("case", ("negative_shift", "band_jump"))
def test_kernel_model_matches_jax_on_crafted_band_starts(case):
    arrays, w_pad = _crafted(case)
    got = kernel_model(*arrays, w_pad)
    if case == "negative_shift":
        assert got[3]["tail_ins"] >= 1, "no tail insertion taken"
    else:
        assert got[3]["off_band"] >= 8, "walks did not leave their band"
        assert (_stops(got[0]) > 0).sum() >= 8, "walks left the band at their first step"
    want = [np.asarray(x) for x in jep._device_cs_core(
        *(jnp.asarray(a) for a in arrays), w_pad=w_pad)]
    assert_logs_equal(got, want, f"{case} model vs JAX")
    plain = error_profile._device_cs_core(*(torch.from_numpy(a) for a in arrays), w_pad=w_pad,
                                          n_fill=int(arrays[2].max()))
    assert_logs_equal(plain, want, f"{case} plain vs JAX")


@pytest.mark.parametrize("rule", ("up", "left"))
def test_each_tie_rule_mutation_changes_the_logs(rule):
    """``<=`` for ``<`` in either tie rule gives another op log on these
    cases: the parity tests above would catch it."""
    differs = []
    for label, (_, _, arrays, w_pad, want) in _cases().items():
        mutated = kernel_model(*arrays, w_pad, **{f"{rule}_wins": np.less_equal})
        try:
            assert_logs_equal(mutated, want, label)
        except AssertionError:
            differs.append(label)
    assert differs, f"the {rule} tie mutation went unnoticed"


def test_wrapper_refuses_cpu_tensors():
    _, _, arrays, w_pad, _ = _cases()["wide_bands"]
    with pytest.raises(ValueError, match="CUDA"):
        cs_kernel.error_profile_cs_cuda(*(torch.from_numpy(a) for a in arrays), w_pad)


def test_cs_core_auto_takes_the_plain_core_on_cpu_tensors(monkeypatch):
    """On CPU tensors the device route runs the plain ``_device_cs_core``
    once a tile and no kernel counter moves; the strings are numpy's."""
    qs, rs = _ragged(np.random.default_rng(3), 20)
    calls = []
    real = error_profile._device_cs_core

    def spy(*args, **kwargs):
        calls.append(args[0].device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(error_profile, "_device_cs_core", spy)
    before = cs_kernel.error_profile_cs_cuda.launches
    got = error_profile.banded_cs_batch_device(qs, rs, tile=8, device="cpu")
    assert cs_kernel.error_profile_cs_cuda.launches == before
    assert calls == ["cpu"] * 3
    assert got == error_profile.banded_cs_batch(qs, rs)


@pytest.mark.gpu
def test_kernel_matches_the_plain_core_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B4 has no CPU mode")
    dev = torch.device("cuda")
    for label, (qs, rs) in _tiles().items():
        qs16 = [np.asarray(q, np.int16) for q in qs]
        rs16 = [np.asarray(r, np.int16) for r in rs]
        ns, ms = np.array([len(q) for q in qs]), np.array([len(r) for r in rs])
        halves = np.maximum(48, np.abs(ns - ms) + 8)
        *arrays, w_pad = error_profile._tile_inputs(qs16, rs16, list(range(len(qs))), halves)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        before = cs_kernel.error_profile_cs_cuda.launches
        got = error_profile.cs_core_auto(*args, w_pad=w_pad)
        assert cs_kernel.error_profile_cs_cuda.launches == before + 1
        want = error_profile._device_cs_core(*args, w_pad=w_pad, n_fill=int(ns.max()))
        assert_logs_equal([x.cpu() for x in got], [x.cpu() for x in want], label)
        assert error_profile.banded_cs_batch_device(qs, rs, device="cuda") == \
            error_profile.banded_cs_batch(qs, rs)
    for case in ("negative_shift", "band_jump"):
        arrays, w_pad = _crafted(case)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = cs_kernel.error_profile_cs_cuda(*args, w_pad)
        want = error_profile._device_cs_core(*args, w_pad=w_pad, n_fill=int(arrays[2].max()))
        assert_logs_equal([x.cpu() for x in got], [x.cpu() for x in want], case)
