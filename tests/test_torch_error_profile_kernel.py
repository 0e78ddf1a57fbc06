"""Kernel B4 (the QC error profile's DP, ``csrc/error_profile_cs.cu``): a
scalar model written in the kernel's order (one block a read, a few band
cells a thread: each thread's running min, the warp shuffle scan and the
warps' totals of the left chain, the row packed to 2 bits a cell; then warp
0's walk over plane rows staged in chunks) against the JAX package's jitted
``_device_cs_core`` on the CPU backend and the port's plain
``_device_cs_core``, op log for op log up to each walk's stop, and its cs
strings against ``banded_cs_batch``; the packed row's layout; the tie rules'
and the bit order's mutations; the wrapper's CPU refusal and the CPU
dispatch; and, on a card, the kernel against the plain core. Tolerance:
exact."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the JAX reference; a card machine without JAX runs the gpu case only
    import jax.numpy as jnp

    from ont_tcrconsensus_tpu.qc import error_profile as jep
except ImportError:
    jnp = jep = None
from ont_tcrconsensus_tpu_torch.io.dp_cases import (  # noqa: E402
    cs_crafted, cs_ragged, cs_tile_arrays, cs_tiles)
from ont_tcrconsensus_tpu_torch.ops import cs_kernel  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc import error_profile  # noqa: E402

BIG = 1 << 20
INT_MAX = np.iinfo(np.int32).max
K_MATCH, K_SUB, K_INS, K_DEL, K_STOP = 0, 1, 2, 3, 4


CELLS_PER_THREAD = {128: 2, 192: 3, 256: 4, 320: 5}  # csrc/error_profile_cs.cu
K_ROWS = 64  # plane rows a chunk of the walk's staging
RING = 4 * K_ROWS  # the walk's ring of staged rows


def _shfl_up(v: np.ndarray, o: int, wl: np.ndarray) -> np.ndarray:
    """``__shfl_up_sync(v, o)`` over 32-lane warps: lane l gets lane l - o's
    value, a lane with fewer than o lanes to its left in its warp its own."""
    return np.where(wl >= o, np.roll(v, o), v)


def pack_row(p: np.ndarray) -> np.ndarray:
    """A row of directions (0, 1, 2) packed as B4 writes it: cell t at bits
    2 (t % 16) of 32-bit word t / 16."""
    codes = p.astype(np.uint64).reshape(-1, 16)
    shifts = (2 * np.arange(16, dtype=np.uint64))[None, :]
    return (codes << shifts).sum(axis=1).astype(np.uint32)


def unpack_cell(words: np.ndarray, t: int, swap_bits: bool = False) -> int:
    """Cell t's direction from a packed row, as B4's walk decodes it
    (``swap_bits`` reads the cell's two bits the other way round: a
    mutation)."""
    p = int(words[t // 16] >> np.uint32(2 * (t % 16))) & 3
    return ((p & 1) << 1 | p >> 1) if swap_bits else p


def kernel_model(qpad, rpad, n_arr, m_arr, lo_all, ws, w_pad: int,
                 up_wins=np.less, left_wins=np.less, swap_bits: bool = False):
    """Kernel B4, block by block, in its order. Returns (kind, qb, rb),
    (N + M, L) uint8 with kind STOP past each walk, and the walks' counts
    of band exits, tail insertions and chunk edges crossed. ``up_wins`` and
    ``left_wins`` are the tie rules (strict in the kernel); ``swap_bits``
    decodes the packed plane with its two bit words swapped."""
    L, N = qpad.shape
    M = rpad.shape[1]
    ns = CELLS_PER_THREAD[w_pad]
    threads = w_pad // ns
    kind = np.full((N + M, L), K_STOP, np.uint8)
    qb = np.zeros((N + M, L), np.uint8)
    rb = np.zeros((N + M, L), np.uint8)
    cells = np.arange(w_pad, dtype=np.int64)
    thread = np.arange(threads)
    wl, warp = thread & 31, thread >> 5
    stats: Counter = Counter()
    for b in range(L):
        n, m, w = int(n_arr[b]), int(m_arr[b]), int(ws[b])
        q, r = qpad[b].astype(np.int64), rpad[b].astype(np.int64)
        lo = lo_all[b].astype(np.int64)
        plane = np.zeros((N + 1, w_pad // 16), np.uint32)
        js = lo[0] + cells
        valid = (cells < w) & (js <= m)
        prev = np.where(valid, js, BIG)
        plane[0] = pack_row(np.where(valid, 2, 0))
        for i in range(1, n + 1):
            nlo = lo[i]
            src = cells + (nlo - lo[i - 1]) - 1
            diag = np.where((src >= 0) & (src < w_pad), prev[np.clip(src, 0, w_pad - 1)], BIG)
            up = np.where((src + 1 >= 0) & (src + 1 < w_pad),
                          prev[np.clip(src + 1, 0, w_pad - 1)], BIG)
            js = nlo + cells
            valid = (cells < w) & (js <= m)
            qi = q[i - 1]
            rj = r[np.clip(js - 1, 0, M - 1)]
            sub = np.where((qi >= 4) | (rj != qi), 1, 0)
            d = np.where(js >= 1, diag + sub, BIG)
            u = up + 1
            best = np.where(valid, np.minimum(d, u), BIG)
            p = np.where(up_wins(u, d), 1, 0)
            # each thread's running min of best - cell over its cells, the
            # warps' shuffle scan of the threads' totals, the warps' totals
            v = (best - cells).reshape(threads, ns)
            before = np.concatenate([np.full((threads, 1), INT_MAX),
                                     np.minimum.accumulate(v, axis=1)[:, :-1]], axis=1)
            tot = v.min(axis=1)
            for o in (1, 2, 4, 8, 16):
                tot = np.minimum(tot, _shfl_up(tot, o, wl))
            excl = np.where(wl == 0, INT_MAX, _shfl_up(tot, 1, wl))
            warp_min = tot[wl == 31]
            for k in range(threads // 32 - 1):
                excl = np.where(warp > k, np.minimum(excl, warp_min[k]), excl)
            left = (np.minimum(excl[:, None], before) + cells.reshape(threads, ns)).reshape(-1)
            left[0] = BIG
            take = left_wins(left, best) & valid
            prev = np.where(valid, np.where(take, left, best), BIG)
            plane[i] = pack_row(np.where(valid, np.where(take, 2, p), 0))
        # the walk: chunks of K_ROWS rows aligned to K_ROWS, row i at ring
        # row i % RING, the chunk above staged as the walk reaches its
        # chunk's first row
        ring = np.zeros((RING, w_pad // 16), np.uint32)
        tags = np.full(RING, -1)

        def stage(first):
            for row in range(max(first, 0), min(first + K_ROWS - 1, n) + 1 if first >= 0 else 0):
                ring[row % RING], tags[row % RING] = plane[row], row

        lo_row = n - n % K_ROWS
        stage(lo_row)
        stage(lo_row - K_ROWS)
        i, j = n, m
        for s in range(N + M):
            if i == lo_row and i > 0:
                stage(lo_row - 2 * K_ROWS)
                lo_row -= K_ROWS
                stats["chunk_edges"] += 1
            qc, rc = q[max(i - 1, 0)], r[max(j - 1, 0)]
            qb[s, b], rb[s, b] = qc, rc
            t = j - lo[i]
            if (i == 0 and j == 0) or t < 0 or t >= w:
                stats["off_band"] += not (i == 0 and j == 0)
                break
            assert tags[i % RING] == i, f"read {b}'s walk read row {i}, which is not staged"
            p = unpack_cell(ring[i % RING], t, swap_bits)
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


_CACHE: dict = {}


def _cases():
    """Each tile's inputs as banded_cs_batch_device lays them out, with the
    JAX package's op log (its jitted core on the CPU backend)."""
    if not _CACHE:
        for label, (qs, rs) in cs_tiles().items():
            ns, ms = np.array([len(q) for q in qs]), np.array([len(r) for r in rs])
            assert (2 * np.maximum(48, np.abs(ns - ms) + 8) + 1 <= 257).all(), \
                "every read is live (no band outlier)"
            arrays, w_pad = cs_tile_arrays(qs, rs)
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
        # reads whose n + 1 plane rows span several staged chunks
        assert arrays[2].max() >= 3 * K_ROWS and stats["chunk_edges"] >= 12
        # walks that go up at j == 0 (leading insertions) are in the logs
        assert ((want[0] == K_INS).any(axis=0)).sum() >= 6
    # the model's strings are banded_cs_batch's
    kind, qb, rb = got[:3]
    strings = [error_profile._cs_from_oplog(kind[:, k], qb[:, k], rb[:, k])
               for k in range(len(qs))]
    assert strings == jep.banded_cs_batch(qs, rs)


@pytest.mark.parametrize("case", ("negative_shift", "band_jump"))
def test_kernel_model_matches_jax_on_crafted_band_starts(case):
    arrays, w_pad = cs_crafted(case)
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


def test_a_swapped_bit_order_changes_the_logs():
    """Mutation: the walk decoding each packed cell with its two bits
    swapped (up read as left and left as up) gives another op log on every
    tile: the parity tests above would catch it."""
    for label, (_, _, arrays, w_pad, want) in _cases().items():
        with pytest.raises(AssertionError):
            assert_logs_equal(kernel_model(*arrays, w_pad, swap_bits=True), want, label)


@pytest.mark.parametrize("w_pad", sorted(CELLS_PER_THREAD))
def test_packed_row_layout(w_pad):
    """B4's scratch row: W / 4 bytes, 2 bits a cell in cell order, and the
    walk's decode inverts it."""
    p = np.random.default_rng(w_pad).integers(0, 3, w_pad)
    words = pack_row(p)
    assert words.nbytes == w_pad // 4
    assert [unpack_cell(words, t) for t in range(w_pad)] == p.tolist()
    if w_pad == 128:  # cell 0 up, 1 left, 17 left, 127 up, the rest diagonal
        p = np.zeros(128, np.int64)
        p[[0, 1, 17, 127]] = 1, 2, 2, 1
        assert pack_row(p).tolist() == [0b1001, 0b1000, 0, 0, 0, 0, 0, 1 << 30]


def test_wrapper_refuses_cpu_tensors():
    _, _, arrays, w_pad, _ = _cases()["wide_bands"]
    with pytest.raises(ValueError, match="CUDA"):
        cs_kernel.error_profile_cs_cuda(*(torch.from_numpy(a) for a in arrays), w_pad)


def test_cs_core_auto_takes_the_plain_core_on_cpu_tensors(monkeypatch):
    """On CPU tensors the device route runs the plain ``_device_cs_core``
    once a tile and no kernel counter moves; the strings are numpy's."""
    qs, rs = cs_ragged(np.random.default_rng(3), 20)
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
    for label, (qs, rs) in cs_tiles().items():
        arrays, w_pad = cs_tile_arrays(qs, rs)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        before = cs_kernel.error_profile_cs_cuda.launches
        got = error_profile.cs_core_auto(*args, w_pad=w_pad)
        assert cs_kernel.error_profile_cs_cuda.launches == before + 1
        want = error_profile._device_cs_core(*args, w_pad=w_pad, n_fill=int(arrays[2].max()))
        assert_logs_equal([x.cpu() for x in got], [x.cpu() for x in want], label)
        assert error_profile.banded_cs_batch_device(qs, rs, device="cuda") == \
            error_profile.banded_cs_batch(qs, rs)
    for case in ("negative_shift", "band_jump"):
        arrays, w_pad = cs_crafted(case)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = cs_kernel.error_profile_cs_cuda(*args, w_pad)
        want = error_profile._device_cs_core(*args, w_pad=w_pad, n_fill=int(arrays[2].max()))
        assert_logs_equal([x.cpu() for x in got], [x.cpu() for x in want], case)
