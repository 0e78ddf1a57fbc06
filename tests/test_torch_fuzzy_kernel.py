"""Kernel B5 (the infix fuzzy match, ``csrc/fuzzy_match.cu``): a numpy model
of the bit-parallel kernel word for word (a pattern's windows as one warp's
lanes; the pattern's match tables for all 256 byte values from its per-bit
row words and the nibble split, forward and reversed within p_len; each
column a step of 64-bit words, the add's carry and the shifted-out
horizontal deltas passing from word to word; the score at row p_len
following that row's horizontal deltas; the first minimum for the end; the
reversed pattern over the prefix [0, end) backwards, its last equal score
for the start) against the JAX package's ``fuzzy_find_multi`` and the
port's plain version, on seeded cases (``io/dp_cases.fuzzy_case``: the
kinds of every window, patterns at the word edges 63-65 and 127-129, a
pattern of four words); mutations of the model caught (the last minimum
taken for the end, the score read one row short, the carry between words
dropped); the wrapper's CPU refusal and the route by device; and, on a
card, the kernel against the plain version, one launch a call, its longest
pattern taken and one past it refused. Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import (  # noqa: E402
    FUZZY_KINDS, FUZZY_MULTIWORD, WORD_EDGES, fuzzy_case)
from ont_tcrconsensus_tpu_torch.ops import fuzzy_kernel, fuzzy_match  # noqa: E402
from torch_bitvector_model import ALL, ONE, U64, column_step, row_delta  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    from ont_tcrconsensus_tpu.ops import fuzzy_match as jfuzzy
except ImportError:
    jfuzzy = None

BIG = 1 << 20
# (P, m, B, Lw): padded patterns of 8-16 masks over windows of up to 40,
# three windows of every kind a pattern
SHAPE = (4, 16, 4 * 3 * len(FUZZY_KINDS), 40)
# the word edges: one pattern of each length, padded to the longest, over
# windows longer than the longest
EDGE_SHAPE = (len(WORD_EDGES), max(WORD_EDGES), 6 * len(FUZZY_KINDS), 180)


def tables(pat, n, nw):
    """The block's match tables (``build_word``): (256, nw) uint64 for the
    pattern's rows < n and for the pattern reversed within n."""
    out = []
    for rows in (pat[:n], pat[:n][::-1]):
        bits = np.zeros((8, nw), U64)  # the row words of each mask bit
        for i, x in enumerate(rows.astype(np.int64)):
            for b in range(8):
                if (x >> b) & 1:
                    bits[b, i // 64] |= ONE << U64(i % 64)
        lo, hi = np.zeros((16, nw), U64), np.zeros((16, nw), U64)
        for x in range(16):
            for b in range(4):
                if (x >> b) & 1:
                    lo[x] |= bits[b]
                    hi[x] |= bits[4 + b]
        c = np.arange(256)
        out.append(lo[c & 15] | hi[c >> 4])
    return out


def model(pmasks, plens, windows, wlens, *, last_min=False, rows_short=0,
          carry_between_words=True, rows=False):
    """(dist, start, end), each (P, B), in the kernel's words; with ``rows``
    also every pair's forward score row and reversed-prefix score row
    (masked past the window and past end with BIG) for counting ties."""
    P, m = pmasks.shape
    B, Lw = windows.shape
    wl = wlens.astype(np.int64)
    out = np.zeros((3, P, B), np.int64)
    fwd_rows = np.full((P, B, Lw + 1), BIG, np.int64)
    back_rows = np.full((P, B, Lw + 1), BIG, np.int64)
    lanes = np.arange(B)
    for p in range(P):
        p_len = int(plens[p])
        n = min(max(p_len, 0), m)
        nw = max((n + 63) // 64, 1)
        fwd, rev = tables(pmasks[p], n, nw)
        read = np.full(B, n - rows_short)

        def run(table, text, ncol, on_col):
            pv = [np.full(B, ALL) for _ in range(nw)]
            mv = [np.zeros(B, U64) for _ in range(nw)]
            score = np.full(B, n - rows_short, np.int64)
            for j in range(int(ncol.max(initial=0))):
                live = j < ncol
                ch = text(j)
                kept = [x.copy() for x in pv], [x.copy() for x in mv]
                ph, mh = column_step([table[ch, w] for w in range(nw)], pv, mv,
                                     np.zeros(B, U64), carry_between_words=carry_between_words)
                for w in range(nw):  # a lane past its columns keeps its column
                    pv[w] = np.where(live, pv[w], kept[0][w])
                    mv[w] = np.where(live, mv[w], kept[1][w])
                score = np.where(live, score + row_delta(ph, mh, read), score)
                on_col(j, live, score)

        dist = np.where(wl >= 0, p_len, BIG).astype(np.int64)
        end = np.zeros(B, np.int64)
        fwd_rows[p, :, 0] = dist

        def first_min(j, live, score):
            nonlocal dist, end
            better = live & ((score <= dist) if last_min else (score < dist))
            dist = np.where(better, score, dist)
            end = np.where(better, j + 1, end)
            fwd_rows[p, live, j + 1] = score[live]

        run(fwd, lambda j: windows[:, j].astype(np.int64), np.minimum(wl, Lw), first_min)
        j2 = np.where(dist == p_len, 0, -1)
        back_rows[p, :, 0] = p_len

        def last_equal(r, live, score):
            nonlocal j2
            j2 = np.where(live & (score == dist), r + 1, j2)
            back_rows[p, live, r + 1] = score[live]

        run(rev, lambda r: windows[lanes, np.clip(end - 1 - r, 0, Lw - 1)].astype(np.int64), end,
            last_equal)
        out[:, p] = dist, end - j2, end
    return (out, fwd_rows, back_rows) if rows else out


def _jax(case):
    if jfuzzy is None:
        pytest.skip("the JAX package is not installed")
    return np.stack([np.asarray(x) for x in jfuzzy.fuzzy_find_multi(*case)])


@pytest.fixture(scope="module")
def case():
    return fuzzy_case(7, *SHAPE)


@pytest.fixture(scope="module")
def jax_want(case):
    return _jax(case)


@pytest.fixture(scope="module")
def edge_case():
    return fuzzy_case(13, *EDGE_SHAPE, plens=WORD_EDGES)


@pytest.fixture(scope="module")
def edge_jax(edge_case):
    return _jax(edge_case)


@pytest.fixture(scope="module")
def multiword_case():
    return fuzzy_case(17, *FUZZY_MULTIWORD)


@pytest.fixture(scope="module")
def multiword_jax(multiword_case):
    return _jax(multiword_case)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _one_pattern(case, p):
    pmasks, plens, windows, wlens = case
    return pmasks[p : p + 1], plens[p : p + 1], windows, wlens


def test_model_in_the_kernels_order_equals_jax(case, jax_want):
    np.testing.assert_array_equal(model(*case), jax_want)


def test_plain_torch_version_equals_jax(case, jax_want):
    got = fuzzy_match.fuzzy_find_multi_plain(*(_t(x) for x in case))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), jax_want)


@pytest.mark.parametrize("p", range(len(WORD_EDGES)), ids=[f"p_len_{n}" for n in WORD_EDGES])
def test_model_at_a_word_edge_equals_jax_and_plain(edge_case, edge_jax, p):
    one = _one_pattern(edge_case, p)
    assert one[1][0] == WORD_EDGES[p]
    got = model(*one)[:, 0]
    np.testing.assert_array_equal(got, edge_jax[:, p])
    plain = fuzzy_match.fuzzy_find_multi_plain(*(_t(x) for x in one))
    np.testing.assert_array_equal(np.stack([g.numpy()[0] for g in plain]), edge_jax[:, p])


def test_model_of_a_pattern_of_four_words_equals_jax_and_plain(multiword_case, multiword_jax):
    pmasks, plens, windows, wlens = multiword_case
    assert plens[0] == pmasks.shape[1] > 3 * 64 and (wlens > plens[0]).any()
    np.testing.assert_array_equal(model(*multiword_case), multiword_jax)
    plain = fuzzy_match.fuzzy_find_multi_plain(*(_t(x) for x in multiword_case))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in plain]), multiword_jax)


def test_the_cases_hold_every_kind_the_kernel_must_get_right(case):
    """Padded patterns, empty and short windows, mask 0 inside and past a
    window, IUPAC codes and N, ties on the end and on the start, and
    matches at a window's first and last base."""
    pmasks, plens, windows, wlens = case
    P, m, B, Lw = SHAPE
    assert plens[0] == m and (plens < m).any()
    assert (wlens == 0).any() and ((wlens > 0) & (wlens < plens.min())).any()
    assert (wlens < Lw).any() and (wlens == Lw).any()
    inside = np.arange(Lw)[None, :] < wlens[:, None]
    assert (windows[inside] == 0).any() and (windows[~inside] == 0).all()
    assert np.isin(pmasks, (15,)).any() and np.isin(pmasks, (3, 5, 6, 7, 9, 10, 11, 12, 13, 14)).any()
    out, fwd, back = model(*case, rows=True)
    dist, start, end = out
    assert ((fwd == dist[..., None]).sum(-1) >= 2).any(), "no tie on the end"
    j = np.arange(Lw + 1)
    hits = (back == dist[..., None]) & (j <= end[..., None])
    assert (hits.sum(-1) >= 2).any(), "no tie on the start"
    exact = dist == 0
    assert (exact & (start == 0) & (end > 0)).any(), "no match at a window's first base"
    assert (exact & (end == wlens[None, :]) & (end > 0)).any(), "no match at a window's end"


@pytest.mark.parametrize("mutation", ({"last_min": True}, {"rows_short": 1}),
                         ids=("last_minimum_for_the_end", "one_row_short"))
def test_a_mutated_model_is_caught(case, jax_want, mutation):
    assert not np.array_equal(model(*case, **mutation), jax_want)


def test_a_model_without_the_carry_between_words_is_caught(edge_case, edge_jax):
    """The carry between words matters past one word, and only there."""
    cut = model(*edge_case, carry_between_words=False)
    one_word = np.asarray(WORD_EDGES) <= 64
    np.testing.assert_array_equal(cut[:, one_word], edge_jax[:, one_word])
    assert not np.array_equal(cut[:, ~one_word], edge_jax[:, ~one_word])


def test_cpu_tensors_take_the_plain_version(case):
    before = fuzzy_kernel.fuzzy_find_multi_cuda.launches
    got = fuzzy_match.fuzzy_find_multi(*(_t(x) for x in case))
    want = fuzzy_match.fuzzy_find_multi_plain(*(_t(x) for x in case))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fuzzy_kernel.fuzzy_find_multi_cuda.launches == before


def test_the_wrapper_refuses_cpu_tensors(case):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fuzzy_kernel.fuzzy_find_multi_cuda(*(_t(x) for x in case))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B5 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((8, 47, 256, 150), (2, 32, 256, 81), SHAPE, (3, 0, 40, 12),
                                   EDGE_SHAPE, FUZZY_MULTIWORD, (2, 1787, 40, 1900)),
                         ids=("primer_trim", "umi", "tests", "empty_patterns", "word_edges",
                              "multiword", "longest_pattern"))
def test_kernel_equals_plain_on_the_card(cuda_device, shape):
    plens = WORD_EDGES if shape == EDGE_SHAPE else None
    case = [_t(x).to(cuda_device) for x in fuzzy_case(11, *shape, plens=plens)]
    before = fuzzy_kernel.fuzzy_find_multi_cuda.launches
    got = fuzzy_match.fuzzy_find_multi(*case)
    assert fuzzy_kernel.fuzzy_find_multi_cuda.launches == before + 1
    want = fuzzy_match.fuzzy_find_multi_plain(*case)
    for name, g, w in zip(("dist", "start", "end"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.gpu
def test_kernel_refuses_a_pattern_past_its_column(cuda_device):
    pm, pl, w, wl = (_t(x).to(cuda_device) for x in fuzzy_case(3, 2, 1788, 4, 16))
    before = fuzzy_kernel.fuzzy_find_multi_cuda.launches
    with pytest.raises(ValueError, match="refused its arguments: the pattern length"):
        fuzzy_kernel.fuzzy_find_multi_cuda(pm, pl, w, wl)
    assert fuzzy_kernel.fuzzy_find_multi_cuda.launches == before
