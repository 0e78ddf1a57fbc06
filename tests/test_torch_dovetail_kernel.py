"""Kernel B6 (the UMI budgeted-dovetail distance, ``csrc/dovetail.cu``): a
numpy model of the bit-parallel kernel word for word (pairs as one warp's
lanes, the warp's words as many as its longest a needs; each lane's match
words of the codes 0-5, a word of any other byte built when a column needs
it; the borders as the initial Pv, +1 at the rows past k_end, and the top
row's horizontal delta, +1 in the columns past k_end; each column a step of
64-bit words, the add's carry and the shifted-out horizontal deltas passing
from word to word; the answer from the corner, rows i0..n and columns
j0..ncol: column j0 kept, its cells down from D[0][j0] by popcounts and
then row by row, the top row past j0 followed by its horizontal deltas,
both overhangs added as constants) against the JAX package's
``pairwise_dovetail`` and ``many_vs_many_dovetail`` and the port's plain
version, on seeded cases (``io/dp_cases.dovetail_case``) at k_end 0, 8 and
16, on a Q x T grid with Q != T, at a_len on the word edges 63-65 and
127-129 and on sequences of up to five words; the reduction to the corner
proven on the full DP matrices; mutations of the model caught (a's rows
one short, the carry between words dropped, the corner taken one row
short); the wrappers' CPU refusal and the route by device; and, on a
card, the kernel against the plain version, one launch a call, its widest
first sequences taken and one past them refused. Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import (  # noqa: E402
    DOVETAIL_KINDS, DOVETAIL_MULTIWORD, WORD_EDGES, dovetail_case)
from ont_tcrconsensus_tpu_torch.ops import dovetail_kernel, edit_distance  # noqa: E402
from torch_bitvector_model import ALL, ONE, U64, column_step, row_delta  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    from ont_tcrconsensus_tpu.ops import edit_distance as jed
except ImportError:
    jed = None

BIG = 1 << 20
K_ENDS = (0, 8, 16)
N_PAIRS, L, LENS = 6 * len(DOVETAIL_KINDS), 80, (4, 70)  # lengths under and over k_end
Q, T = 7, 5
# the word edges: every a length at every kind (pairs 8e..8e+7 at edge e),
# over a width past the longest
EDGE_A_LENS = [n for n in WORD_EDGES for _ in DOVETAIL_KINDS]
EDGE_PAIRS, EDGE_L = len(EDGE_A_LENS), max(WORD_EDGES) + 11
relu = lambda x: np.maximum(x, 0)  # noqa: E731


def match_words(A, n, nw, ch):
    """Words 0..nw-1 of each lane's rows < n of A equal to its byte ch
    (the table's words for codes 0-5, ``match_word`` for any other)."""
    rows = np.arange(nw * 64)
    A = np.pad(A, ((0, 0), (0, max(nw * 64 - A.shape[1], 0))), constant_values=255)
    hit = (A[:, : nw * 64] == ch[:, None]) & (rows[None, :] < n[:, None])
    bits = hit.reshape(len(n), nw, 64).astype(U64) << np.arange(64, dtype=U64)
    return list(np.bitwise_or.reduce(bits, axis=2).T)


def prefix(pv, mv, i):
    """Each lane's sum of the vertical deltas of rows 1..i (``prefix``):
    popcounts of the words below row i."""
    total = np.zeros(len(i), np.int64)
    for w in range(len(pv)):
        r = np.clip(i - 64 * w, 0, 64)
        keep = np.where(r >= 64, ALL, (ONE << r.astype(U64)) - ONE)
        bits = lambda x: np.unpackbits((x & keep).view(np.uint8)).reshape(-1, 64)  # noqa: E731
        total += bits(pv[w]).sum(1, dtype=np.int64) - bits(mv[w]).sum(1, dtype=np.int64)
    return total


def model(a, a_lens, b, b_lens, k, *, grid=False, rows_short=0, carry_between_words=True,
          corner_short=0):
    """Distances in the kernel's words: pair i reads a row i and b row i,
    or (``grid``) query i // T and target i % T of a (Q, La) x (T, Lb)
    grid; (pairs,) int64. ``rows_short`` drops a's last rows,
    ``corner_short`` the corner's top rows."""
    if grid:
        q, t = a.shape[0], b.shape[0]
        ia, ib = np.repeat(np.arange(q), t), np.tile(np.arange(t), q)
    else:
        ia = ib = np.arange(a.shape[0])
    La, Lb = a.shape[1], b.shape[1]
    out = np.zeros(len(ia), np.int64)
    for w0 in range(0, len(ia), 32):  # one warp
        sl = slice(w0, w0 + 32)
        A, B = a[ia[sl]].astype(np.int64), b[ib[sl]].astype(np.int64)
        a_len, b_len = a_lens[ia[sl]].astype(np.int64), b_lens[ib[sl]].astype(np.int64)
        lanes = len(a_len)
        n = np.minimum(a_len, La) - np.where(a_len >= 0, rows_short, 0)
        nw = max((int(relu(n).max()) + 63) // 64, 1)  # the warp's longest column
        tables = [match_words(A, n, nw, np.full(lanes, c)) for c in range(6)]
        ncol = relu(np.minimum(b_len, Lb))
        i0 = np.minimum(np.minimum(n, relu(a_len - k)) + corner_short, relu(n))
        j0 = np.minimum(ncol, relu(b_len - k))
        over = relu(a_len - n - k) + relu(b_len - ncol - k)
        shift = k - 64 * np.arange(nw)  # D[i][0] = relu(i - k): +1 at the rows past k
        pv = [np.full(lanes, ALL if s <= 0 else U64(0) if s >= 64 else ALL << U64(s))
              for s in shift]
        mv = [np.zeros(lanes, U64) for _ in range(nw)]
        at_j0 = [x.copy() for x in pv], [x.copy() for x in mv]  # column j0 kept
        run, least = np.zeros(lanes, np.int64), np.full(lanes, BIG, np.int64)
        for j in range(1, int(ncol.max(initial=0)) + 1):
            live = j <= ncol
            hin = np.full(lanes, U64(j > k))
            ch = np.where(live, B[:, j - 1], 0)
            eqs = [np.choose(np.clip(ch, 0, 5), [tables[c][v] for c in range(6)])
                   for v in range(nw)]
            if (ch >= 6).any():
                other = match_words(A, n, nw, ch)
                eqs = [np.where(ch >= 6, o, e) for o, e in zip(other, eqs)]
            kept = [x.copy() for x in pv], [x.copy() for x in mv]
            ph, mh = column_step(eqs, pv, mv, hin, carry_between_words=carry_between_words)
            for v in range(nw):  # a lane past its columns keeps its column
                pv[v] = np.where(live, pv[v], kept[0][v])
                mv[v] = np.where(live, mv[v], kept[1][v])
                at_j0[0][v] = np.where(j == j0, pv[v], at_j0[0][v])
                at_j0[1][v] = np.where(j == j0, mv[v], at_j0[1][v])
            past = live & (j > j0)
            delta = np.where(i0 >= 1, row_delta(ph, mh, i0), hin.astype(np.int64))
            run = np.where(past, run + delta, run)
            least = np.where(past, np.minimum(least, run), least)
        # the corner's left column, down from D[0][j0] through the kept column
        d = relu(j0 - k) + prefix(*at_j0, i0)  # D[i0][j0]
        top, left = d.copy(), d.copy()
        for r in range(1, int(relu(n).max()) + 1):
            rows = (r > i0) & (r <= n)
            d = np.where(rows, d + row_delta(*at_j0, np.full(lanes, r)), d)
            left = np.where(rows, np.minimum(left, d), left)
        best = np.minimum(left, top + least) + over
        out[sl] = np.where(n < 0, BIG + relu(b_len - ncol - k), best)
    return out


def full_matrices(a, a_lens, b, b_lens, k):
    """Every pair's whole DP matrix (pairs, La + 1, Lb + 1) of the plain
    recurrence, its borders relu(i - k) and relu(j - k)."""
    P, La = a.shape
    Lb = b.shape[1]
    i = np.arange(La + 1)
    D = np.zeros((P, La + 1, Lb + 1), np.int64)
    D[:, :, 0] = relu(i - k)
    for j in range(1, Lb + 1):
        sub = (a != b[:, j - 1 : j]).astype(np.int64)
        base = np.minimum(D[:, :-1, j - 1] + sub, D[:, 1:, j - 1] + 1)
        col = np.concatenate([np.full((P, 1), relu(j - k)), base], axis=1)
        D[:, :, j] = i + np.minimum.accumulate(col - i, axis=1)
    return D


@pytest.fixture(scope="module")
def case():
    return dovetail_case(3, N_PAIRS, L, LENS)


@pytest.fixture(scope="module")
def edge_case():
    return dovetail_case(19, EDGE_PAIRS, EDGE_L, a_lens=EDGE_A_LENS)


@pytest.fixture(scope="module")
def multiword_case():
    n, width, lens = DOVETAIL_MULTIWORD
    return dovetail_case(23, n, width, lens)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _grid(case):
    a, al, b, bl = case
    return a[:Q], al[:Q], b[-T:], bl[-T:]


def _need_jax():
    if jed is None:
        pytest.skip("the JAX package is not installed")


@pytest.fixture(scope="module")
def jax_want(case):
    _need_jax()
    return {k: (np.asarray(jed.pairwise_dovetail(*case, k_end=k)),
                np.asarray(jed.many_vs_many_dovetail(*_grid(case), k_end=k)))
            for k in K_ENDS}


@pytest.fixture(scope="module")
def edge_jax(edge_case):
    _need_jax()
    return {k: np.asarray(jed.pairwise_dovetail(*edge_case, k_end=k)) for k in K_ENDS}


@pytest.mark.parametrize("k", K_ENDS)
def test_model_in_the_kernels_order_equals_jax(case, jax_want, k):
    pairs, grid = jax_want[k]
    np.testing.assert_array_equal(model(*case, k), pairs)
    np.testing.assert_array_equal(model(*_grid(case), k, grid=True).reshape(Q, T), grid)


@pytest.mark.parametrize("k", K_ENDS)
def test_plain_torch_version_equals_jax(case, jax_want, k):
    pairs, grid = jax_want[k]
    got = edit_distance.pairwise_dovetail_plain(*(_t(x) for x in case), k_end=k)
    np.testing.assert_array_equal(got.numpy(), pairs)
    got = edit_distance.many_vs_many_dovetail(*(_t(x) for x in _grid(case)), k_end=k)
    np.testing.assert_array_equal(got.numpy(), grid)


@pytest.mark.parametrize("edge", WORD_EDGES, ids=[f"a_len_{n}" for n in WORD_EDGES])
@pytest.mark.parametrize("k", K_ENDS)
def test_model_at_a_word_edge_equals_jax_and_plain(edge_case, edge_jax, k, edge):
    a, al, b, bl = edge_case
    at = np.flatnonzero(np.asarray(EDGE_A_LENS) == edge)
    assert (al[at] == edge).sum() == len(DOVETAIL_KINDS) - 2  # all but the empty kinds
    one = a[at], al[at], b[at], bl[at]
    np.testing.assert_array_equal(model(*one, k), edge_jax[k][at])
    plain = edit_distance.pairwise_dovetail_plain(*(_t(x) for x in one), k_end=k)
    np.testing.assert_array_equal(plain.numpy(), edge_jax[k][at])


@pytest.mark.parametrize("k", K_ENDS)
def test_model_over_five_words_equals_plain(multiword_case, k):
    a, al, b, bl = multiword_case
    assert al.max() > 4 * 64 and a.shape[1] == DOVETAIL_MULTIWORD[1]
    want = edit_distance.pairwise_dovetail_plain(*(_t(x) for x in multiword_case), k_end=k)
    np.testing.assert_array_equal(model(*multiword_case, k), want.numpy())


def test_model_over_five_words_equals_jax(multiword_case):
    _need_jax()
    want = np.asarray(jed.pairwise_dovetail(*multiword_case, k_end=8))
    np.testing.assert_array_equal(model(*multiword_case, 8), want)


@pytest.mark.parametrize("k", K_ENDS)
def test_the_corner_holds_the_minimum_of_every_cell(case, k):
    """The reduction the kernel rests on, on the whole DP matrices: the
    minimum over every cell with its overhangs equals the corner's (rows
    i0..a_len, columns j0..b_len) with the constant overhangs, and that
    equals the minimum over the corner's top row and left column."""
    a, al, b, bl = case
    D = full_matrices(a.astype(np.int64), al, b.astype(np.int64), bl, k)
    La, Lb = a.shape[1], b.shape[1]
    i, j = np.arange(La + 1)[None, :, None], np.arange(Lb + 1)[None, None, :]
    a_len, b_len = al.astype(np.int64)[:, None, None], bl.astype(np.int64)[:, None, None]
    cells = (i <= a_len) & (j <= b_len)
    every = np.where(cells, D + relu(a_len - i - k) + relu(b_len - j - k), BIG).min(axis=(1, 2))
    i0, j0 = relu(a_len - k), relu(b_len - k)
    rect = cells & (i >= i0) & (j >= j0)
    corner = np.where(rect, D, BIG).min(axis=(1, 2))
    edges = np.where(rect & ((i == i0) | (j == j0)), D, BIG).min(axis=(1, 2))
    np.testing.assert_array_equal(corner, every)
    np.testing.assert_array_equal(edges, every)
    np.testing.assert_array_equal(model(*case, k), every)


def test_the_cases_hold_every_kind_the_kernel_must_get_right(case):
    a, al, b, bl = case
    assert (al == 0).any() and (bl == 0).any() and ((al == 0) & (bl == 0)).any()
    assert (al > bl).any() and (al < bl).any()
    assert (al > max(K_ENDS)).any() and ((al > 0) & (al <= max(K_ENDS))).any()
    assert (a == 4).any() and Q != T


def test_a_mutated_model_is_caught(case, jax_want):
    assert not np.array_equal(model(*case, 8, rows_short=1), jax_want[8][0])


def test_a_model_without_the_carry_between_words_is_caught(edge_case, edge_jax):
    """The carry between words matters past one word, and only there."""
    cut = model(*edge_case, 8, carry_between_words=False)
    one_word = edge_case[1] <= 64
    np.testing.assert_array_equal(cut[one_word], edge_jax[8][one_word])
    assert not np.array_equal(cut[~one_word], edge_jax[8][~one_word])


@pytest.mark.parametrize("k", (8, 16))
def test_a_model_with_the_corner_one_row_short_is_caught(case, jax_want, k):
    assert not np.array_equal(model(*case, k, corner_short=1), jax_want[k][0])


def test_cpu_tensors_take_the_plain_version(case):
    before = dovetail_kernel.dovetail_cuda.launches
    t = [_t(x) for x in case]
    assert torch.equal(edit_distance.pairwise_dovetail(*t, k_end=16),
                       edit_distance.pairwise_dovetail_plain(*t, k_end=16))
    assert dovetail_kernel.dovetail_cuda.launches == before


def test_the_wrappers_refuse_cpu_tensors(case):
    t = [_t(x) for x in case]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dovetail_kernel.pairwise_dovetail_cuda(*t)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dovetail_kernel.many_vs_many_dovetail_cuda(*t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B6 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", K_ENDS)
def test_kernel_equals_plain_on_the_card(cuda_device, k):
    pairs = [_t(x).to(cuda_device) for x in dovetail_case(5, 512, 128)]
    before = dovetail_kernel.dovetail_cuda.launches
    got = edit_distance.pairwise_dovetail(*pairs, k_end=k)
    assert dovetail_kernel.dovetail_cuda.launches == before + 1
    assert torch.equal(got, edit_distance.pairwise_dovetail_plain(*pairs, k_end=k))
    grid = [x[:40] for x in pairs[:2]] + [x[:24] for x in pairs[2:]]
    got = edit_distance.many_vs_many_dovetail(*grid, k_end=k)
    assert dovetail_kernel.dovetail_cuda.launches == before + 2
    q, ql, t, tl = grid
    want = edit_distance.pairwise_dovetail_plain(
        q.repeat_interleave(24, dim=0), ql.repeat_interleave(24), t.repeat(40, 1),
        tl.repeat(40), k_end=k).reshape(40, 24)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((EDGE_PAIRS, EDGE_L, None), DOVETAIL_MULTIWORD,
                                   (40, 1452, (1300, 1452))),
                         ids=("word_edges", "multiword", "widest"))
def test_kernel_equals_plain_past_one_word_on_the_card(cuda_device, shape):
    n, width, lens = shape
    case = dovetail_case(7, n, width, lens or (58, 68), a_lens=None if lens else EDGE_A_LENS)
    pairs = [_t(x).to(cuda_device) for x in case]
    for k in K_ENDS:
        before = dovetail_kernel.dovetail_cuda.launches
        got = edit_distance.pairwise_dovetail(*pairs, k_end=k)
        assert dovetail_kernel.dovetail_cuda.launches == before + 1
        assert torch.equal(got, edit_distance.pairwise_dovetail_plain(*pairs, k_end=k)), k


@pytest.mark.gpu
def test_kernel_refuses_a_width_past_its_column(cuda_device):
    a, al, b, bl = (_t(x).to(cuda_device) for x in dovetail_case(2, 4, 1453))
    before = dovetail_kernel.dovetail_cuda.launches
    with pytest.raises(ValueError, match="refused its arguments: the first sequences' width"):
        dovetail_kernel.pairwise_dovetail_cuda(a, al, b, bl)
    assert dovetail_kernel.dovetail_cuda.launches == before
