"""Kernel B6 (the UMI budgeted-dovetail distance, ``csrc/dovetail.cu``): a
numpy scalar model written in the kernel's order (pairs as one warp's
lanes, each lane's column run row by row as the serial recurrence
D[i] = min(base[i], D[i-1] + 1), rows stopping at a_len and columns at
b_len, each cell's candidate charged its overhangs past k_end) against the
JAX package's ``pairwise_dovetail`` and ``many_vs_many_dovetail`` and the
port's plain version, on seeded cases (``io/dp_cases.dovetail_case``) at
k_end 0, 8 and 16 and on a Q x T grid with Q != T; a mutation of the model
caught (a column one row short); the wrappers' CPU refusal and the route
by device; and, on a card, the kernel against the plain version, one launch
a call, and its refusal of a width its shared-memory column cannot hold.
Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import DOVETAIL_KINDS, dovetail_case  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import dovetail_kernel, edit_distance  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    from ont_tcrconsensus_tpu.ops import edit_distance as jed
except ImportError:
    jed = None

BIG = 1 << 20
K_ENDS = (0, 8, 16)
N_PAIRS, L, LENS = 6 * len(DOVETAIL_KINDS), 80, (4, 70)  # lengths under and over k_end
Q, T = 7, 5


def model(a, a_lens, b, b_lens, k, *, grid=False, rows_short=0):
    """Distances in the kernel's order: pair i reads a row i and b row i,
    or (``grid``) query i // T and target i % T of a (Q, La) x (T, Lb)
    grid; (pairs,) int64."""
    if grid:
        q, t = a.shape[0], b.shape[0]
        ia, ib = np.repeat(np.arange(q), t), np.tile(np.arange(t), q)
    else:
        ia = ib = np.arange(a.shape[0])
    La, Lb = a.shape[1], b.shape[1]
    A, B = a[ia].astype(np.int64), b[ib].astype(np.int64)
    a_len, b_len = a_lens[ia].astype(np.int64), b_lens[ib].astype(np.int64)
    n = np.minimum(a_len, La) - rows_short  # each lane's last row
    relu = lambda x: np.maximum(x, 0)  # noqa: E731
    col = np.zeros((La + 1, len(ia)), np.int64)
    best = np.full(len(ia), BIG)
    for i in range(La + 1):
        row = i <= n
        col[i] = np.where(row, relu(i - k), 0)
        best = np.where(row, np.minimum(best, col[i] + relu(a_len - i - k)), best)
    best = best + relu(b_len - k)
    ncol = np.minimum(b_len, Lb)
    for j in range(Lb):
        live = j < ncol
        if not live.any():
            break
        ch = B[:, j]
        diag = col[0].copy()
        prev = np.full(len(ia), relu(j + 1 - k))
        has_rows = n >= 0
        col[0] = np.where(live & has_rows, prev, col[0])
        cand = np.where(has_rows, prev + relu(a_len - k), BIG)
        for i in range(1, La + 1):
            row = live & (i <= n)
            if not row.any():
                break
            up = col[i].copy()
            v = np.minimum(np.minimum(diag + (A[:, i - 1] != ch), up + 1), prev + 1)
            col[i] = np.where(row, v, col[i])
            cand = np.where(row, np.minimum(cand, v + relu(a_len - i - k)), cand)
            diag, prev = up, v
        best = np.where(live, np.minimum(best, cand + relu(b_len - (j + 1) - k)), best)
    return best


@pytest.fixture(scope="module")
def case():
    return dovetail_case(3, N_PAIRS, L, LENS)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _grid(case):
    a, al, b, bl = case
    return a[:Q], al[:Q], b[-T:], bl[-T:]


@pytest.fixture(scope="module")
def jax_want(case):
    if jed is None:
        pytest.skip("the JAX package is not installed")
    return {k: (np.asarray(jed.pairwise_dovetail(*case, k_end=k)),
                np.asarray(jed.many_vs_many_dovetail(*_grid(case), k_end=k)))
            for k in K_ENDS}


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


def test_the_cases_hold_every_kind_the_kernel_must_get_right(case):
    a, al, b, bl = case
    assert (al == 0).any() and (bl == 0).any() and ((al == 0) & (bl == 0)).any()
    assert (al > bl).any() and (al < bl).any()
    assert (al > max(K_ENDS)).any() and ((al > 0) & (al <= max(K_ENDS))).any()
    assert (a == 4).any() and Q != T


def test_a_mutated_model_is_caught(case, jax_want):
    assert not np.array_equal(model(*case, 8, rows_short=1), jax_want[8][0])


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
def test_kernel_refuses_a_width_past_its_column(cuda_device):
    a, al, b, bl = (_t(x).to(cuda_device) for x in dovetail_case(2, 4, 1453))
    before = dovetail_kernel.dovetail_cuda.launches
    with pytest.raises(ValueError, match="refused its arguments: the first sequences' width"):
        dovetail_kernel.pairwise_dovetail_cuda(a, al, b, bl)
    assert dovetail_kernel.dovetail_cuda.launches == before
