"""Kernel B5 (the infix fuzzy match, ``csrc/fuzzy_match.cu``): a numpy scalar
model written in the kernel's order (a pattern's windows as one warp's
lanes, each lane's column run row by row as the serial recurrence
D[i] = min(base[i], D[i-1] + 1), rows stopping at the pattern's length,
columns at the window's length; the first minimum of the final row for the
end; the reversed pattern over the prefix [0, end) backwards, its last
equal row for the start) against the JAX package's ``fuzzy_find_multi``
and the port's plain version, on seeded cases (``io/dp_cases.fuzzy_case``);
two mutations of the model caught (the last minimum taken for the end, a
column one row short); the wrapper's CPU refusal and the route by device;
and, on a card, the kernel against the plain version, one launch a call,
and its refusal of patterns its shared-memory column cannot hold.
Tolerance: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import FUZZY_KINDS, fuzzy_case  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import fuzzy_kernel, fuzzy_match  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    from ont_tcrconsensus_tpu.ops import fuzzy_match as jfuzzy
except ImportError:
    jfuzzy = None

BIG = 1 << 20
# (P, m, B, Lw): padded patterns of 8-16 masks over windows of up to 40,
# three windows of every kind a pattern
SHAPE = (4, 16, 4 * 3 * len(FUZZY_KINDS), 40)


def _column(col, pat, n, ch):
    """One column of every lane, rows 1..n in order (the kernel's
    ``column``): col (n + 1, lanes) in place, ch (lanes,); returns row n."""
    diag = col[0].copy()
    prev = np.zeros_like(diag)
    for i in range(1, n + 1):
        up = col[i].copy()
        sub = ((int(pat[i - 1]) & ch) == 0).astype(np.int64)
        v = np.minimum(np.minimum(diag + sub, up + 1), prev + 1)
        col[i] = v
        diag, prev = up, v
    return prev


def model(pmasks, plens, windows, wlens, *, last_min=False, rows_short=0, rows=False):
    """(dist, start, end), each (P, B), in the kernel's order; with ``rows``
    also every pair's forward final row and reversed-prefix row (masked
    past the window and past end with BIG) for counting ties."""
    P, m = pmasks.shape
    B, Lw = windows.shape
    w = windows.astype(np.int64)
    wl = wlens.astype(np.int64)
    out = np.zeros((3, P, B), np.int64)
    fwd = np.full((P, B, Lw + 1), BIG, np.int64)
    back = np.full((P, B, Lw + 1), BIG, np.int64)
    lanes = np.arange(B)
    for p in range(P):
        p_len = int(plens[p])
        n = min(max(p_len, 0), m) - rows_short
        pat = pmasks[p]
        rev = np.zeros(m, np.int64)
        rev[:n] = pat[:n][::-1]
        # pass 1: the columns up to each lane's window length
        col = np.repeat(np.arange(n + 1)[:, None], B, axis=1)
        dist = np.where(wl >= 0, p_len, BIG)
        end = np.zeros(B, np.int64)
        fwd[p, :, 0] = dist
        ncol = np.minimum(wl, Lw)
        for j in range(Lw):
            live = j < ncol
            if not live.any():
                break
            keep = col.copy()
            v = _column(col, pat, n, w[:, j])
            col = np.where(live, col, keep)
            better = live & ((v <= dist) if last_min else (v < dist))
            dist = np.where(better, v, dist)
            end = np.where(better, j + 1, end)
            fwd[p, live, j + 1] = v[live]
        # pass 2: the reversed pattern over each lane's prefix [0, end)
        col = np.repeat(np.arange(n + 1)[:, None], B, axis=1)
        j2 = np.where(dist == p_len, 0, -1)
        back[p, :, 0] = p_len
        for r in range(Lw):
            live = r < end
            if not live.any():
                break
            keep = col.copy()
            ch = w[lanes, np.clip(end - 1 - r, 0, Lw - 1)]
            v = _column(col, rev, n, ch)
            col = np.where(live, col, keep)
            j2 = np.where(live & (v == dist), r + 1, j2)
            back[p, live, r + 1] = v[live]
        out[:, p] = dist, end - j2, end
    return (out, fwd, back) if rows else out


@pytest.fixture(scope="module")
def case():
    return fuzzy_case(7, *SHAPE)


@pytest.fixture(scope="module")
def jax_want(case):
    if jfuzzy is None:
        pytest.skip("the JAX package is not installed")
    return np.stack([np.asarray(x) for x in jfuzzy.fuzzy_find_multi(*case)])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_model_in_the_kernels_order_equals_jax(case, jax_want):
    np.testing.assert_array_equal(model(*case), jax_want)


def test_plain_torch_version_equals_jax(case, jax_want):
    got = fuzzy_match.fuzzy_find_multi_plain(*(_t(x) for x in case))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), jax_want)


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
@pytest.mark.parametrize("shape", ((8, 47, 256, 150), (2, 32, 256, 81), SHAPE, (3, 0, 40, 12)),
                         ids=("primer_trim", "umi", "tests", "empty_patterns"))
def test_kernel_equals_plain_on_the_card(cuda_device, shape):
    case = [_t(x).to(cuda_device) for x in fuzzy_case(11, *shape)]
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
