"""Global edit distance: the JAX package's ``pairwise``, ``many_vs_many`` and
``identity_matrix`` (its ``_nw_pair`` scan) against the port's, which are
the budgeted-dovetail distance at k_end = 0 (kernel B6 on the card, its
plain version on the CPU). Exact on seeded UMI-like pairs
(``io/dp_cases.dovetail_case``: noisy copies, unrelated pairs, empty
sequences, a_len > b_len, runs of N), on IUPAC strings encoded to dense
codes, on junk codes past every length, and on a Q x T grid with Q != T;
the route on the card is B6 at k_end = 0, and B6 called at k_end = 8 for
the NW path is caught. On a card, the route against the plain version.
Tolerance: exact (integers; the identity's float32 division bit for bit)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import dovetail_case  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import dovetail_kernel, edit_distance, encode  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu case only
    from ont_tcrconsensus_tpu.ops import edit_distance as jed
except ImportError:
    jed = None

L = 72
IUPAC = np.frombuffer(b"ACGTNRYSWKMBDHV", np.uint8)
JUNK = np.array([0, 1, 2, 3, 4, 5, 7, 9, 15, 200, 255], np.uint8)


def _iupac_pairs(rng, n):
    """Pairs of strings over the IUPAC alphabet (lengths 0-64), b a copy of
    a with a few letters changed, encoded to dense codes (every
    degenerate letter is code 4, N)."""
    a_s, b_s = [], []
    for _ in range(n):
        a = IUPAC[rng.integers(0, len(IUPAC), int(rng.integers(0, 65)))]
        b = a.copy()
        hit = rng.random(len(b)) < 0.15
        b[hit] = IUPAC[rng.integers(0, len(IUPAC), int(hit.sum()))]
        a_s.append(a.tobytes().decode())
        b_s.append(b.tobytes().decode())
    a, al = encode.encode_batch(a_s, pad_to=L, multiple=1)
    b, bl = encode.encode_batch(b_s, pad_to=L, multiple=1)
    return a, al, b, bl


def _junk_padding(rng, x, lens):
    """``x`` with every position past its row's length a random junk code."""
    x = x.copy()
    pad = np.arange(x.shape[1])[None, :] >= lens[:, None]
    x[pad] = JUNK[rng.integers(0, len(JUNK), int(pad.sum()))]
    return x


def _pairs(seed: int):
    """60 seeded pairs: 36 of ``dovetail_case`` (lengths 0-64 inside width
    72), 24 IUPAC pairs; every padding position junk."""
    rng = np.random.default_rng(seed)
    a, al, b, bl = (np.concatenate(x) for x in zip(
        dovetail_case(seed, 36, L, lens=(0, 64)), _iupac_pairs(rng, 24)))
    return _junk_padding(rng, a, al), al, _junk_padding(rng, b, bl), bl


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_pairwise_equals_jax():
    a, al, b, bl = _pairs(3)
    assert (al == 0).any() and (bl == 0).any() and (al > bl).any() and (a == 4).any()
    got = edit_distance.pairwise(*map(_t, (a, al, b, bl)))
    want = np.asarray(jed.pairwise(a, al, b, bl))
    assert got.dtype == torch.int32 and str(want.dtype) == "int32"
    np.testing.assert_array_equal(got.numpy(), want)


def test_many_vs_many_and_identity_equal_jax():
    a, al, b, bl = _pairs(4)
    q, ql, t, tl = a[:9], al[:9], b[20:33], bl[20:33]  # Q = 9 != T = 13
    assert (ql == 0).any() or (tl == 0).any()
    args = tuple(map(_t, (q, ql, t, tl)))
    d = edit_distance.many_vs_many(*args)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jed.many_vs_many(q, ql, t, tl)))
    ident = edit_distance.identity_matrix(*args)
    want = np.asarray(jed.identity_matrix(q, ql, t, tl))
    assert ident.dtype == torch.float32 and ident.shape == (9, 13)
    np.testing.assert_array_equal(ident.numpy(), want)
    assert (ident.numpy()[ql == 0] == 0).all() and (ident.numpy()[:, tl == 0] == 0).all()


def test_the_card_route_is_b6_at_k_end_0_and_k_end_8_is_caught(monkeypatch):
    """Tensors off the CPU go to kernel B6's wrappers at k_end = 0; the
    mutation that sends the NW path to B6 at k_end = 8 (the UMI dovetail's
    budget) differs from JAX's global distance."""
    a, al, b, bl = _pairs(5)
    calls = []

    def record(name):
        def wrapper(x, xl, y, yl, k_end):
            calls.append((name, k_end))
            n = x.shape[0] * (y.shape[0] if name == "grid" else 1)
            out = torch.zeros(n, dtype=torch.int32, device=x.device)
            return out.reshape(x.shape[0], y.shape[0]) if name == "grid" else out
        return wrapper

    monkeypatch.setattr(dovetail_kernel, "pairwise_dovetail_cuda", record("pairs"))
    monkeypatch.setattr(dovetail_kernel, "many_vs_many_dovetail_cuda", record("grid"))
    meta = [_t(x).to("meta") for x in (a, al, b, bl)]
    edit_distance.pairwise(*meta)
    edit_distance.many_vs_many(*meta)
    edit_distance.identity_matrix(*meta)
    assert calls == [("pairs", 0), ("grid", 0), ("grid", 0)]

    want = np.asarray(jed.pairwise(a, al, b, bl))
    mutated = edit_distance.pairwise_dovetail(*map(_t, (a, al, b, bl)), k_end=8).numpy()
    assert (mutated != want).sum() >= 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B6 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_b6_at_k_end_0_equals_the_plain_version_on_the_card(cuda_device):
    a, al, b, bl = (_t(x) for x in _pairs(6))
    b6 = dovetail_kernel.dovetail_cuda
    before = (b6.launches, b6.launches_nw)
    got = edit_distance.pairwise(*(x.to(cuda_device) for x in (a, al, b, bl)))
    assert (b6.launches, b6.launches_nw) == (before[0] + 1, before[1] + 1)
    edit_distance.pairwise_dovetail(*(x.to(cuda_device) for x in (a, al, b, bl)), k_end=8)
    assert (b6.launches, b6.launches_nw) == (before[0] + 2, before[1] + 1)
    assert torch.equal(got.cpu(), edit_distance.pairwise_dovetail_plain(a, al, b, bl, k_end=0))
    grid = [x.to(cuda_device) for x in (a[:9], al[:9], b[20:33], bl[20:33])]
    ident = edit_distance.identity_matrix(*grid)
    want = edit_distance.identity_matrix(*(x.cpu() for x in grid))
    assert torch.equal(ident.cpu(), want)
