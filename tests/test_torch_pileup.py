"""Kernel B2 (pileup forward planes) and the pileup columns: the port's plain
PyTorch forward against the JAX package's XLA forward and its Pallas kernel
(interpreted), plane for plane; the scan-log traceback's columns against the
JAX package's; and the CUDA kernel against the plain forward on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import dp_case, noisy_copy, pack  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    from ont_tcrconsensus_tpu.ops import pileup as jpileup
    from ont_tcrconsensus_tpu.ops import pileup_pallas
except ImportError:
    jpileup = pileup_pallas = None
from ont_tcrconsensus_tpu_torch.ops import pileup, pileup_kernel  # noqa: E402

CASE_KINDS = ("noisy", "homopolymer", "repeat", "n_bases", "pad", "zero")
COLUMNS = ("base_at", "ins_cnt", "ins_base", "pos_at", "spans")


def _t(*arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays)


def _planes_u16(planes: torch.Tensor) -> np.ndarray:
    return planes.cpu().numpy().astype(np.uint16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B2 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("W", (64, 128))
@pytest.mark.parametrize("kind", CASE_KINDS)
def test_plain_forward_matches_jax_forward(kind, W):
    reads, rl, refs, tl, _ = dp_case(kind, n=10, L=256, W=W, seed=CASE_KINDS.index(kind))
    jbest, jplanes = jpileup._forward_batch(reads, rl, refs, tl, band_width=W)
    best, planes = pileup._forward_batch(*_t(reads, rl, refs, tl), band_width=W)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest), err_msg="best")
    np.testing.assert_array_equal(_planes_u16(planes), np.asarray(jplanes), err_msg="planes")


@pytest.mark.parametrize("W", (64, 128))
def test_plain_forward_matches_interpreted_pallas(W):
    reads, rl, refs, tl, _ = dp_case("noisy", n=18, L=128, W=W, seed=41)
    rl[5] = 0  # dead lane
    reads[7, :] = 0
    refs[7, :] = 0  # homopolymer lane
    best_p, tdir_p, fjump_p = pileup_pallas.forward_planes_pallas(
        reads, rl, refs, tl, band_width=W, interpret=True
    )
    best, planes = pileup._forward_batch(*_t(reads, rl, refs, tl), band_width=W)
    p = _planes_u16(planes)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_p), err_msg="best")
    np.testing.assert_array_equal(p & 15, np.asarray(tdir_p), err_msg="tdir")
    np.testing.assert_array_equal(p >> 4, np.asarray(fjump_p), err_msg="fjump")


def _clusters(seed: int, C: int = 3, S: int = 5, L: int = 384, err: float = 0.06):
    """(subreads (C,S,L), lens (C,S), drafts (C,L), draft_lens (C,)): noisy
    subreads of one template per cluster, the draft another noisy copy."""
    rng = np.random.default_rng(seed)
    subs, slens, drafts = [], [], []
    for c in range(C):
        tpl = rng.integers(0, 4, int(rng.integers(L // 2, L - 96))).astype(np.uint8)
        if c == 1:
            tpl[40:60] = 2  # homopolymer run inside the template
        rows = [noisy_copy(rng, tpl, err) for _ in range(S)]
        if c == 2:
            rows[-1] = rows[-1][:0]  # padded subread slot
        s, sl = pack(rows, L)
        subs.append(s)
        slens.append(sl)
        drafts.append(noisy_copy(rng, tpl, err / 2))
    d, dl = pack(drafts, L)
    return np.stack(subs), np.stack(slens), d, dl


@pytest.mark.parametrize("W", (64, 128))
@pytest.mark.parametrize("seed", (0, 1))
def test_columns_match_jax(seed, W):
    sub, sl, drafts, dl = _clusters(seed)
    want = jpileup.pileup_columns_batch_auto(sub, sl, drafts, dl, band_width=W)
    got = pileup.pileup_columns_batch_auto(*_t(sub, sl, drafts, dl), band_width=W)
    for name, g, w in zip(COLUMNS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_traceback_matches_jax_scan_log():
    """The scan-log traceback alone, fed the same planes (its early stop
    and drop column must not change a column)."""
    reads, rl, refs, tl, _ = dp_case("n_bases", n=8, L=256, W=64, seed=9)
    jbest, jplanes = jpileup._forward_batch(reads, rl, refs, tl, band_width=64)
    want = jpileup._traceback_batch(jbest, jplanes, reads, 64, 256)
    best, planes = pileup._forward_batch(*_t(reads, rl, refs, tl), band_width=64)
    got = pileup._traceback_batch(best, planes, torch.from_numpy(reads), 64, 256)
    for name, g, w in zip(COLUMNS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_forward_auto_takes_the_plain_version_on_cpu():
    reads, rl, refs, tl, _ = dp_case("noisy", n=4, L=128, W=64, seed=4)
    before = pileup_kernel.forward_planes_cuda.launches
    best, planes = pileup.forward_auto(*_t(reads, rl, refs, tl), band_width=64)
    best_p, planes_p = pileup._forward_batch(*_t(reads, rl, refs, tl), band_width=64)
    assert torch.equal(best, best_p) and torch.equal(planes, planes_p)
    assert pileup_kernel.forward_planes_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pileup_kernel.forward_planes_cuda(*_t(reads, rl, refs, tl), band_width=64)


@pytest.mark.gpu
@pytest.mark.parametrize("W", (64, 128))
@pytest.mark.parametrize("kind", CASE_KINDS)
def test_kernel_matches_plain_on_card(cuda_device, kind, W):
    case = dp_case(kind, n=40, L=300, W=W, seed=30 + CASE_KINDS.index(kind))
    args = _t(*case[:4], device=cuda_device)
    before = pileup_kernel.forward_planes_cuda.launches
    best_k, planes_k = pileup.forward_auto(*args, band_width=W)
    best_p, planes_p = pileup._forward_batch(*args, band_width=W)
    assert pileup_kernel.forward_planes_cuda.launches == before + 1
    assert torch.equal(best_k, best_p)
    assert torch.equal(planes_k, planes_p)


@pytest.mark.gpu
@pytest.mark.parametrize("W", (64, 128))
@pytest.mark.parametrize("n", (1, 3, 5))
def test_kernel_matches_plain_in_part_empty_blocks(cuda_device, n, W):
    """Batches that leave the 4-warp block part-empty."""
    case = dp_case("noisy", n=n, L=256, W=W, seed=70 + n)
    args = _t(*case[:4], device=cuda_device)
    best_k, planes_k = pileup_kernel.forward_planes_cuda(*args, band_width=W)
    best_p, planes_p = pileup._forward_batch(*args, band_width=W)
    assert torch.equal(best_k, best_p)
    assert torch.equal(planes_k, planes_p)


@pytest.mark.gpu
@pytest.mark.parametrize("W", (64, 128))
@pytest.mark.parametrize("L", (97, 333))
@pytest.mark.parametrize("kind", ("band_edge", "zero"))
def test_kernel_matches_plain_at_ragged_lengths(cuda_device, kind, L, W):
    """Reads that end well inside the padded width (the rows after a read's
    end are written without the DP) at an L that is not a multiple of 32."""
    case = dp_case(kind, n=9, L=L, W=W, seed=80 + L)
    args = _t(*case[:4], device=cuda_device)
    best_k, planes_k = pileup_kernel.forward_planes_cuda(*args, band_width=W)
    best_p, planes_p = pileup._forward_batch(*args, band_width=W)
    assert torch.equal(best_k, best_p)
    assert torch.equal(planes_k, planes_p)


@pytest.mark.gpu
def test_columns_on_card_match_cpu(cuda_device):
    sub, sl, drafts, dl = _clusters(3)
    got = pileup.pileup_columns_batch_auto(*_t(sub, sl, drafts, dl, device=cuda_device))
    want = pileup.pileup_columns_batch_auto(*_t(sub, sl, drafts, dl))
    for name, g, w in zip(COLUMNS, got, want):
        assert torch.equal(g.cpu(), w), name
