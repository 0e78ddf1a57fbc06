"""Kernel B1 (banded SW stats): the port's plain PyTorch version against the
JAX package's XLA scan and its Pallas kernel (interpreted), cell exact; and
the CUDA kernel against the plain version where a card is present."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import DP_KINDS, dp_case  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu cases only
    from ont_tcrconsensus_tpu.ops import sw_align as jsw
    from ont_tcrconsensus_tpu.ops import sw_pallas
except ImportError:
    jsw = sw_pallas = None
from ont_tcrconsensus_tpu_torch.ops import _build, sw_align, sw_kernel  # noqa: E402

FIELDS = ("score", "read_start", "read_end", "ref_start", "ref_end", "n_match", "n_cols")
W = 128


def _torch_args(case, device="cpu"):
    return tuple(torch.from_numpy(x).to(device) for x in case)


def _assert_same(got, want, label):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f"{label}: {f}"
        )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", DP_KINDS)
def test_plain_matches_jax_scan(kind):
    case = dp_case(kind, seed=DP_KINDS.index(kind))
    want = jsw.align_banded(*case, band_width=W)
    got = sw_align.align_banded(*_torch_args(case), band_width=W)
    _assert_same(got, want, kind)
    assert got.score.dtype == torch.int32


@pytest.mark.parametrize("kind", ("noisy", "homopolymer", "band_edge", "zero"))
def test_plain_matches_interpreted_pallas(kind):
    case = dp_case(kind, n=6, L=128, seed=10 + DP_KINDS.index(kind))
    want = sw_pallas.align_banded_pallas(*case, band_width=W, interpret=True)
    got = sw_align.align_banded(*_torch_args(case), band_width=W)
    _assert_same(got, want, kind)


@pytest.mark.parametrize("W2", (64, 256, 384))
def test_plain_matches_jax_scan_other_bands(W2):
    """The self-homology pass runs W=512; the kernel also takes 256/384."""
    case = dp_case("noisy", n=8, L=192, W=W2, seed=3)
    want = jsw.align_banded(*case, band_width=W2)
    got = sw_align.align_banded(*_torch_args(case), band_width=W2)
    _assert_same(got, want, f"W={W2}")


def test_f_cascade_ties_keep_the_shorter_gap():
    """All-equal and homopolymer-like rows: every doubling candidate ties,
    so the origin channels and the gap length must stay the JAX ones."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    rows = [np.zeros(W, np.int32), np.full(W, 7, np.int32),
            (np.arange(W) * -2).astype(np.int32),           # exactly the ext slope
            rng.integers(-4, 5, W).astype(np.int32) * 2]
    for tmp in rows:
        tch = rng.integers(0, 50, (4, W)).astype(np.int32)
        jF, jch = jsw._f_cascade(jnp.asarray(tmp), jnp.asarray(tch), 4, 2, W)
        tF, tchs = sw_align._f_cascade(torch.from_numpy(tmp)[None], torch.from_numpy(tch)[:, None],
                                       4, 2, W)
        np.testing.assert_array_equal(tF[0].numpy(), np.asarray(jF))
        np.testing.assert_array_equal(tchs[:, 0].numpy(), np.asarray(jch))


def test_plain_matches_unbanded_oracle():
    """A band wider than both sequences equals the full numpy local
    alignment (``sw_align.align_np``)."""
    case = dp_case("noisy", n=4, L=64, seed=8)
    reads, rl, refs, tl, _ = case
    offs = np.zeros(4, np.int32)
    got = sw_align.align_banded(*_torch_args((reads, rl, refs, tl, offs)), band_width=256)
    for b in range(4):
        want = jsw.align_np(reads[b, : rl[b]], refs[b, : tl[b]])
        for f in FIELDS:
            assert int(getattr(got, f)[b]) == int(getattr(want, f)), (b, f)


def test_auto_dispatch_takes_the_plain_version_on_cpu():
    case = dp_case("noisy", n=4, L=128, seed=2)
    before = sw_kernel.align_banded_cuda.launches
    got = sw_kernel.align_banded_auto(*_torch_args(case), band_width=W)
    want = sw_align.align_banded(*_torch_args(case), band_width=W)
    _assert_same(got, want, "auto")
    assert sw_kernel.align_banded_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    case = dp_case("noisy", n=2, L=128, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        sw_kernel.align_banded_cuda(*_torch_args(case), band_width=W)


def test_config_takes_exactly_the_kernels_band_widths(tmp_path):
    """A config the CPU path runs must run on the card too: RunConfig
    refuses every SW band width kernel B1 is not built for."""
    from ont_tcrconsensus_tpu_torch.pipeline.config import SW_BAND_WIDTHS, RunConfig

    assert SW_BAND_WIDTHS == sw_kernel.BAND_WIDTHS
    base = {"reference_file": str(tmp_path / "ref.fa"), "fastq_pass_dir": str(tmp_path)}
    for width in SW_BAND_WIDTHS:
        assert RunConfig.from_dict({**base, "sw_band_width": width}).sw_band_width == width
    for width in (64, 640, 1024, 100, "128"):
        with pytest.raises(ValueError, match="sw_band_width"):
            RunConfig.from_dict({**base, "sw_band_width": width})


def test_kernels_build_for_sm90a_and_raise_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    args = _build._nvcc_command("sw_banded", "out.so")
    assert "-gencode=arch=compute_90a,code=sm_90a" in args
    assert {"-shared", "-O3", "-std=c++17"} <= set(args)
    assert args[-1].endswith("csrc/sw_banded.cu")
    assert _build.library_path("sw_banded") != _build.library_path("pileup_forward")
    monkeypatch.undo()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", "/nonexistent/build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


@pytest.mark.parametrize("name", _build.KERNELS)
def test_launcher_refusal_raises_value_error_naming_the_limits(name):
    """A launcher that refuses its arguments (it alone holds the band widths
    and the packed keys' limits) returns cudaErrorInvalidValue; the
    wrappers raise ValueError pointing at it, and RuntimeError otherwise."""
    _build.check(name, 0)
    with pytest.raises(ValueError, match=f"{name}_launch in csrc/{name}.cu"):
        _build.check(name, _build.CUDA_ERROR_INVALID_VALUE)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.check(name, 700)


@pytest.mark.gpu
def test_kernel_refuses_what_its_packed_keys_cannot_hold(cuda_device):
    """Scoring the 32-bit scan keys cannot hold, and L + Lr past the
    channels' 16-bit fields: refused without a launch."""
    reads, rl, refs, tl, offs = dp_case("noisy", n=2, L=128, seed=2)
    long_refs = np.full((2, 65536 - 128), 5, np.uint8)
    before = sw_kernel.align_banded_cuda.launches
    for case, scoring in (((reads, rl, refs, tl, offs), {"gap_ext": -1}),
                          ((reads, rl, refs, tl, offs), {"match": 1 << 20}),
                          ((reads, rl, long_refs, tl, offs), {})):
        with pytest.raises(ValueError, match="refused its arguments"):
            sw_kernel.align_banded_cuda(*_torch_args(case, cuda_device), band_width=W, **scoring)
    assert sw_kernel.align_banded_cuda.launches == before


def _assert_kernel_matches_plain(case, device, label):
    args = _torch_args(case, device)
    for band in sw_kernel.BAND_WIDTHS:
        before = sw_kernel.align_banded_cuda.launches
        got = sw_kernel.align_banded_auto(*args, band_width=band)
        want = sw_align.align_banded(*args, band_width=band)
        assert sw_kernel.align_banded_cuda.launches == before + 1
        _assert_same(
            type(got)(*[x.cpu() for x in vars(got).values()]),
            type(want)(*[x.cpu() for x in vars(want).values()]),
            f"{label} W={band}",
        )


@pytest.mark.gpu
@pytest.mark.parametrize("kind", DP_KINDS)
def test_kernel_matches_plain_on_card(cuda_device, kind):
    case = dp_case(kind, n=40, L=384, seed=20 + DP_KINDS.index(kind))
    _assert_kernel_matches_plain(case, cuda_device, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 3, 5))
def test_kernel_matches_plain_in_part_empty_blocks(cuda_device, n):
    """Batches that leave a block part-empty (4 pairs a block at W=128; one
    pair a block of 2-4 warps above it), at every band width."""
    _assert_kernel_matches_plain(dp_case("noisy", n=n, L=320, seed=40 + n), cuda_device, f"n={n}")


@pytest.mark.gpu
@pytest.mark.parametrize("L", (97, 333))
@pytest.mark.parametrize("kind", ("band_edge", "zero"))
def test_kernel_matches_plain_at_ragged_lengths(cuda_device, kind, L):
    """Offsets at and past the band's edges, and nothing scoring, at an L
    that is not a multiple of 32."""
    for band in sw_kernel.BAND_WIDTHS:  # band_edge's offsets follow the band
        case = dp_case(kind, n=9, L=L, W=band, seed=50 + L)
        args = _torch_args(case, cuda_device)
        got = sw_kernel.align_banded_cuda(*args, band_width=band)
        want = sw_align.align_banded(*args, band_width=band)
        _assert_same(
            type(got)(*[x.cpu() for x in vars(got).values()]),
            type(want)(*[x.cpu() for x in vars(want).values()]),
            f"{kind} L={L} W={band}",
        )
