"""Kernel B1 (``csrc/sw_banded.cu``): banded SW stats on the card.

Replaces the JAX package's Pallas kernel ``ops/sw_pallas._kernel``.
:func:`align_banded_auto` is the dispatcher every caller uses: tensors on
the CPU go to the plain PyTorch version (:func:`.sw_align.align_banded`),
CUDA tensors to the hand-written kernel, which raises if it cannot build or
launch. The two are cell-exact equals (``tests/test_torch_sw.py`` on the
CPU side, ``chip_smoke.py`` on the card).
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import _build, sw_align
from ont_tcrconsensus_tpu_torch.ops.sw_align import (
    GAP_EXT,
    GAP_OPEN,
    MATCH,
    MISMATCH,
    AlignResult,
)
from ont_tcrconsensus_tpu_torch.pipeline.config import SW_BAND_WIDTHS as BAND_WIDTHS


def align_banded_auto(reads, read_lens, refs, ref_lens, diag_offsets,
                      band_width: int = 256, **scoring) -> AlignResult:
    """The plain version for CPU tensors, kernel B1 for CUDA tensors."""
    if reads.device.type == "cpu":
        return sw_align.align_banded(reads, read_lens, refs, ref_lens,
                                     diag_offsets, band_width=band_width, **scoring)
    return align_banded_cuda(reads, read_lens, refs, ref_lens, diag_offsets,
                             band_width=band_width, **scoring)


def align_banded_cuda(
    reads: torch.Tensor,
    read_lens: torch.Tensor,
    refs: torch.Tensor,
    ref_lens: torch.Tensor,
    diag_offsets: torch.Tensor,
    band_width: int = 256,
    match: int = MATCH,
    mismatch: int = MISMATCH,
    gap_open: int = GAP_OPEN,
    gap_ext: int = GAP_EXT,
) -> AlignResult:
    """Launch kernel B1 on CUDA tensors (same contract as ``align_banded``)."""
    if reads.device.type != "cuda":
        raise ValueError(f"align_banded_cuda needs CUDA tensors, got {reads.device}")
    if band_width not in BAND_WIDTHS:
        raise ValueError(f"band_width {band_width} not in {BAND_WIDTHS}")
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(torch.uint8).contiguous()
    refs = refs.to(device=dev, dtype=torch.uint8).contiguous()
    rl = read_lens.to(device=dev, dtype=torch.int32).contiguous()
    tl = ref_lens.to(device=dev, dtype=torch.int32).contiguous()
    offs = diag_offsets.to(device=dev, dtype=torch.int32).contiguous()
    if refs.shape[0] != B or rl.shape != (B,) or tl.shape != (B,) or offs.shape != (B,):
        raise ValueError("reads, refs, lens and offsets must share the batch axis")
    out = torch.empty((B, 7), dtype=torch.int32, device=dev)
    if B:
        lib = _build.load("sw_banded")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sw_banded_launch(
                reads.data_ptr(), rl.data_ptr(), refs.data_ptr(), tl.data_ptr(),
                offs.data_ptr(), out.data_ptr(), B, L, refs.shape[1], band_width,
                match, mismatch, gap_open, gap_ext, stream,
            )
        _build.check("sw_banded", rc)
        align_banded_cuda.launches += 1
    return AlignResult(*out.unbind(1))


align_banded_cuda.launches = 0
