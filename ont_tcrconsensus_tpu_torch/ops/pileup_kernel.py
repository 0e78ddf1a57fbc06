"""Kernel B2 (``csrc/pileup_forward.cu``): pileup forward planes on the card.

Replaces the JAX package's Pallas kernel ``ops/pileup_pallas._forward_kernel``.
In the JAX package that kernel runs only under ``force_pallas``; in the
port it is the polish forward on the card, reached through
:func:`.pileup.forward_auto`. Same contract as the plain
:func:`.pileup._forward_batch`: best (N, 3) int32 and planes (N, L, W)
holding the u16 ``tdir | fjump << 4``, bit for bit, each lane's band
centred on its offset (``offs``; None, the polish path's case, passes a
null pointer and the kernel takes 0 for every lane).
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import _build
from ont_tcrconsensus_tpu_torch.ops.sw_align import GAP_EXT, GAP_OPEN, MATCH, MISMATCH
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

BAND_WIDTHS = (64, 128)


def forward_planes_cuda(reads, read_lens, refs, ref_lens, band_width: int, offs=None):
    """Launch kernel B2 on CUDA tensors; returns (best, planes). ``offs``:
    (N,) band centres or None (0 for every lane)."""
    if reads.device.type != "cuda":
        raise ValueError(f"forward_planes_cuda needs CUDA tensors, got {reads.device}")
    if band_width not in BAND_WIDTHS:
        raise ValueError(f"band_width {band_width} not in {BAND_WIDTHS}")
    N, L = reads.shape
    dev = reads.device
    reads = reads.to(torch.uint8).contiguous()
    refs = refs.to(device=dev, dtype=torch.uint8).contiguous()
    rl = read_lens.to(device=dev, dtype=torch.int32).contiguous()
    tl = ref_lens.to(device=dev, dtype=torch.int32).contiguous()
    if offs is not None:
        offs = offs.to(device=dev, dtype=torch.int32).contiguous()
    if (refs.shape[0] != N or rl.shape != (N,) or tl.shape != (N,)
            or (offs is not None and offs.shape != (N,))):
        raise ValueError("reads, refs, lens and offsets must share the lane axis")
    best = torch.empty((N, 3), dtype=torch.int32, device=dev)
    planes = torch.empty((N, L, band_width), dtype=torch.int16, device=dev)
    if N:
        lib = _build.load("pileup_forward")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pileup_forward_launch(
                reads.data_ptr(), rl.data_ptr(), refs.data_ptr(), tl.data_ptr(),
                None if offs is None else offs.data_ptr(), best.data_ptr(), planes.data_ptr(),
                N, L, refs.shape[1], band_width,
                MATCH, MISMATCH, GAP_OPEN, GAP_EXT, stream,
            )
        _build.check("pileup_forward", rc)
        forward_planes_cuda.launches += 1
        forward_planes_cuda.launches_offs += offs is not None
        mesh_mod.count_slice_launch(forward_planes_cuda.by_slice)
    return best, planes


forward_planes_cuda.launches = 0
forward_planes_cuda.launches_offs = 0  # of them, launches given band centres
forward_planes_cuda.by_slice = {}  # slice label -> launches inside sharded calls
