"""Kernel B3 (``csrc/pileup_traceback.cu``): the polish traceback on the card.

Replaces the JAX package's device program ``ops/pileup._traceback_batch``
(a jitted ``lax.scan``). In the port it is the traceback of every pileup on
the card, reached through :func:`.pileup.traceback_auto` right after kernel
B2's forward. Same contract as the plain :func:`.pileup._traceback_steps`:
base_at (N, out_len) uint8, ins_cnt int32, ins_base uint8, pos_at int32 and
spans (N, 4) int32, bit for bit, each lane at the band offset its forward
ran at (``offs``; None passes a null pointer: 0 for every lane).
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import _build
from ont_tcrconsensus_tpu_torch.ops.pileup_kernel import BAND_WIDTHS  # B3 reads B2's planes
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod


def traceback_columns_cuda(best, planes, reads, band_width: int, out_len: int, offs=None):
    """Launch kernel B3 on CUDA tensors: best (N, 3) int32, planes (N, L, W)
    int16 as B2 writes them (read as u16), reads (N, L) uint8, offs (N,)
    band centres or None. Returns (base_at, ins_cnt, ins_base, pos_at,
    spans)."""
    if reads.device.type != "cuda":
        raise ValueError(f"traceback_columns_cuda needs CUDA tensors, got {reads.device}")
    if band_width not in BAND_WIDTHS:
        raise ValueError(f"band_width {band_width} not in {BAND_WIDTHS}")
    N, L = reads.shape
    dev = reads.device
    reads = reads.to(torch.uint8).contiguous()
    best = best.to(device=dev, dtype=torch.int32).contiguous()
    if planes.dtype not in (torch.int16, torch.uint16):
        raise ValueError(f"planes must be int16 (B2's u16 cells), got {planes.dtype}")
    planes = planes.to(dev).contiguous()
    if offs is not None:
        offs = offs.to(device=dev, dtype=torch.int32).contiguous()
    if (best.shape != (N, 3) or planes.shape != (N, L, band_width)
            or (offs is not None and offs.shape != (N,))):
        raise ValueError("best, planes, reads and offsets must share the lane axis and the "
                         "width")
    # the kernel writes every element, its fill values (UNCOVERED, 0, 0, -1)
    # first: one launch a call
    base_at = torch.empty((N, out_len), dtype=torch.uint8, device=dev)
    ins_cnt = torch.empty((N, out_len), dtype=torch.int32, device=dev)
    ins_base = torch.empty((N, out_len), dtype=torch.uint8, device=dev)
    pos_at = torch.empty((N, out_len), dtype=torch.int32, device=dev)
    spans = torch.empty((N, 4), dtype=torch.int32, device=dev)
    if N:
        lib = _build.load("pileup_traceback")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pileup_traceback_launch(
                best.data_ptr(), planes.data_ptr(), reads.data_ptr(),
                None if offs is None else offs.data_ptr(), base_at.data_ptr(),
                ins_cnt.data_ptr(), ins_base.data_ptr(), pos_at.data_ptr(), spans.data_ptr(),
                N, L, band_width, out_len, stream,
            )
        _build.check("pileup_traceback", rc)
        traceback_columns_cuda.launches += 1
        traceback_columns_cuda.launches_offs += offs is not None
        mesh_mod.count_slice_launch(traceback_columns_cuda.by_slice)
    return base_at, ins_cnt, ins_base, pos_at, spans


traceback_columns_cuda.launches = 0
traceback_columns_cuda.launches_offs = 0  # of them, launches given band centres
traceback_columns_cuda.by_slice = {}  # slice label -> launches inside sharded calls
