"""Kernel B5 (``csrc/fuzzy_match.cu``): the infix fuzzy match on the card.

Replaces the JAX package's device program ``ops/fuzzy_match.fuzzy_find_multi``
(``_final_row``, a jitted ``lax.scan`` over a window's columns, vmapped over
patterns and windows, run forward for the end and over the reversed prefix
for the start). In the port :func:`.fuzzy_match.fuzzy_find_multi` routes
CUDA tensors here: the primer trim and the UMI windows of every assign
batch. Same contract as the plain
:func:`.fuzzy_match.fuzzy_find_multi_plain`, bit for bit, in one launch:
a thread a (pattern, window) pair, each column a bit-parallel step over
the pattern's 64-row words (``csrc/bitvector.cuh``), patterns up to 1787
masks.
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import _build
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod


def fuzzy_find_multi_cuda(pattern_masks, pattern_lens, windows, window_lens):
    """Launch kernel B5 on CUDA tensors: pattern_masks (P, m) uint8 IUPAC
    masks zero-padded past each length, pattern_lens (P,), windows (B, Lw)
    uint8 masks, window_lens (B,). Returns (dist, start, end), each (P, B)
    int32."""
    if windows.device.type != "cuda":
        raise ValueError(f"fuzzy_find_multi_cuda needs CUDA tensors, got {windows.device}")
    P, m = pattern_masks.shape
    B, Lw = windows.shape
    dev = windows.device
    pm = pattern_masks.to(device=dev, dtype=torch.uint8).contiguous()
    pl = pattern_lens.to(device=dev, dtype=torch.int32).contiguous()
    w = windows.to(torch.uint8).contiguous()
    wl = window_lens.to(device=dev, dtype=torch.int32).contiguous()
    if pl.shape != (P,) or wl.shape != (B,):
        raise ValueError("pattern_lens must have one length a pattern, window_lens one a window")
    out = torch.empty((3, P, B), dtype=torch.int32, device=dev)
    if P and B:
        lib = _build.load("fuzzy_match")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fuzzy_match_launch(pm.data_ptr(), pl.data_ptr(), w.data_ptr(),
                                        wl.data_ptr(), out.data_ptr(), P, m, B, Lw, stream)
        _build.check("fuzzy_match", rc)
        fuzzy_find_multi_cuda.launches += 1
        mesh_mod.count_slice_launch(fuzzy_find_multi_cuda.by_slice)
    return out[0], out[1], out[2]


fuzzy_find_multi_cuda.launches = 0
fuzzy_find_multi_cuda.by_slice = {}  # slice label -> launches inside sharded calls
