"""Kernel B4 (``csrc/error_profile_cs.cu``): the QC error profile's banded
DP on the card.

Replaces the JAX package's device program ``qc/error_profile._device_cs_core``
(a jitted pair of ``lax.scan``s: the fill over rows, the walk over steps).
In the port it runs every tile of a profile on the card, reached through
:func:`..qc.error_profile.cs_core_auto` from ``banded_cs_batch_device``.
Same contract as the plain :func:`..qc.error_profile._device_cs_core`: the
op log (kind, qb, rb), (N + M, L) uint8 in reverse order, equal to the
plain one up to each walk's first STOP; kind is STOP after it, and qb and rb
past it are not written.
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import _build
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

# the band widths the kernel is built for: ws = 2 * half + 1 <= 257 bucketed to 64
W_PADS = (128, 192, 256, 320)


def error_profile_cs_cuda(qpad, rpad, n_arr, m_arr, lo_all, ws, w_pad: int):
    """Launch kernel B4 on CUDA tensors: codes qpad (L, N) and rpad (L, M)
    uint8, n_arr, m_arr and ws (L,) int32, lo_all (L, N+1) int32 band
    starts, ``w_pad`` >= ws.max(). Returns (kind, qb, rb), (N+M, L) uint8."""
    from ont_tcrconsensus_tpu_torch.qc.error_profile import _K_STOP

    if qpad.device.type != "cuda":
        raise ValueError(f"error_profile_cs_cuda needs CUDA tensors, got {qpad.device}")
    if w_pad not in W_PADS:
        raise ValueError(f"w_pad {w_pad} not in {W_PADS}")
    if qpad.dtype != torch.uint8 or rpad.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {qpad.dtype} and {rpad.dtype}")
    L, N = qpad.shape
    M = rpad.shape[1]
    dev = qpad.device
    qpad, rpad = qpad.contiguous(), rpad.to(dev).contiguous()
    n_arr, m_arr, ws, lo_all = (x.to(device=dev, dtype=torch.int32).contiguous()
                                for x in (n_arr, m_arr, ws, lo_all))
    if (rpad.shape[0], n_arr.shape, m_arr.shape, ws.shape, lo_all.shape) != (
            L, (L,), (L,), (L,), (L, N + 1)):
        raise ValueError("qpad, rpad, n_arr, m_arr, ws and lo_all must share the read axis, "
                         "and lo_all have N + 1 rows")
    # B4's private scratch: each row's directions packed to 2 bits a cell
    plane = torch.empty((L, N + 1, w_pad // 4), dtype=torch.uint8, device=dev)
    # the kernel writes each walk's log up to its stop; kind reads STOP after it
    kind = torch.full((N + M, L), _K_STOP, dtype=torch.uint8, device=dev)
    qb = torch.empty((N + M, L), dtype=torch.uint8, device=dev)
    rb = torch.empty((N + M, L), dtype=torch.uint8, device=dev)
    if L:
        lib = _build.load("error_profile_cs")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.error_profile_cs_launch(
                qpad.data_ptr(), rpad.data_ptr(), n_arr.data_ptr(), m_arr.data_ptr(),
                ws.data_ptr(), lo_all.data_ptr(), plane.data_ptr(), kind.data_ptr(),
                qb.data_ptr(), rb.data_ptr(), L, N, M, w_pad, stream,
            )
        _build.check("error_profile_cs", rc)
        error_profile_cs_cuda.launches += 1
        mesh_mod.count_slice_launch(error_profile_cs_cuda.by_slice)
    return kind, qb, rb


error_profile_cs_cuda.launches = 0
error_profile_cs_cuda.by_slice = {}  # slice label -> launches inside sharded calls
