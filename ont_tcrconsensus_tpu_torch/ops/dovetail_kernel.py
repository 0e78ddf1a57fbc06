"""Kernel B6 (``csrc/dovetail.cu``): the UMI budgeted-dovetail distance on
the card.

Replaces the JAX package's device program ``ops/edit_distance._dovetail_pair``
(a jitted ``lax.scan`` over the second sequence, vmapped by
``pairwise_dovetail`` and ``many_vs_many_dovetail``). In the port
:func:`.edit_distance.pairwise_dovetail` and
:func:`.edit_distance.many_vs_many_dovetail` route CUDA tensors here: the
UMI clustering's distance passes and the rescue pass. Same contract as the
plain :func:`.edit_distance.pairwise_dovetail_plain`, bit for bit, in one
launch; each pair reads its own lengths on the card (no host sync). A
thread a pair, each column a bit-parallel step over a's 64-row words
(``csrc/bitvector.cuh``), the answer read from the corner of the last
k_end + 1 rows and columns; first sequences up to 1452 wide.
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import _build
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod


def dovetail_cuda(a, a_lens, b, b_lens, n_pairs: int, T: int, k_end: int) -> torch.Tensor:
    """One B6 launch over ``n_pairs`` pairs: a row i and b row i (T = 0),
    or the Q x T grid's query i // T and target i % T. Its counters
    (``.launches``, ``.by_slice``) count both public wrappers' launches;
    ``.launches_nw`` counts those at k_end 0."""
    if a.device.type != "cuda":
        raise ValueError(f"the dovetail kernel needs CUDA tensors, got {a.device}")
    dev = a.device
    a = a.to(torch.uint8).contiguous()
    b = b.to(device=dev, dtype=torch.uint8).contiguous()
    al = a_lens.to(device=dev, dtype=torch.int32).contiguous()
    bl = b_lens.to(device=dev, dtype=torch.int32).contiguous()
    if al.shape != (a.shape[0],) or bl.shape != (b.shape[0],):
        raise ValueError("a_lens and b_lens must have one length a row")
    out = torch.empty((n_pairs,), dtype=torch.int32, device=dev)
    if n_pairs:
        lib = _build.load("dovetail")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.dovetail_launch(a.data_ptr(), al.data_ptr(), b.data_ptr(), bl.data_ptr(),
                                     out.data_ptr(), n_pairs, T, a.shape[1], b.shape[1],
                                     int(k_end), stream)
        _build.check("dovetail", rc)
        dovetail_cuda.launches += 1
        dovetail_cuda.launches_nw += int(k_end) == 0
        mesh_mod.count_slice_launch(dovetail_cuda.by_slice)
    return out


dovetail_cuda.launches = 0
dovetail_cuda.launches_nw = 0  # of them, launches at k_end 0 (the global distance)
dovetail_cuda.by_slice = {}  # slice label -> launches inside sharded calls


def pairwise_dovetail_cuda(a, a_lens, b, b_lens, k_end: int = 8) -> torch.Tensor:
    """Launch kernel B6 on CUDA tensors: (B, La) x (B, Lb) codes -> (B,)
    int32 budgeted-dovetail distances."""
    if b.shape[0] != a.shape[0]:
        raise ValueError("a and b must share the pair axis")
    return dovetail_cuda(a, a_lens, b, b_lens, a.shape[0], 0, k_end)


def many_vs_many_dovetail_cuda(queries, q_lens, targets, t_lens, k_end: int = 8) -> torch.Tensor:
    """Launch kernel B6 on CUDA tensors over the Q x T grid: (Q, L) x (T, L)
    codes -> (Q, T) int32 distances, no repeated copies made."""
    Q, T = queries.shape[0], targets.shape[0]
    return dovetail_cuda(queries, q_lens, targets, t_lens, Q * T, T, k_end).reshape(Q, T)

