"""Budgeted-dovetail and global edit distance for short sequences (UMIs).

The counterpart of the JAX package's ``ops/edit_distance.py``: unit-cost
edit distance where up to ``k_end`` terminal bases per end of either
sequence are free (vsearch's free end gaps), beyond that 1/base. Integer
DP, equal bit for bit. :func:`pairwise_dovetail` and
:func:`many_vs_many_dovetail` route by device: CPU tensors to the plain
version (:func:`pairwise_dovetail_plain`, a column DP over the second
sequence, batched over pairs, its in-column insertion cascade
``i + cummin(base - i)``), CUDA tensors to kernel B6
(:mod:`.dovetail_kernel`), one launch a call.

The global (Needleman-Wunsch) distance of the JAX package's ``_nw_pair``
(:func:`pairwise`, :func:`many_vs_many`, :func:`identity_matrix`) is the
dovetail distance at ``k_end = 0``, so it runs on the same routes:
- the boundaries become ``D[i][0] = i`` and a top row of ``j + 1``, the
  global DP's;
- every candidate is ``D[i][j] + (a_len - i) + (b_len - j)``, the cell's
  distance plus both unaligned tails at one edit a base;
- a path from ``D[i][j]`` to ``D[a_len][b_len]`` costs at most those tails
  (insert and delete them), so no candidate is below ``D[a_len][b_len]``,
  which is itself the candidate at ``(a_len, b_len)``: the least is the
  global distance;
- rows below ``a_len`` (padding, any codes) never reach row ``a_len``: a
  column's row i depends on rows up to i only, and columns past ``b_len``
  make no candidate, as ``_nw_pair`` freezes them.
On the card B6's width limit holds here too: first sequences wider than
1452 raise.
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import dovetail_kernel
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

_BIG = 1 << 20


def pairwise_dovetail(a: torch.Tensor, a_lens: torch.Tensor, b: torch.Tensor,
                      b_lens: torch.Tensor, k_end: int = 8) -> torch.Tensor:
    """(B, La) x (B, Lb) -> (B,) int32 budgeted-dovetail distances: the
    plain version on the CPU, kernel B6 for CUDA tensors."""
    if a.device.type == "cpu":
        return pairwise_dovetail_plain(a, a_lens, b, b_lens, k_end)
    return dovetail_kernel.pairwise_dovetail_cuda(a, a_lens, b, b_lens, k_end)


def pairwise_dovetail_plain(a: torch.Tensor, a_lens: torch.Tensor, b: torch.Tensor,
                            b_lens: torch.Tensor, k_end: int = 8) -> torch.Tensor:
    """:func:`pairwise_dovetail` in plain PyTorch on any device (kernel B6's
    yardstick on the card)."""
    B, La = a.shape
    dev = a.device
    i32 = torch.int32
    k = k_end
    iota = torch.arange(La + 1, device=dev, dtype=i32)[None, :]
    a_len = a_lens.to(device=dev, dtype=i32)[:, None]
    b_len = b_lens.to(device=dev, dtype=i32)
    a = a.to(i32)
    b = b.to(device=dev, dtype=i32)
    mask_a = iota <= a_len
    tail_a = (a_len - iota - k).clamp(min=0)
    col = (iota - k).clamp(min=0).expand(B, La + 1)
    best = torch.where(mask_a, col + tail_a, _BIG).min(dim=1).values + (b_len - k).clamp(min=0)
    # columns past every b's length are frozen and never improve the best
    n_cols = min(b.shape[1], int(b_len.max())) if B else 0
    for j in range(n_cols):
        sub = (a != b[:, j : j + 1]).to(i32)
        tmp = torch.minimum(col[:, :-1] + sub, col[:, 1:] + 1)
        edge = torch.full((B, 1), max(j + 1 - k, 0), dtype=i32, device=dev)
        base = torch.cat([edge, tmp], dim=1)
        cascaded = iota + torch.cummin(base - iota, dim=1).values
        active = j < b_len
        col = torch.where(active[:, None], torch.minimum(base, cascaded), col)
        cand = (torch.where(mask_a, col + tail_a, _BIG).min(dim=1).values
                + (b_len - (j + 1) - k).clamp(min=0))
        best = torch.minimum(best, torch.where(active, cand, _BIG))
    return best


def pairwise(a: torch.Tensor, a_lens: torch.Tensor, b: torch.Tensor,
             b_lens: torch.Tensor) -> torch.Tensor:
    """(B, La) x (B, Lb) -> (B,) int32 global edit distances (the JAX
    package's ``pairwise``): :func:`pairwise_dovetail` at ``k_end = 0``."""
    return pairwise_dovetail(a, a_lens, b, b_lens, k_end=0)


def many_vs_many(queries, q_lens, targets, t_lens) -> torch.Tensor:
    """(Q, L) x (T, L) -> (Q, T) int32 global edit-distance matrix:
    :func:`many_vs_many_dovetail` at ``k_end = 0``."""
    return many_vs_many_dovetail(queries, q_lens, targets, t_lens, k_end=0)


def identity_matrix(queries, q_lens, targets, t_lens) -> torch.Tensor:
    """(Q, T) float32 identity ``1 - d / max(len_q, len_t)`` over the global
    distance; 0 where either side is empty."""
    d = many_vs_many(queries, q_lens, targets, t_lens).to(torch.float32)
    q = q_lens.to(device=d.device)[:, None]
    t = t_lens.to(device=d.device)[None, :]
    longest = torch.maximum(q, t).to(torch.float32)
    ident = 1.0 - d / longest.clamp(min=1.0)
    return torch.where((q == 0) | (t == 0), 0.0, ident)


def many_vs_many_dovetail(queries, q_lens, targets, t_lens, k_end: int = 8) -> torch.Tensor:
    """(Q, L) x (T, L) -> (Q, T) budgeted-dovetail distance matrix: the
    plain version on Q x T repeated pairs on the CPU, kernel B6 on the
    Q x T grid for CUDA tensors."""
    if queries.device.type != "cpu":
        return dovetail_kernel.many_vs_many_dovetail_cuda(queries, q_lens, targets, t_lens,
                                                          k_end)
    Q, T = queries.shape[0], targets.shape[0]
    d = pairwise_dovetail_plain(
        queries.repeat_interleave(T, dim=0), q_lens.repeat_interleave(T),
        targets.repeat(Q, 1), t_lens.repeat(Q), k_end=k_end,
    )
    return d.reshape(Q, T)


def pairwise_dovetail_auto(a, a_lens, b, b_lens, k_end: int = 8, mesh=None) -> torch.Tensor:
    """:func:`pairwise_dovetail`, its pair axis split over ``mesh``'s data
    slices when the pair count divides the data-axis size (the UMI
    distance chunks)."""
    if mesh is not None and a.shape[0] % mesh_mod.mesh_data_size(mesh) == 0:
        d1, d2 = mesh_mod.P("data"), mesh_mod.P("data", None)
        return mesh_mod.shard_map_compat(
            lambda *x: pairwise_dovetail(*x, k_end=k_end), mesh,
            in_specs=(d2, d1, d2, d1), out_specs=d1,
        )(a, a_lens, b, b_lens)
    return pairwise_dovetail(a, a_lens, b, b_lens, k_end)


def many_vs_many_dovetail_auto(queries, q_lens, targets, t_lens, k_end: int = 8,
                               mesh=None) -> torch.Tensor:
    """:func:`many_vs_many_dovetail`, its query axis split over ``mesh``'s
    data slices (targets on every slice) when the query count divides the
    data-axis size."""
    if mesh is not None and queries.shape[0] % mesh_mod.mesh_data_size(mesh) == 0:
        d1, d2, rep = mesh_mod.P("data"), mesh_mod.P("data", None), mesh_mod.P()
        return mesh_mod.shard_map_compat(
            lambda *x: many_vs_many_dovetail(*x, k_end=k_end), mesh,
            in_specs=(d2, d1, rep, rep), out_specs=d2,
        )(queries, q_lens, targets, t_lens)
    return many_vs_many_dovetail(queries, q_lens, targets, t_lens, k_end)
