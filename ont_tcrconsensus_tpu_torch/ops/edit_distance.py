"""Budgeted-dovetail edit distance for short sequences (UMIs).

The counterpart of the JAX package's ``ops/edit_distance.py``: unit-cost
edit distance where up to ``k_end`` terminal bases per end of either
sequence are free (vsearch's free end gaps), beyond that 1/base. A column
DP over the second sequence, batched over pairs; the in-column insertion
cascade is ``i + cummin(base - i)``. Integer DP, equal bit for bit.
"""

from __future__ import annotations

import torch

_BIG = 1 << 20


def pairwise_dovetail(a: torch.Tensor, a_lens: torch.Tensor, b: torch.Tensor,
                      b_lens: torch.Tensor, k_end: int = 8) -> torch.Tensor:
    """(B, La) x (B, Lb) -> (B,) int32 budgeted-dovetail distances."""
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


def many_vs_many_dovetail(queries, q_lens, targets, t_lens, k_end: int = 8) -> torch.Tensor:
    """(Q, L) x (T, L) -> (Q, T) budgeted-dovetail distance matrix."""
    Q, T = queries.shape[0], targets.shape[0]
    d = pairwise_dovetail(
        queries.repeat_interleave(T, dim=0), q_lens.repeat_interleave(T),
        targets.repeat(Q, 1), t_lens.repeat(Q), k_end=k_end,
    )
    return d.reshape(Q, T)
