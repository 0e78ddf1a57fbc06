"""Infix (semi-global) fuzzy pattern matching with IUPAC degeneracy.

The counterpart of the JAX package's ``ops/fuzzy_match.py`` (edlib
``mode="HW"`` replacement): find the substring of a window minimizing the
Levenshtein distance to a pattern, a pattern/text pair matching iff their
4-bit IUPAC masks intersect. Tie-break (``DIVERGENCES.md`` §1): among
optimal end positions the smallest end, then among optimal starts for that
end the smallest start.

A column DP over the text, batched over (patterns, windows); the in-column
insertion cascade is ``i + cummin(tmp - i)``. A second pass over the
reversed prefix recovers the start.
"""

from __future__ import annotations

import torch

BIG = 1 << 20


def _final_row(pmask: torch.Tensor, p_len: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """(P, B, Lw+1) int32: entry j = min edit distance of each pattern over
    substrings of window[:j] that end exactly at j.

    pmask (P, m) uint8 (zero-padded past each ``p_len``); windows either
    (B, Lw) shared by every pattern or (P, B, Lw).
    """
    P, m = pmask.shape
    dev = pmask.device
    Lw = windows.shape[-1]
    B = windows.shape[-2]
    pm = pmask.to(torch.int32)[:, None, :]                     # (P, 1, m)
    idx = torch.arange(m + 1, device=dev, dtype=torch.int32)
    col = idx.expand(P, B, m + 1).clone()
    take = p_len.to(torch.int64)[:, None, None].expand(P, B, 1)
    zero = torch.zeros((P, B, 1), dtype=torch.int32, device=dev)
    w = windows.to(torch.int32)
    out = [p_len.to(torch.int32)[:, None].expand(P, B)]
    for j in range(Lw):
        ch = w[..., j][..., None] if w.dim() == 3 else w[None, :, j, None]
        sub = ((pm & ch) == 0).to(torch.int32)
        tmp = torch.minimum(col[..., :-1] + sub, col[..., 1:] + 1)
        base = torch.cat([zero, tmp], dim=-1)
        cascaded = idx + torch.cummin(base - idx, dim=-1).values
        col = torch.minimum(base, cascaded)
        out.append(col.gather(-1, take)[..., 0])
    return torch.stack(out, dim=-1)


def fuzzy_find_multi(pattern_masks: torch.Tensor, pattern_lens: torch.Tensor,
                     windows: torch.Tensor, window_lens: torch.Tensor):
    """Multi-pattern batched infix fuzzy match.

    Args: pattern_masks (P, m) uint8 IUPAC masks zero-padded past each true
    length; pattern_lens (P,); windows (B, Lw) uint8 mask windows;
    window_lens (B,). Returns (dist, start, end), each (P, B) int32.
    """
    P, m = pattern_masks.shape
    B, Lw = windows.shape
    dev = windows.device
    p_lens = pattern_lens.to(device=dev, dtype=torch.int64)
    pmask = pattern_masks.to(dev)
    idx = torch.arange(m, device=dev, dtype=torch.int64)[None, :]
    src = (p_lens[:, None] - 1 - idx).clamp(0, max(m - 1, 0))
    revs = torch.where(idx < p_lens[:, None], pmask.gather(1, src), torch.zeros_like(pmask))

    j = torch.arange(Lw + 1, device=dev, dtype=torch.int32)
    row = _final_row(pmask, p_lens, windows)                      # (P, B, Lw+1)
    masked = torch.where(j <= window_lens.to(dev)[None, :, None], row, BIG)
    dist = masked.min(dim=-1).values
    end = torch.argmin(masked, dim=-1).to(torch.int32)           # first minimum

    r = torch.arange(Lw, device=dev, dtype=torch.int64)
    src_w = (end.to(torch.int64)[..., None] - 1 - r).clamp(0, Lw - 1)   # (P, B, Lw)
    gathered = windows.to(dev)[None].expand(P, B, Lw).gather(-1, src_w)
    rev_prefix = torch.where(r < end[..., None], gathered, torch.zeros_like(gathered))
    rrow = _final_row(revs, p_lens, rev_prefix)
    hits = (j <= end[..., None]) & (rrow == dist[..., None])
    j2 = torch.where(hits, j, -1).max(dim=-1).values
    return dist.to(torch.int32), (end - j2).to(torch.int32), end


def fuzzy_find(pattern_mask: torch.Tensor, windows: torch.Tensor, window_lens: torch.Tensor):
    """Single-pattern :func:`fuzzy_find_multi`; (dist, start, end) each (B,)."""
    m = pattern_mask.shape[0]
    lens = torch.tensor([m], dtype=torch.int32, device=windows.device)
    d, s, e = fuzzy_find_multi(pattern_mask[None], lens, windows, window_lens)
    return d[0], s[0], e[0]
