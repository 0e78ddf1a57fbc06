"""Infix (semi-global) fuzzy pattern matching with IUPAC degeneracy.

The counterpart of the JAX package's ``ops/fuzzy_match.py`` (edlib
``mode="HW"`` replacement): find the substring of a window minimizing the
Levenshtein distance to a pattern, a pattern/text pair matching iff their
4-bit IUPAC masks intersect. Tie-break (``DIVERGENCES.md`` §1): among
optimal end positions the smallest end, then among optimal starts for that
end the smallest start.

:func:`fuzzy_find_multi` routes by the windows' device: CPU tensors to the
plain version (:func:`fuzzy_find_multi_plain`, a column DP over the text,
batched over (patterns, windows), its in-column insertion cascade
``i + cummin(tmp - i)``, and a second pass over the reversed prefix for the
start), CUDA tensors to kernel B5 (:mod:`.fuzzy_kernel`), one launch a call.
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import fuzzy_kernel

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
    window_lens (B,). Returns (dist, start, end), each (P, B) int32: the
    plain version for windows on the CPU, kernel B5 for CUDA windows.
    """
    if windows.device.type == "cpu":
        return fuzzy_find_multi_plain(pattern_masks, pattern_lens, windows, window_lens)
    return fuzzy_kernel.fuzzy_find_multi_cuda(pattern_masks, pattern_lens, windows, window_lens)


def fuzzy_find_multi_plain(pattern_masks: torch.Tensor, pattern_lens: torch.Tensor,
                           windows: torch.Tensor, window_lens: torch.Tensor):
    """:func:`fuzzy_find_multi` in plain PyTorch on any device (kernel B5's
    yardstick on the card)."""
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


def fuzzy_find_np(pattern: str, text: str):
    """Pure-Python reference with identical tie-breaking (for tests and
    debugging): (dist, start, end) of the best infix match of ``pattern``
    in ``text``."""
    import numpy as np

    from ont_tcrconsensus_tpu_torch.ops import encode

    p = encode.encode_mask(pattern)
    t = encode.encode_mask(text)
    m, n = len(p), len(t)
    D = np.zeros((m + 1, n + 1), dtype=np.int64)
    D[:, 0] = np.arange(m + 1)
    for jj in range(1, n + 1):
        for ii in range(1, m + 1):
            sub = 0 if (p[ii - 1] & t[jj - 1]) else 1
            D[ii, jj] = min(D[ii - 1, jj - 1] + sub, D[ii - 1, jj] + 1, D[ii, jj - 1] + 1)
        D[0, jj] = 0
    dist = int(D[m].min())
    end = int(D[m].argmin())
    starts = [
        s
        for s in range(end + 1)
        if _lev_np(p, t[s:end]) == dist
    ]
    return dist, min(starts), end


def _lev_np(pmask, tmask):
    """Global Levenshtein distance of two IUPAC mask arrays."""
    import numpy as np

    m, n = len(pmask), len(tmask)
    D = np.zeros((m + 1, n + 1), dtype=np.int64)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = 0 if (pmask[i - 1] & tmask[j - 1]) else 1
            D[i, j] = min(D[i - 1, j - 1] + sub, D[i - 1, j] + 1, D[i, j - 1] + 1)
    return int(D[m, n])
