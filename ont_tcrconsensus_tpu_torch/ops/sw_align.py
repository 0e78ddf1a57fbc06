"""Batched banded affine-gap local alignment with traceback-free stats.

The plain PyTorch twin of kernel B1 (``csrc/sw_banded.cu``), and the
counterpart of the JAX package's ``ops/sw_align.align_banded``. Every DP
cell carries four channels — match count, column count, read start, ref
start — that follow the predecessor the score picked, so the best cell
yields (score, read_start/end, ref_start/end, n_match, n_cols) with no
traceback.

Banding: rows are read positions; within a row the band covers ref
positions ``j = i + diag_offset + [-W/2, W/2)``. One Python loop over rows;
each row is a handful of (B, W) int32 tensor ops, the in-row ref-gap
cascade a log2(W) shift-doubling max-plus prefix (:func:`_f_cascade`).

Recurrence (Gotoh, priorities diag/up/fresh >= left on ties):
  E[i][j] = max(H[i-1][j] - open, E[i-1][j]) - ext        (read-consuming gap)
  tmp     = max(H[i-1][j-1] + sub, E[i][j], 0·fresh)
  F[i][j] = max_{l<j}(tmp[i][l] - open - (j-l)·ext)       (ref-consuming gap)
  H[i][j] = max(tmp, F)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG = -(1 << 24)
PAD_SENTINEL = 5  # encode.PAD_CODE: never matches (tbase < 4 check)

MATCH = 2
MISMATCH = 4   # penalty (positive)
GAP_OPEN = 4   # first gap base costs OPEN + EXT
GAP_EXT = 2


@dataclasses.dataclass
class AlignResult:
    """Batched alignment outcome; all fields (B,) int32 tensors.

    ``read_end``/``ref_end`` are exclusive. ``n_cols`` counts alignment
    columns (matches + mismatches + gap bases), so
    ``blast_id = n_match / n_cols``.
    """

    score: torch.Tensor
    read_start: torch.Tensor
    read_end: torch.Tensor
    ref_start: torch.Tensor
    ref_end: torch.Tensor
    n_match: torch.Tensor
    n_cols: torch.Tensor

    @property
    def blast_id(self) -> torch.Tensor:
        """float32 ``n_match / max(n_cols, 1)``."""
        return self.n_match.float() / self.n_cols.clamp(min=1).float()


def shift_up(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x[..., b] -> x[..., b+1]: the (i-1, j) predecessor lives one slot right."""
    pad = torch.full_like(x[..., :1], fill)
    return torch.cat([x[..., 1:], pad], dim=-1)


def shift_right(x: torch.Tensor, step: int, fill: int) -> torch.Tensor:
    """x[..., b] -> x[..., b-step] (bring the value from ``step`` slots left)."""
    pad = torch.full_like(x[..., :step], fill)
    return torch.cat([pad, x[..., :-step]], dim=-1)


def _f_cascade(tmp, tch, gap_open, gap_ext, band_width):
    """Ref-gap (F) values + channels via log2(W) shift-doubling.

    R[b] = max_{l<=b}(tmp[l] - ext*(b-l)) with the origin's channels carried
    through the selects and the gap length accumulated; a candidate replaces
    the current value only when STRICTLY greater, so ties keep the shorter
    gap. Then F[b] = R[b-1] - open - ext with one more gap column.

    ``tmp``: (B, W); ``tch``: (4, B, W) channels. Returns (F, Fch).
    """
    g = tmp
    ch = tch
    gap = torch.zeros_like(tmp)
    step = 1
    while step < band_width:
        cand_g = shift_right(g, step, NEG) - gap_ext * step
        take = cand_g > g
        g = torch.where(take, cand_g, g)
        ch = torch.where(take, shift_right(ch, step, 0), ch)
        gap = torch.where(take, shift_right(gap, step, 0) + step, gap)
        step *= 2
    F = shift_right(g, 1, NEG) - gap_open - gap_ext
    Fch = shift_right(ch, 1, 0)
    Fgap = shift_right(gap, 1, 0) + 1
    Fch[1] += Fgap  # the gap run adds Fgap columns
    return F, Fch


def _ref_windows(refs: torch.Tensor, offs: torch.Tensor, L: int, W: int) -> torch.Tensor:
    """(B, L+W) int32: ``win[b, k] = refs[b, k + off_b - W/2]``, PAD outside
    the array, so row i's band window is ``win[:, i:i+W]``."""
    B, Lr = refs.shape
    ks = torch.arange(L + W, device=refs.device, dtype=torch.int32)[None, :] + offs[:, None] - W // 2
    in_range = (ks >= 0) & (ks < Lr)
    gathered = refs.long().gather(1, ks.clamp(0, max(Lr - 1, 0)).long()).to(torch.int32)
    return torch.where(in_range, gathered, torch.full_like(gathered, PAD_SENTINEL))


def align_banded(
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
    """Elementwise batched local alignment (plain PyTorch).

    Args:
      reads: (B, L) uint8 dense codes; read_lens: (B,).
      refs: (B, Lr) uint8 dense codes; ref_lens: (B,).
      diag_offsets: (B,) — expected ``ref_pos - read_pos`` of the
        alignment; the band is centered on this diagonal.
      band_width: band width W (even).
    """
    B, L = reads.shape
    W = band_width
    c = W // 2
    dev = reads.device
    i32 = torch.int32
    iota = torch.arange(W, device=dev, dtype=i32)[None, :]
    rlen = read_lens.to(i32)[:, None]
    tlen = ref_lens.to(i32)[:, None]
    off = diag_offsets.to(i32)
    reads_i = reads.to(i32)
    win = _ref_windows(refs, off, L, W)
    off = off[:, None]

    H = torch.full((B, W), NEG, dtype=i32, device=dev)
    E = H.clone()
    Hch = torch.zeros((4, B, W), dtype=i32, device=dev)
    Ech = Hch.clone()
    best = torch.zeros((B, 7), dtype=i32, device=dev)
    zeros = torch.zeros((B, W), dtype=i32, device=dev)
    rows = torch.arange(B, device=dev)
    # rows at or past every read's length are all invalid: they cannot move
    # the best cell, so the loop stops at the longest read
    n_rows = min(L, int(rlen.max())) if B else 0
    for i in range(n_rows):
        jrow = i + off - c + iota
        valid = (jrow >= 0) & (jrow < tlen) & (i < rlen)
        rbase = reads_i[:, i : i + 1]
        tbase = win[:, i : i + W]
        is_match = (tbase == rbase) & (rbase < 4) & (tbase < 4)
        sub = torch.where(is_match, match, -mismatch).to(i32)

        # E: read-consuming gap from (i-1, j) = prev row, band slot b+1
        open_sc = shift_up(H, NEG) - gap_open - gap_ext
        ext_sc = shift_up(E, NEG) - gap_ext
        take_open = open_sc >= ext_sc
        E_new = torch.where(take_open, open_sc, ext_sc)
        Ech_new = torch.where(take_open, shift_up(Hch, 0), shift_up(Ech, 0))
        Ech_new[1] += 1  # one more (gap) column

        # diagonal from (i-1, j-1), with a fresh (empty) predecessor allowed
        # too: the local-SW 0-clamp, starting at (i, jrow)
        fresh_pred = H < 0
        D = torch.where(fresh_pred, 0, H) + sub
        Dch = torch.where(
            fresh_pred, torch.stack([zeros, zeros, zeros + i, jrow]), Hch
        )
        Dch[0] += is_match.to(i32)
        Dch[1] += 1

        # tmp = max(D, E, fresh) with priority D >= E >= fresh; a fresh
        # alignment at (i, jrow) starts at (i+1, jrow+1)
        e_better = E_new > D
        tmp = torch.where(e_better, E_new, D)
        tch = torch.where(e_better, Ech_new, Dch)
        f_better = tmp < 0
        tmp = torch.where(f_better, 0, tmp)
        tch = torch.where(
            f_better, torch.stack([zeros, zeros, zeros + (i + 1), jrow + 1]), tch
        )
        tmp = torch.where(valid, tmp, NEG)

        F, Fch = _f_cascade(tmp, tch, gap_open, gap_ext, W)
        take_f = F > tmp
        H = torch.where(valid, torch.where(take_f, F, tmp), NEG)
        Hch = torch.where(take_f, Fch, tch)
        E = torch.where(valid, E_new, NEG)
        Ech = Ech_new

        # best cell: first (smallest slot) strict improvement wins
        b_star = torch.argmax(H, dim=1)
        row_best = H[rows, b_star]
        improve = row_best > best[:, 0]
        cand = torch.stack([
            row_best,
            Hch[2, rows, b_star],
            torch.full_like(row_best, i + 1),
            Hch[3, rows, b_star],
            jrow[rows, b_star] + 1,
            Hch[0, rows, b_star],
            Hch[1, rows, b_star],
        ], dim=1)
        best = torch.where(improve[:, None], cand, best)
    return AlignResult(
        score=best[:, 0], read_start=best[:, 1], read_end=best[:, 2],
        ref_start=best[:, 3], ref_end=best[:, 4],
        n_match=best[:, 5], n_cols=best[:, 6],
    )


def align_np(read, ref, match=MATCH, mismatch=MISMATCH, gap_open=GAP_OPEN, gap_ext=GAP_EXT):
    """Full (unbanded) numpy local alignment with identical semantics.

    Reference implementation for tests: same scoring, same tie priorities
    (diag/up/fresh over left; on the global max, the earlier row then the
    smaller column wins). Returns an :class:`AlignResult` of 0-d int32
    tensors.
    """
    n, m = len(read), len(ref)
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), int(NEG), np.int64)
    F = np.full((n + 1, m + 1), int(NEG), np.int64)
    # channels: (n_match, n_cols, read_start, ref_start)
    Hch = np.zeros((n + 1, m + 1, 4), np.int64)
    Ech = np.zeros((n + 1, m + 1, 4), np.int64)
    Fch = np.zeros((n + 1, m + 1, 4), np.int64)
    for i in range(n + 1):
        Hch[i, :, 2] = i
        Hch[i, :, 3] = np.arange(m + 1)
    best = (0, 0, 0, 0, 0, 0, 0)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            eo = H[i - 1, j] - gap_open - gap_ext
            ee = E[i - 1, j] - gap_ext
            if eo >= ee:
                E[i, j], Ech[i, j] = eo, Hch[i - 1, j].copy()
            else:
                E[i, j], Ech[i, j] = ee, Ech[i - 1, j].copy()
            Ech[i, j, 1] += 1
            is_m = read[i - 1] == ref[j - 1] and read[i - 1] < 4 and ref[j - 1] < 4
            d = H[i - 1, j - 1] + (match if is_m else -mismatch)
            tmp, tch = d, Hch[i - 1, j - 1].copy()
            tch[0] += int(is_m)
            tch[1] += 1
            if E[i, j] > tmp:
                tmp, tch = E[i, j], Ech[i, j].copy()
            if 0 > tmp:
                tmp, tch = 0, np.array([0, 0, i, j])
            fopen = H[i, j - 1] - gap_open - gap_ext
            fext = F[i, j - 1] - gap_ext
            if fopen >= fext:
                F[i, j], Fch[i, j] = fopen, Hch[i, j - 1].copy()
            else:
                F[i, j], Fch[i, j] = fext, Fch[i, j - 1].copy()
            Fch[i, j, 1] += 1
            if F[i, j] > tmp:
                H[i, j], Hch[i, j] = F[i, j], Fch[i, j].copy()
            else:
                H[i, j], Hch[i, j] = tmp, tch
            if H[i, j] > best[0]:
                best = (int(H[i, j]), int(Hch[i, j, 2]), i, int(Hch[i, j, 3]), j,
                        int(Hch[i, j, 0]), int(Hch[i, j, 1]))
    return AlignResult(*[torch.tensor(x, dtype=torch.int32) for x in best])
