"""Iterative pileup-vote consensus (the spoa/medaka-draft replacement).

The counterpart of the JAX package's ``ops/consensus.py`` vote path: each
round aligns every subread to its cluster's current draft
(:func:`.pileup.pileup_columns_batch_auto`, kernel B2 on the card), votes
per column over {A,C,G,T,deletion} and over single-base insertions,
splices the winners in, extends the draft ends by majority, and repeats
until the draft is a fixed point or the rounds run out.

Vote semantics (deterministic): per column the plurality of covering
subreads wins; ties prefer a base over a deletion and the smaller base
code. An insertion is spliced when strictly more than half of the covering
subreads report one; the inserted base is the plurality ``ins_base`` (ties:
smaller code).

The JAX package fuses rounds in pairs into one device program; a cluster
whose draft did not change is a deterministic fixed point, so running the
rounds one at a time over the still-changing clusters gives the same
drafts.
"""

from __future__ import annotations

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.ops import pileup
from ont_tcrconsensus_tpu_torch.ops.encode import PAD_CODE

# the polish path's band width (same-molecule subreads drift only by their
# own indels)
POLISH_BAND_WIDTH = 64


def vote_columns_batch(base_at, ins_cnt, ins_base, drafts, draft_lens):
    """One voting round over C clusters.

    Args: base_at/ins_cnt/ins_base (C, S, Ld); drafts (C, >=Ld) uint8;
    draft_lens (C,). Returns (new_drafts (C, 2*Ld) uint8, new_lens (C,)).
    Slot 2j holds position j, slot 2j+1 the insertion after j; kept slots
    are compacted to the front.
    """
    C, S, Ld = base_at.shape
    dev = base_at.device
    covered = base_at != pileup.UNCOVERED
    depth = covered.sum(dim=1)                                        # (C, Ld)
    counts = torch.stack([(base_at == code).sum(dim=1) for code in range(5)], dim=1)
    order_bonus = torch.tensor([4, 3, 2, 1, 0], device=dev)[None, :, None]
    winner = torch.argmax(counts * 8 + order_bonus, dim=1).to(torch.uint8)
    in_draft = torch.arange(Ld, device=dev)[None, :] < draft_lens.to(dev)[:, None]
    keep_base = torch.where(depth > 0, winner, drafts[:, :Ld].to(torch.uint8))
    slot_base = torch.where(in_draft, keep_base, PAD_CODE).to(torch.uint8)
    slot_keep = in_draft & ~((depth > 0) & (winner == pileup.DELETION))

    has_ins_row = (ins_cnt > 0) & covered
    has_ins = has_ins_row.sum(dim=1)
    do_ins = (has_ins * 2 > depth) & (depth > 0) & in_draft
    ins_counts = torch.stack(
        [((ins_base == code) & has_ins_row).sum(dim=1) for code in range(4)], dim=1
    )
    ins_winner = torch.argmax(ins_counts * 8 + order_bonus[:, :4], dim=1).to(torch.uint8)

    slots = torch.stack(
        [slot_base, torch.where(do_ins, ins_winner, PAD_CODE).to(torch.uint8)], dim=2
    ).reshape(C, 2 * Ld)
    keep = torch.stack([slot_keep, do_ins], dim=2).reshape(C, 2 * Ld)
    new_lens = keep.sum(dim=1).to(torch.int32)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out = torch.full((C, 2 * Ld + 1), PAD_CODE, dtype=torch.uint8, device=dev)
    out.scatter_(1, torch.where(keep, pos, 2 * Ld), slots)  # unkept -> dropped column
    return out[:, : 2 * Ld], new_lens


def _extend_ends_batch(drafts, dlens, subreads, subread_lens, spans, aligned_dlens):
    """Majority-vote single-base extension at each draft end (numpy, host;
    a copy of the JAX package's ``_extend_ends_batch``). Mutates and returns
    (drafts, dlens)."""
    C, S, W = subreads.shape
    r_start, r_end = spans[:, :, 0], spans[:, :, 1]
    f_start, f_end = spans[:, :, 2], spans[:, :, 3]

    def vote(bases, voters):
        votes = np.stack(
            [((bases == code) & voters).sum(axis=1) for code in range(4)], axis=1
        )
        return votes.sum(axis=1) > 0, votes.argmax(axis=1).astype(np.uint8)

    at_left = f_start == 0
    has_more = at_left & (r_start > 0)
    n_at, n_more = at_left.sum(axis=1), has_more.sum(axis=1)
    idx = np.maximum(r_start - 1, 0)
    bases = np.take_along_axis(subreads, idx[:, :, None], axis=2)[:, :, 0]
    have, win = vote(bases, has_more)
    do = (n_at > 0) & (n_more * 2 > n_at) & (dlens < W) & have
    if do.any():
        drafts[do] = np.concatenate([win[do, None], drafts[do, :-1]], axis=1)
        dlens[do] += 1

    # right end (spans were computed against the pre-vote draft)
    at_right = f_end == aligned_dlens[:, None]
    has_more = at_right & (r_end < subread_lens)
    n_at, n_more = at_right.sum(axis=1), has_more.sum(axis=1)
    idx = np.minimum(r_end, W - 1)
    bases = np.take_along_axis(subreads, idx[:, :, None], axis=2)[:, :, 0]
    have, win = vote(bases, has_more)
    do = (n_at > 0) & (n_more * 2 > n_at) & (dlens < W) & have
    if do.any():
        drafts[do, dlens[do]] = win[do]
        dlens[do] += 1
    return drafts, dlens


def consensus_clusters_batch(subreads: np.ndarray, subread_lens: np.ndarray,
                             rounds: int = 4, band_width: int = POLISH_BAND_WIDTH,
                             device: str | torch.device = "cpu"):
    """Consensus of C same-shape clusters; returns (drafts (C, W) uint8,
    draft_lens (C,) int32), numpy.

    Args: subreads (C, S, W) uint8 dense codes in canonical orientation
    (0-length rows are padding); subread_lens (C, S). The draft seed is the
    subread of lower-median length (stable pick).
    """
    C, S, W = subreads.shape
    subread_lens = np.asarray(subread_lens)
    real = subread_lens > 0
    nreal = real.sum(axis=1)
    key = np.where(real, subread_lens, np.iinfo(np.int32).max)
    order = np.argsort(key, axis=1, kind="stable")
    mid = (np.maximum(nreal, 1) - 1) // 2
    seed = np.take_along_axis(order, mid[:, None], axis=1)[:, 0]
    dlens = np.where(nreal > 0, subread_lens[np.arange(C), seed], 0).astype(np.int32)
    pos = np.arange(W, dtype=np.int32)[None, :]
    drafts = np.where(
        pos < dlens[:, None], subreads[np.arange(C), seed], PAD_CODE
    ).astype(np.uint8)

    d_sub = torch.from_numpy(np.ascontiguousarray(subreads)).to(device)
    d_lens = torch.from_numpy(np.ascontiguousarray(subread_lens, dtype=np.int32)).to(device)
    active = np.where(nreal > 0)[0]
    for _ in range(rounds):
        if len(active) == 0:
            break
        a_idx = torch.from_numpy(active).to(device)
        sub_a, lens_a = d_sub[a_idx], d_lens[a_idx]
        drafts_a, dlens_a = drafts[active], dlens[active]
        t_drafts = torch.from_numpy(drafts_a).to(device)
        t_dlens = torch.from_numpy(dlens_a).to(device)
        base_at, ins_cnt, ins_base, _, spans = pileup.pileup_columns_batch_auto(
            sub_a, lens_a, t_drafts, t_dlens, band_width=band_width, out_len=W,
        )
        new_drafts, new_lens = vote_columns_batch(base_at, ins_cnt, ins_base, t_drafts, t_dlens)
        new_drafts = new_drafts[:, :W].cpu().numpy().copy()
        new_lens = new_lens.cpu().numpy().astype(np.int32)
        if (new_lens > W).any():
            raise ValueError("consensus grew past the padded width")
        new_drafts, new_lens = _extend_ends_batch(
            new_drafts, new_lens, subreads[active], subread_lens[active],
            spans.cpu().numpy(), dlens_a,
        )
        stable = (new_lens == dlens_a) & (new_drafts == drafts_a).all(axis=1)
        drafts[active] = new_drafts
        dlens[active] = new_lens
        active = active[~stable]
    return drafts, dlens
