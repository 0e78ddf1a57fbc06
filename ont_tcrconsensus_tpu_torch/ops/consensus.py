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

:func:`pileup_features` and :func:`pileup_features_v4` turn a (C, S, W)
pileup tile into the bi-GRU polisher's per-position features
(``models/polisher.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
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
                             keep_final_pileup: bool = False, keep_pos: bool = True,
                             device: str | torch.device | None = None):
    """Consensus of C same-shape clusters on ``device`` (the card when
    None); returns (drafts (C, W) uint8, draft_lens (C,) int32), numpy,
    and with ``keep_final_pileup`` a third item, the final pileup.

    Args: subreads (C, S, W) uint8 dense codes in canonical orientation
    (0-length rows are padding); subread_lens (C, S). The draft seed is the
    subread of lower-median length (stable pick).

    ``keep_final_pileup``: also return ``(base_at, ins_cnt, ins_base,
    pos_at)``, each (C, S, W) on ``device``: every cluster's pileup from
    the round in which its draft stopped changing, so computed against the
    returned draft, which the polisher can then skip recomputing. Clusters
    never polished (no subreads) read ``UNCOVERED``, 0, 0 and -1.
    ``keep_pos=False`` returns ``pos_at`` None (only the v4 features read
    it). The pileup is None when the rounds ran out with any cluster still
    changing.
    """
    device = resolve_device(device)
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
    with_pos = keep_final_pileup and keep_pos
    pile_parts = []  # (cluster indices, planes) of each round's converged clusters
    active = np.where(nreal > 0)[0]
    for _ in range(rounds):
        if len(active) == 0:
            break
        a_idx = torch.from_numpy(active).to(device)
        sub_a, lens_a = d_sub[a_idx], d_lens[a_idx]
        drafts_a, dlens_a = drafts[active], dlens[active]
        t_drafts = torch.from_numpy(drafts_a).to(device)
        t_dlens = torch.from_numpy(dlens_a).to(device)
        base_at, ins_cnt, ins_base, pos_at, spans = pileup.pileup_columns_batch_auto(
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
        if keep_final_pileup and stable.any():
            local = torch.from_numpy(np.where(stable)[0]).to(device)
            planes = (base_at, ins_cnt, ins_base) + ((pos_at,) if with_pos else ())
            pile_parts.append((active[stable], tuple(p[local] for p in planes)))
        active = active[~stable]
    if not keep_final_pileup:
        return drafts, dlens
    if len(active):  # the rounds ran out with a cluster still changing
        return drafts, dlens, None
    final = [
        torch.full((C, S, W), pileup.UNCOVERED, dtype=torch.uint8, device=device),
        torch.zeros((C, S, W), dtype=torch.int32, device=device),
        torch.zeros((C, S, W), dtype=torch.uint8, device=device),
    ] + ([torch.full((C, S, W), -1, dtype=torch.int32, device=device)] if with_pos else [])
    for idx, planes in pile_parts:
        rows = torch.from_numpy(idx).to(device)
        for buf, part in zip(final, planes):
            buf[rows] = part
    return drafts, dlens, (*final[:3], final[3] if with_pos else None)


# ---------------------------------------------------------------------------
# the polisher's features


def _draft_one_hot(drafts, Ld: int):
    """(C, Ld, 4) one-hot of the draft bases; N and padding are all zero."""
    return (drafts[:, :Ld, None].long()
            == torch.arange(4, device=drafts.device)).to(torch.float32)


def _insertion_counts(base_at, ins_cnt, ins_base):
    """(C, Ld, 4) counts of subreads reporting an insertion starting with
    each base after a position, and (C, Ld, 1) of those reporting any."""
    has_ins = (ins_cnt > 0) & (base_at != pileup.UNCOVERED)
    per_base = torch.stack(
        [(has_ins & (ins_base == code)).sum(dim=1) for code in range(4)], dim=2
    ).to(torch.float32)
    return per_base, has_ins.sum(dim=1).to(torch.float32)[..., None]


def pileup_features(base_at, ins_cnt, ins_base, drafts):
    """(C, S, Ld) pileup columns -> (C, Ld, 15) float32 polisher features.

    Channels, all log1p-scaled but the last four: A/C/G/T/deletion counts
    (5), per-base counts of insertions starting after the position (4),
    the insertion-reporting count (1), depth (1); the draft base one-hot
    (4). ``drafts`` (C, >=Ld).
    """
    Ld = base_at.shape[2]
    counts = torch.stack(
        [(base_at == code).sum(dim=1) for code in range(5)], dim=2
    ).to(torch.float32)
    ins_counts, ins = _insertion_counts(base_at, ins_cnt, ins_base)
    depth = (base_at != pileup.UNCOVERED).sum(dim=1).to(torch.float32)[..., None]
    return torch.cat(
        [torch.log1p(counts), torch.log1p(ins_counts), torch.log1p(ins),
         torch.log1p(depth), _draft_one_hot(drafts, Ld)], dim=2,
    )


FEATURE_DIM_V4 = 25
# phred fill when the input carried no qualities (FASTA); the v4 weights
# trained with the same fill on a fraction of examples
QUAL_FILL = 18


def pileup_features_v4(base_at, ins_cnt, ins_base, drafts, pos_at, quals, is_rev):
    """(C, S, Ld) pileup columns -> (C, Ld, 25) float32 v4 features.

    Channels: 0-4 A/C/G/T/deletion counts of forward-strand subreads and
    5-9 of reverse-strand ones (log1p); 10-13 quality-weighted base counts,
    the sum of phred/10 over the subreads voting each base (log1p); 14 the
    mean phred/10 of the base votes; 15-18 per-base insertion counts and 19
    the insertion-reporting count (log1p); 20 depth (log1p); 21-24 the
    draft base one-hot.

    Beyond the v1 set: ``pos_at`` (C, S, Ld) int32 read position of each
    base vote (-1 for deletion or uncovered), ``quals`` (C, S, Lr) uint8
    phred in canonical orientation (reversed for '-' reads), ``is_rev``
    (C, S) bool sequenced-strand flags.
    """
    Ld = base_at.shape[2]
    rev = is_rev.to(torch.bool)[:, :, None]
    counts_f = torch.stack(
        [((base_at == code) & ~rev).sum(dim=1) for code in range(5)], dim=2
    ).to(torch.float32)
    counts_r = torch.stack(
        [((base_at == code) & rev).sum(dim=1) for code in range(5)], dim=2
    ).to(torch.float32)
    voted = (base_at < 4) & (pos_at >= 0)  # a real base vote at a read position
    q = quals.gather(2, pos_at.clamp(0, quals.shape[2] - 1).long()).to(torch.float32) / 10.0
    q = torch.where(voted, q, 0.0)
    qw = torch.stack([(q * (base_at == code)).sum(dim=1) for code in range(4)], dim=2)
    n_base = voted.sum(dim=1).to(torch.float32)
    q_mean = (q.sum(dim=1) / torch.clamp(n_base, min=1.0))[..., None]
    ins_counts, ins = _insertion_counts(base_at, ins_cnt, ins_base)
    depth = (base_at != pileup.UNCOVERED).sum(dim=1).to(torch.float32)[..., None]
    return torch.cat(
        [torch.log1p(counts_f), torch.log1p(counts_r), torch.log1p(qw), q_mean,
         torch.log1p(ins_counts), torch.log1p(ins), torch.log1p(depth),
         _draft_one_hot(drafts, Ld)], dim=2,
    )
