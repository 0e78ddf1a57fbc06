"""Iterative pileup-vote consensus (the spoa/medaka-draft replacement).

The counterpart of the JAX package's ``ops/consensus.py`` vote path: each
round aligns every subread to its cluster's current draft
(:func:`.pileup.pileup_columns_batch_auto`, kernel B2 on the card), votes
per column over {A,C,G,T,deletion} and over single-base insertions,
splices the winners in, extends the draft ends by majority, and repeats
until the draft is a fixed point or the rounds run out:
:func:`consensus_cluster` for one cluster, :func:`consensus_clusters_batch`
for C clusters at once.

Vote semantics (deterministic): per column the plurality of covering
subreads wins; ties prefer a base over a deletion and the smaller base
code. An insertion is spliced when strictly more than half of the covering
subreads report one; the inserted base is the plurality ``ins_base`` (ties:
smaller code).

:func:`consensus_clusters_batch` runs rounds in pairs with one readback a
pair where the JAX package fuses them (on the card, under a mesh, at widths
of 1024 and up, or with ``force_fused``): each half of the pair is a round
plus the host loop's bookkeeping on the device (dead-cluster restore,
overflow flag, :func:`_extend_ends_device`, stability). A cluster whose
draft did not change is a deterministic fixed point, so the pair's round-2
pileup is the final draft's pileup for every cluster stable at round 2,
and a pair gives the drafts two single rounds give.

:func:`pileup_features` and :func:`pileup_features_v4` turn a (C, S, W)
pileup tile into the bi-GRU polisher's per-position features
(``models/polisher.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.io import bucketing
from ont_tcrconsensus_tpu_torch.obs import device as obs_device
from ont_tcrconsensus_tpu_torch.ops import pileup
from ont_tcrconsensus_tpu_torch.ops.encode import PAD_CODE
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

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
    # made on the device: a host constant's upload would wait for the stream
    order_bonus = torch.arange(4, -1, -1, device=dev)[None, :, None]
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


def vote_columns(base_at, ins_cnt, ins_base, draft, draft_len):
    """One voting round of one cluster (the JAX package's ``vote_columns``):
    :func:`vote_columns_batch` at C = 1 on the tensors' device.

    Args: base_at/ins_cnt/ins_base (S, Ld); draft (>=Ld,) uint8; draft_len
    a scalar. Returns (new_draft (2*Ld,) uint8, new_len int32 scalar).
    """
    dev = base_at.device
    lens = torch.as_tensor(draft_len, dtype=torch.int32, device=dev).reshape(1)
    new, new_len = vote_columns_batch(base_at[None], ins_cnt[None], ins_base[None],
                                      draft.to(dev)[None], lens)
    return new[0], new_len[0]


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


def _extend_ends_device(drafts, dlens, subreads, subread_lens, spans, aligned_dlens):
    """:func:`_extend_ends_batch` on device tensors, equal bit for bit: the
    same boundary, majority and width gates, the right end after the left,
    and the first-max tie-break (each base's votes times 4 plus a bonus
    that favours the smaller code, so no two candidates tie). Both ends'
    votes are counted at once, in a few launches. Returns (drafts, dlens)
    without mutating."""
    C, S, W = subreads.shape
    dev = drafts.device
    r_start, r_end, f_start, f_end = spans.unbind(2)
    dlens = dlens.to(torch.int32)
    # (C, 2, S): the subreads at the left and right boundary, those with a
    # read base beyond it, and that base
    at = torch.stack([f_start == 0, f_end == aligned_dlens.to(f_end.dtype)[:, None]], dim=1)
    more = at & torch.stack([r_start > 0, r_end < subread_lens], dim=1)
    idx = torch.stack([torch.clamp(r_start - 1, min=0), torch.clamp(r_end, max=W - 1)], dim=2)
    bases = subreads.gather(2, idx.long()).transpose(1, 2)
    votes = ((bases[..., None] == torch.arange(4, device=dev)) & more[..., None]).sum(dim=2)
    win = torch.argmax(votes * 4 + torch.arange(3, -1, -1, device=dev), dim=2).to(torch.uint8)
    n_at = at.sum(dim=2)
    ok = (n_at > 0) & (more.sum(dim=2) * 2 > n_at) & (votes.sum(dim=2) > 0)

    do = ok[:, 0] & (dlens < W)
    drafts = torch.where(do[:, None], torch.cat([win[:, :1], drafts[:, :-1]], dim=1), drafts)
    dlens = dlens + do.to(torch.int32)
    # right end (spans were computed against the pre-vote draft)
    do = ok[:, 1] & (dlens < W)
    pos = torch.arange(W, device=dev)[None, :]
    drafts = torch.where(do[:, None] & (pos == dlens[:, None]), win[:, 1:], drafts)
    dlens = dlens + do.to(torch.int32)
    return drafts, dlens


def _half_round(sub, slens, drafts, dlens, band_width: int):
    """One round of a fused pair and the host loop's bookkeeping, on the
    device, as a generator for :func:`..parallel.mesh.lockstep`: the pileup
    (kernels B2 and B3 on the card), the vote, the dead-cluster restore,
    the overflow flag, the end extension and the stability flag. Returns
    (drafts, dlens, over, stable, base_at, ins_cnt, ins_base, pos_at)."""
    C, S, W = sub.shape
    reads = sub.reshape(C * S, W)
    refs = drafts.repeat_interleave(S, dim=0)
    reflens = dlens.repeat_interleave(S)
    cols = yield from pileup._forward_traceback(reads, slens.reshape(C * S), refs, reflens,
                                                band_width, W)
    base_at, ins_cnt, ins_base, pos_at = (x.reshape(C, S, W) for x in cols[:4])
    spans = cols[4].reshape(C, S, 4)
    nd, nl = vote_columns_batch(base_at, ins_cnt, ins_base, drafts, dlens)
    live = dlens > 0
    # empty and padding clusters keep their draft
    nd = torch.where(live[:, None], nd[:, :W], drafts)
    nl = torch.where(live, nl, dlens)
    over = live & (nl > W)
    d_ext, l_ext = _extend_ends_device(nd, nl, sub, slens, spans, dlens)
    stable = (l_ext == dlens) & (d_ext == drafts).all(dim=1)
    return d_ext, l_ext, over, stable, base_at, ins_cnt, ins_base, pos_at


def _pair_program(sub, slens, drafts, dlens, band_width: int, with_pos: bool):
    """Two consensus rounds with no readback between them (the JAX
    package's ``_fused_pair_fn``), a generator for
    :func:`..parallel.mesh.lockstep`. Returns (drafts2, dlens2, over1,
    over2, stable2, base_at, ins_cnt, ins_base, pos_at or None): the
    overflow flags of both rounds, round 2's fixed-point flag and round
    2's pileup, which is the final draft's exactly where ``stable2``."""
    slens = slens.to(torch.int32)
    d1, l1, over1, *_ = yield from _half_round(sub, slens, drafts, dlens.to(torch.int32),
                                               band_width)
    d2, l2, over2, stable2, ba, ic, ib, pa = yield from _half_round(sub, slens, d1, l1,
                                                                    band_width)
    return d2, l2, over1, over2, stable2, ba, ic, ib, pa if with_pos else None


def _extend_ends(draft, draft_len, subreads, subread_lens, spans, aligned_draft_len):
    """One cluster's majority-vote single-base extension at each draft end
    (numpy, host; a copy of the JAX package's ``_extend_ends``): among the
    subreads whose alignment reaches a draft boundary, a strict majority
    carrying read bases beyond it votes the plurality base onto that end."""
    r_start, r_end, f_start, f_end = spans[:, 0], spans[:, 1], spans[:, 2], spans[:, 3]
    at_left = f_start == 0
    has_more = at_left & (r_start > 0)
    if at_left.sum() and has_more.sum() * 2 > at_left.sum() and draft_len < draft.shape[0]:
        bases = subreads[has_more, np.maximum(r_start[has_more] - 1, 0)]
        bc = np.bincount(bases[bases < 4], minlength=4)
        if bc.sum():
            draft = np.concatenate([[np.uint8(bc.argmax())], draft[:-1]])
            draft_len += 1
    # right end (spans were computed against the pre-vote draft)
    at_right = f_end == aligned_draft_len
    has_more = at_right & (r_end < subread_lens)
    if at_right.sum() and has_more.sum() * 2 > at_right.sum():
        bases = subreads[has_more, np.minimum(r_end[has_more], subreads.shape[1] - 1)]
        bc = np.bincount(bases[bases < 4], minlength=4)
        if bc.sum() and draft_len < draft.shape[0]:
            draft = draft.copy()
            draft[draft_len] = np.uint8(bc.argmax())
            draft_len += 1
    return draft, draft_len


def consensus_cluster(subreads: np.ndarray, subread_lens: np.ndarray, rounds: int = 4,
                      band_width: int = POLISH_BAND_WIDTH, pad_to: int | None = None,
                      device: str | torch.device | None = None) -> tuple[np.ndarray, int]:
    """Consensus of one cluster's subreads on ``device`` (the card when
    None): the JAX package's single-cluster driver, one pileup
    (:func:`.pileup.pileup_columns`, kernel B2 on the card) and vote a
    round, stopping early at a fixed point.

    Args: subreads (S, L) uint8 codes in canonical orientation (0-length
    rows are padding); subread_lens (S,); ``pad_to`` the draft's width
    (L when None). The seed is the subread of lower-median length (stable
    pick). Returns (draft (width,) uint8 padded, draft length); raises
    ``ValueError`` when a round's draft grows past the width.
    """
    device = resolve_device(device)
    subreads = np.asarray(subreads)
    subread_lens = np.asarray(subread_lens)
    S, L = subreads.shape
    width = int(pad_to or L)
    real = np.where(subread_lens > 0)[0]
    if len(real) == 0:
        return np.full((width,), PAD_CODE, np.uint8), 0
    order = real[np.argsort(subread_lens[real], kind="stable")]
    seed = int(order[(len(real) - 1) // 2])
    draft = np.full((width,), PAD_CODE, np.uint8)
    n = int(subread_lens[seed])
    draft[:n] = subreads[seed, :n]
    draft_len = n
    d_sub = torch.from_numpy(np.ascontiguousarray(subreads)).to(device)
    d_lens = torch.from_numpy(np.ascontiguousarray(subread_lens, dtype=np.int32)).to(device)
    offsets = np.zeros((S,), np.int32)
    for _ in range(rounds):
        t_draft = torch.from_numpy(draft).to(device)
        t_len = torch.tensor([draft_len], dtype=torch.int32, device=device)
        base_at, ins_cnt, ins_base, _, spans = pileup.pileup_columns(
            d_sub, d_lens, t_draft, t_len[0], offsets, band_width=band_width,
            out_len=width, device=device)
        new_draft, new_len = vote_columns_batch(
            base_at[None], ins_cnt[None], ins_base[None], t_draft[None], t_len)
        new_draft, new_len, spans = obs_device.timed_get(
            "consensus.get", (new_draft[0, :width], new_len[0], spans))
        new_len = int(new_len)
        if new_len > width:
            raise ValueError("consensus grew past the padded width")
        cand, new_len = _extend_ends(new_draft.copy(), new_len, subreads, subread_lens, spans,
                                     draft_len)
        unchanged = new_len == draft_len and (cand[:new_len] == draft[:new_len]).all()
        draft, draft_len = cand, new_len
        if unchanged:
            break
    return draft, int(draft_len)


def _use_fused(force_fused: bool, mesh, device: torch.device, W: int) -> bool:
    """Whether rounds run in pairs: the JAX package's ``use_fused`` rule
    (an accelerator, a mesh, widths of 1024 and up, or ``force_fused``)."""
    return force_fused or mesh is not None or device.type != "cpu" or W >= 1024


def consensus_clusters_batch(subreads: np.ndarray, subread_lens: np.ndarray,
                             rounds: int = 4, band_width: int = POLISH_BAND_WIDTH,
                             keep_final_pileup: bool = False, keep_pos: bool = True,
                             device: str | torch.device | None = None, mesh=None,
                             force_fused: bool = False):
    """Consensus of C same-shape clusters on ``device`` (the card when
    None); returns (drafts (C, W) uint8, draft_lens (C,) int32), numpy,
    and with ``keep_final_pileup`` a third item, the final pileup.

    Args: subreads (C, S, W) uint8 dense codes in canonical orientation
    (0-length rows are padding); subread_lens (C, S). The draft seed is the
    subread of lower-median length (stable pick).

    Rounds run in pairs, one readback a pair (:func:`_pair_program`), on
    the card, under a mesh, at widths of 1024 and up, or with
    ``force_fused``: the JAX package's ``use_fused`` rule. An odd last
    round, and every round on the CPU below width 1024, runs alone: the
    pileup and vote on the device, one readback, the ends extended on the
    host. Both give the same drafts and the same kept pileup.

    ``keep_final_pileup``: also return ``(base_at, ins_cnt, ins_base,
    pos_at)``, each (C, S, W) on ``device``: every cluster's pileup from
    the round in which its draft stopped changing, so computed against the
    returned draft, which the polisher can then skip recomputing. Clusters
    never polished (no subreads) read ``UNCOVERED``, 0, 0 and -1.
    ``keep_pos=False`` returns ``pos_at`` None (only the v4 features read
    it). The pileup is None when the rounds ran out with any cluster still
    changing.

    ``mesh`` splits each round's pileup lanes and the vote's cluster axis
    (a pair: its clusters) over the mesh's data slices
    (:mod:`..parallel.mesh`); ``device`` is the first slice's, where the
    pileup gathers. The mesh is dropped when C does not divide the
    data-axis size. A round under a mesh runs the
    still-changing clusters padded to a power of two (at least the
    data-axis size; padding repeats cluster 0 and is never read), or all
    C clusters when the axis is not a power of two or the padding would
    reach C, as in the JAX package; each cluster's draft is the same
    either way.
    """
    device = resolve_device(device)
    C, S, W = subreads.shape
    if mesh is not None and C % mesh_mod.mesh_data_size(mesh) != 0:
        mesh = None
    n_data = mesh_mod.mesh_data_size(mesh) if mesh is not None else 1
    use_fused = _use_fused(force_fused, mesh, device, W)
    # compaction needs power-of-two sub-batches to divide the data axis
    can_compact = (n_data & (n_data - 1)) == 0
    with_pos = keep_final_pileup and keep_pos
    vote = vote_columns_batch

    def pair(*args):
        return mesh_mod.lockstep([_pair_program(*args, band_width, with_pos)])[0]

    if mesh is not None:
        d1, d2, d3 = mesh_mod.P("data"), mesh_mod.P("data", None), mesh_mod.P("data", None, None)
        vote = mesh_mod.shard_map_compat(vote_columns_batch, mesh,
                                         in_specs=(d3, d3, d3, d2, d1), out_specs=(d2, d1))
        pair = mesh_mod.shard_map_compat(
            lambda *a: _pair_program(*a, band_width, with_pos), mesh,
            in_specs=(d3, d2, d2, d1), out_specs=(d2, d1, d1, d1, d1, d3, d3, d3, d3))
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
    pile_parts = []  # (cluster indices, planes) of each round's converged clusters
    active = np.where(nreal > 0)[0]
    rounds_left = rounds
    while rounds_left > 0 and len(active):
        take = 2 if use_fused and rounds_left >= 2 else 1
        rounds_left -= take
        # the round's clusters: ``idx``, whose positions ``sel`` hold the
        # active ones (the rest is mesh padding or, in a full round,
        # clusters that already converged)
        if mesh is None:
            idx, sel = active, np.arange(len(active))
        else:
            Ca = max(bucketing.pow2_ceil(len(active)), n_data) if can_compact else C
            if Ca >= C:
                idx, sel = np.arange(C), active
            else:
                idx = np.concatenate([active, np.zeros(Ca - len(active), np.int64)])
                sel = np.arange(len(active))
        a_idx = torch.from_numpy(idx).to(device)
        sub_a, lens_a = d_sub[a_idx], d_lens[a_idx]
        drafts_a, dlens_a = drafts[idx], dlens[idx]
        t_drafts = torch.from_numpy(drafts_a).to(device)
        t_dlens = torch.from_numpy(dlens_a).to(device)
        if take == 2:
            # two rounds, their extensions, overflow and stability on the
            # device: the pair's one readback, credited like a round's
            new_drafts, new_lens, over1, over2, stable, *planes = pair(
                sub_a, lens_a, t_drafts, t_dlens)
            base_at, ins_cnt, ins_base, pos_at = planes
            new_drafts, new_lens, over1, over2, stable = obs_device.timed_get(
                "consensus.get", (new_drafts, new_lens, over1, over2, stable))
            if over1.any() or over2.any():
                raise ValueError("consensus grew past the padded width")
            new_drafts, new_lens, stable = new_drafts[sel], new_lens[sel], stable[sel]
        else:
            base_at, ins_cnt, ins_base, pos_at, spans = pileup.pileup_columns_batch_auto(
                sub_a, lens_a, t_drafts, t_dlens, band_width=band_width, out_len=W, mesh=mesh,
            )
            new_drafts, new_lens = vote(base_at, ins_cnt, ins_base, t_drafts, t_dlens)
            # one coalesced readback a round; its wait credits the enclosing
            # dispatch frame (polish.dispatch)
            new_drafts, new_lens, spans = obs_device.timed_get(
                "consensus.get", (new_drafts[:, :W], new_lens, spans))
            new_drafts, new_lens, spans = (new_drafts[sel], new_lens[sel].astype(np.int32),
                                           spans[sel])
            if (new_lens > W).any():
                raise ValueError("consensus grew past the padded width")
            new_drafts, new_lens = _extend_ends_batch(
                new_drafts, new_lens, subreads[active], subread_lens[active], spans,
                dlens_a[sel],
            )
            stable = (new_lens == dlens_a[sel]) & (new_drafts == drafts_a[sel]).all(axis=1)
        drafts[active] = new_drafts
        dlens[active] = new_lens
        if keep_final_pileup and stable.any():
            local = torch.from_numpy(sel[stable]).to(device)
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
