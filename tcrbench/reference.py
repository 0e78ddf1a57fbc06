"""The plain reference the benchmark judges each lane's outputs by.

NumPy and plain PyTorch on the host, importing nothing of the program. It
works out again, from the generated library and the configuration's knobs:

- round-1 assign of a sample of reads: the primer trim (IUPAC infix edit
  distance, the smallest distance, ties to the earliest primer), the
  expected-error and length filter over the trimmed span, and both UMIs
  (pattern, window and tie rules as the configuration states them);
- the reference panel's region clusters (pairs at an edit identity of at
  least ``1 - max_ee_rate_base``, joined);
- the consensus of a cluster from its subreads: rounds of banded
  alignment to the draft (Gotoh, band centred on the diagonal), column
  votes, end extension, then, under ``rnn``, the bi-GRU polisher's
  features, network and confidence-gated splice. These are frozen copies
  of the port's plain twins (``ops/pileup.py``, ``ops/consensus.py``,
  ``models/polisher.py``), the network written out from the weights
  file's own layout.

The generator's truth (each read's molecule and strand) is input data
both sides may be given.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 20
# dense codes and IUPAC masks
A, C, G, T, N_CODE, PAD_CODE = 0, 1, 2, 3, 4, 5
CODE_TO_MASK = np.array([1, 2, 4, 8, 15, 0], dtype=np.uint8)
_IUPAC_MASK = {"A": 1, "C": 2, "G": 4, "T": 8, "U": 8, "R": 5, "Y": 10, "S": 6, "W": 9,
               "K": 12, "M": 3, "B": 14, "D": 13, "H": 11, "V": 7, "N": 15}
_CODE_OF = np.full(256, N_CODE, np.uint8)
for _i, _b in enumerate("ACGT"):
    _CODE_OF[ord(_b)] = _i
    _CODE_OF[ord(_b.lower())] = _i
DECODE = np.frombuffer(b"ACGTN-", dtype=np.uint8)
_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def encode(seq: str) -> np.ndarray:
    return _CODE_OF[np.frombuffer(seq.encode("ascii"), np.uint8)]


def mask_of(pattern: str) -> np.ndarray:
    return np.array([_IUPAC_MASK[c] for c in pattern.upper()], np.uint8)


def decode(codes: np.ndarray) -> str:
    return DECODE[np.asarray(codes, np.uint8)].tobytes().decode("ascii")


# ---------------------------------------------------------------------------
# infix edit distance with IUPAC masks


def _final_row(pm: np.ndarray, plen: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(P, N, Lw+1): entry j = the least edit distance of each pattern to a
    substring of the window ending exactly at j. ``pm`` (P, m) masks, zero
    past each length; ``w`` (N, Lw) or (P, N, Lw) masks."""
    P, m = pm.shape
    Lw = w.shape[-1]
    N = w.shape[-2]
    pm3 = pm.astype(np.int32)[:, None, :]
    idx = np.arange(m + 1, dtype=np.int32)
    col = np.broadcast_to(idx, (P, N, m + 1)).copy()
    take = np.broadcast_to(plen.astype(np.int64)[:, None, None], (P, N, 1))
    zero = np.zeros((P, N, 1), np.int32)
    out = np.empty((P, N, Lw + 1), np.int32)
    out[..., 0] = plen[:, None]
    wi = w.astype(np.int32)
    for j in range(Lw):
        ch = wi[..., j][..., None] if wi.ndim == 3 else wi[None, :, j, None]
        sub = ((pm3 & ch) == 0).astype(np.int32)
        tmp = np.minimum(col[..., :-1] + sub, col[..., 1:] + 1)
        base = np.concatenate([zero, tmp], axis=-1)
        cascaded = idx + np.minimum.accumulate(base - idx, axis=-1)
        col = np.minimum(base, cascaded)
        out[..., j + 1] = np.take_along_axis(col, take, axis=-1)[..., 0]
    return out


def fuzzy_find(pm: np.ndarray, plen: np.ndarray, windows: np.ndarray, wlens: np.ndarray):
    """Best infix match of each pattern in each window: (dist, start, end),
    each (P, N); among optimal ends the smallest end, then for that end the
    smallest start."""
    P, m = pm.shape
    N, Lw = windows.shape
    idx = np.arange(m)[None, :]
    src = np.clip(plen[:, None] - 1 - idx, 0, max(m - 1, 0))
    revs = np.where(idx < plen[:, None], np.take_along_axis(pm, src, axis=1), 0).astype(np.uint8)
    j = np.arange(Lw + 1)
    row = _final_row(pm, plen, windows)
    masked = np.where(j[None, None, :] <= wlens[None, :, None], row, BIG)
    dist = masked.min(axis=-1)
    end = masked.argmin(axis=-1)
    r = np.arange(Lw)
    src_w = np.clip(end[..., None] - 1 - r, 0, Lw - 1)
    gathered = np.take_along_axis(np.broadcast_to(windows[None], (P, N, Lw)), src_w, axis=-1)
    rev_prefix = np.where(r < end[..., None], gathered, 0)
    rrow = _final_row(revs, plen, rev_prefix)
    hits = (j <= end[..., None]) & (rrow == dist[..., None])
    j2 = np.where(hits, j, -1).max(axis=-1)
    return dist.astype(np.int32), (end - j2).astype(np.int32), end.astype(np.int32)


def _stack(patterns: list[str]) -> tuple[np.ndarray, np.ndarray]:
    m = max(len(p) for p in patterns)
    pm = np.zeros((len(patterns), m), np.uint8)
    for i, p in enumerate(patterns):
        pm[i, : len(p)] = mask_of(p)
    return pm, np.array([len(p) for p in patterns], np.int64)


def _windows(codes: np.ndarray, starts: np.ndarray, width: int, limit: int) -> np.ndarray:
    """(N, width) masks of ``codes[n, starts[n] + p]`` for p < limit (0
    beyond), positions clamped into the padded row."""
    Wp = codes.shape[1]
    pos = np.arange(width)[None, :]
    idx = np.clip(starts[:, None] + pos, 0, Wp - 1)
    masks = CODE_TO_MASK[np.take_along_axis(codes, idx, axis=1)]
    return np.where(pos < limit, masks, 0).astype(np.uint8)


EE_TIE = 1e-5   # relative: an EE rate this close to its limit is a float32 tie


def assign_reads(seqs: list[str], quals: list[str], knobs: dict, primers: list[str]) -> list[dict]:
    """Round-1 trim, filter and UMIs of each read, in the sequenced
    orientation: {pass, tie, rate, trimmed, umi: None or (d5, d3, u5,
    u3)}. ``tie``: the read is long enough and its EE rate lies within
    ``EE_TIE`` (relative) of the limit, where float32 sums taken in another
    order may fall either side."""
    n = len(seqs)
    lens = np.array([len(s) for s in seqs], np.int64)
    Wp = int(lens.max()) + 1
    codes = np.full((n, Wp), PAD_CODE, np.uint8)
    qarr = np.zeros((n, Wp), np.float32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        codes[i, : len(s)] = encode(s)
        qarr[i, : len(q)] = np.frombuffer(q.encode("ascii"), np.uint8).astype(np.float32) - 33
    # the primer trim: forward primers in the 5' window, their reverse
    # complements in the 3' one; a hit within max(1, int(len * frac))
    # edits, the smallest distance winning, ties to the earliest primer
    tw = int(knobs["trim_window"])
    start3w = np.maximum(lens - tw, 0)
    wlen = np.minimum(lens, tw)
    pmax = np.array([max(1, int(len(p) * float(knobs["primer_max_dist_frac"]))) for p in primers])

    def best(pats, windows):
        pm, pl = _stack(pats)
        d, s, e = fuzzy_find(pm, pl, windows, wlen)
        dq = np.where(d <= pmax[:, None], d, BIG)
        p = dq.argmin(axis=0)
        cols = np.arange(n)
        return dq[p, cols] < BIG, s[p, cols], e[p, cols]

    hit5, _, e5 = best(primers, _windows(codes, np.zeros(n, np.int64), tw, tw))
    hit3, s3, _ = best([revcomp(p) for p in primers], _windows(codes, start3w, tw, tw))
    t_start = np.where(hit5, e5, 0)
    t_end = np.maximum(np.where(hit3, start3w + s3, lens), t_start)
    lens_t = t_end - t_start
    # expected errors over the trimmed span, float32
    pos = np.arange(Wp)[None, :]
    in_span = (pos >= t_start[:, None]) & (pos < t_end[:, None])
    perr = np.power(np.float32(10.0), -qarr / np.float32(10.0)).astype(np.float32)
    ee = np.where(in_span, perr, np.float32(0)).sum(axis=1, dtype=np.float32)
    rate = ee / np.maximum(lens_t, 1).astype(np.float32)
    limit = np.float32(knobs["max_ee_rate_base"])
    long_enough = lens_t >= int(knobs["minimal_length"])
    passed = (rate <= limit) & long_enough
    tie = long_enough & (np.abs(rate - limit) <= np.float32(EE_TIE) * limit)
    # UMIs in the trimmed frame: the forward pattern in the first a5
    # bases, the reverse one in the last a3
    a5, a3 = int(knobs["max_softclip_5_end"]), int(knobs["max_softclip_3_end"])
    aw = max(a5, a3)
    umi_pm, umi_pl = _stack([knobs["umi_fwd"], knobs["umi_rev"]])
    start3 = np.maximum(lens_t - a3, 0)
    d5, us5, ue5 = (x[0] for x in fuzzy_find(umi_pm[:1], umi_pl[:1],
                                             _windows(codes, t_start, aw, a5),
                                             np.minimum(lens_t, a5)))
    d3, us3, ue3 = (x[0] for x in fuzzy_find(umi_pm[1:], umi_pl[1:],
                                             _windows(codes, t_start + start3, aw, a3),
                                             np.minimum(lens_t, a3)))
    k = int(knobs["max_pattern_dist"])
    ok = (d5 <= k) & (d3 <= k) & (ue5 > us5) & (ue3 > us3)
    out = []
    for i, s in enumerate(seqs):
        trimmed = s[t_start[i]:t_end[i]]
        umi = None
        if ok[i]:
            umi = (int(d5[i]), int(d3[i]), trimmed[us5[i]:ue5[i]],
                   trimmed[start3[i] + us3[i]:start3[i] + ue3[i]])
        out.append({"pass": bool(passed[i]), "tie": bool(tie[i]), "rate": float(rate[i]),
                    "trimmed": trimmed, "umi": umi})
    return out


# ---------------------------------------------------------------------------
# the panel's region clusters


def _edit_distance(a: str, b: str) -> int:
    """Levenshtein distance, Myers' bit-vector algorithm on Python ints."""
    if len(a) < len(b):
        a, b = b, a
    m = len(b)
    if m == 0:
        return len(a)
    peq: dict[str, int] = {}
    for i, ch in enumerate(b):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    full = (1 << m) - 1
    top = 1 << (m - 1)
    pv, mv, score = full, 0, m
    for ch in a:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & full)
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        pv = mh | (~(xv | ph) & full)
        mv = ph & xv
    return score


def region_clusters(reference: dict[str, str], identity: float, k: int = 16) -> dict[str, frozenset]:
    """Each region's cluster (a set of region names): regions joined where
    their edit identity, 1 - distance / longer length, reaches
    ``identity``; pairs that share no ``k``-mer are not aligned."""
    names = list(reference)
    kmers = [{s[i:i + k] for i in range(0, len(s) - k + 1)} for s in reference.values()]
    parent = list(range(len(names)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            if not kmers[i] & kmers[j]:
                continue
            a, b = reference[names[i]], reference[names[j]]
            if 1.0 - _edit_distance(a, b) / max(len(a), len(b)) >= identity:
                parent[find(i)] = find(j)
    groups: dict[int, set] = {}
    for i, name in enumerate(names):
        groups.setdefault(find(i), set()).add(name)
    return {name: frozenset(groups[find(i)]) for i, name in enumerate(names)}


# ---------------------------------------------------------------------------
# the pileup: banded forward and traceback (frozen from ops/pileup.py)

NEG = -(1 << 24)
MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 2, 4, 4, 2
UNCOVERED, DELETION = 5, 4
_DIAG, _EGAP, _FRESH = 0, 1, 3
_DIAG_STOP_BIT, _EOPEN_BIT = 0b100, 0b1000


def _shift_up(x, fill):
    out = np.empty_like(x)
    out[:, :-1] = x[:, 1:]
    out[:, -1] = fill
    return out


def _shift_right(x, step, fill):
    out = np.empty_like(x)
    out[:, :step] = fill
    out[:, step:] = x[:, :-step]
    return out


def _forward(reads, read_lens, refs, ref_lens, W: int):
    """Banded Gotoh forward over flat lanes centred on the diagonal
    (int32 NumPy): best (N, 3) (score, row, slot) and the packed direction
    planes (N, L, W) ``tdir | fjump << 4``."""
    N, L = reads.shape
    c = W // 2
    i32 = np.int32
    iota = np.arange(W, dtype=i32)[None, :]
    rlen = read_lens.astype(i32)[:, None]
    tlen = ref_lens.astype(i32)[:, None]
    reads_i = reads.astype(i32)
    Lr = refs.shape[1]
    ks = np.arange(L + W, dtype=np.int64)[None, :] - c
    in_range = (ks >= 0) & (ks < Lr)
    win = np.take_along_axis(refs.astype(i32), np.broadcast_to(np.clip(ks, 0, max(Lr - 1, 0)),
                                                               (N, L + W)), axis=1)
    win = np.where(in_range, win, PAD_CODE).astype(i32)
    H = np.full((N, W), NEG, dtype=i32)
    E = H.copy()
    best = np.tile(np.array([0, -1, 0], dtype=i32), (N, 1))
    planes = np.empty((N, L, W), dtype=np.int16)
    rows = np.arange(N)
    for i in range(L):
        jrow = i - c + iota
        valid = (jrow >= 0) & (jrow < tlen) & (i < rlen)
        rbase = reads_i[:, i:i + 1]
        tbase = win[:, i:i + W]
        is_match = (tbase == rbase) & (rbase < 4) & (tbase < 4)
        sub = np.where(is_match, MATCH, -MISMATCH).astype(i32)
        open_sc = _shift_up(H, NEG) - (GAP_OPEN + GAP_EXT)
        ext_sc = _shift_up(E, NEG) - GAP_EXT
        e_open = open_sc >= ext_sc
        E_new = np.where(e_open, open_sc, ext_sc)
        fresh_pred = H < 0
        D = np.where(fresh_pred, 0, H) + sub
        tdir = np.where(fresh_pred, _DIAG | _DIAG_STOP_BIT, _DIAG)
        e_better = E_new > D
        tmp = np.where(e_better, E_new, D)
        tdir = np.where(e_better, _EGAP, tdir)
        fresh_better = tmp < 0
        tmp = np.where(fresh_better, 0, tmp)
        tdir = np.where(fresh_better, _FRESH, tdir)
        tmp = np.where(valid, tmp, NEG).astype(i32)
        tdir = tdir | np.where(e_open, _EOPEN_BIT, 0)
        g = tmp
        gap = np.zeros_like(tmp)
        step = 1
        while step < W:
            cand_g = _shift_right(g, step, NEG) - GAP_EXT * step
            take = cand_g > g
            g = np.where(take, cand_g, g)
            gap = np.where(take, _shift_right(gap, step, 0) + step, gap)
            step *= 2
        F = _shift_right(g, 1, NEG) - (GAP_OPEN + GAP_EXT)
        jump = (_shift_right(gap, 1, 0) + 1) & 0xFF
        take_f = F > tmp
        H = np.where(valid, np.where(take_f, F, tmp), NEG).astype(i32)
        fjump = np.where(take_f, jump, 0)
        planes[:, i] = (tdir | (fjump << 4)).astype(np.int16)
        b_star = np.argmax(H, axis=1)
        row_best = H[rows, b_star]
        improve = row_best > best[:, 0]
        best[improve] = np.stack([row_best, np.full_like(row_best, i), b_star.astype(i32)],
                                 axis=1)[improve]
        E = np.where(valid, E_new, NEG).astype(i32)
    return best, planes


def _traceback(best, planes, reads, W: int, out_len: int):
    """Walk each lane back from its best cell (int32 NumPy); the pileup
    columns (base_at, ins_cnt, ins_base) (N, out_len) and spans (N, 4)."""
    N, L = reads.shape
    c = W // 2
    i32 = np.int32
    T = L + out_len
    score, i0, b0 = best[:, 0], best[:, 1], best[:, 2]
    jend = i0 - c + b0
    MODE_H, MODE_E, MODE_TMP = 0, 1, 2
    OP_DEL, OP_DIAG, OP_INS = 1, 2, 3
    planes_flat = planes.reshape(N, L * W)
    i, b = i0.copy(), b0.copy()
    mode = np.full((N,), MODE_H, dtype=i32)
    pending = np.zeros((N,), dtype=i32)
    done = (score <= 0) | (i0 < 0)
    rstart, fstart = i0 + 1, jend + 1
    ops, idx_i, idx_j = [], [], []
    lanes = np.arange(N)
    for t in range(T):
        if t % 256 == 0 and bool(done.all()):
            break
        live = ~done
        jrow = i - c + b
        jc = np.clip(jrow, 0, out_len - 1)
        j_ok = (jrow >= 0) & (jrow < out_len) & live
        ci = np.clip(i, 0, L - 1)
        cb = np.clip(b, 0, W - 1)
        p = planes_flat[lanes, ci * W + cb].astype(i32) & 0xFFFF
        d = p & 15
        m = p >> 4
        in_del = pending > 0
        start_del = ~in_del & (mode == MODE_H) & (m > 0)
        do_del = in_del | start_del
        new_pending = np.where(in_del, pending - 1, np.where(start_del, m - 1, 0))
        choice = np.where(mode == MODE_E, _EGAP, d & 3)
        is_diag = ~do_del & (choice == _DIAG)
        is_egap = ~do_del & (choice == _EGAP)
        is_fresh = ~do_del & (choice == _FRESH)
        op = np.where(do_del & j_ok, OP_DEL,
                      np.where(is_diag & j_ok, OP_DIAG, np.where(is_egap & j_ok, OP_INS, 0)))
        ops.append(op.astype(np.int8))
        idx_i.append(ci)
        idx_j.append(jc)
        e_open = (d & _EOPEN_BIT) != 0
        diag_stop = is_diag & ((d & _DIAG_STOP_BIT) != 0)
        ni = np.where(is_diag | is_egap, i - 1, i)
        nb = np.where(do_del, b - 1, np.where(is_egap, b + 1, b))
        nmode = np.where(do_del, MODE_TMP, np.where(is_egap & ~e_open, MODE_E, MODE_H))
        ndone = done | is_fresh | diag_stop | (ni < 0) | (nb < 0) | (nb >= W)
        rstart = np.where(live & (is_diag | is_egap), i, rstart)
        fstart = np.where(live & (is_diag | do_del), jrow, fstart)
        i = np.where(live, ni, i)
        b = np.where(live, nb, b)
        mode = np.where(live, nmode, mode)
        pending = np.where(live, new_pending, pending)
        done = ndone
    base_at = np.full((N, out_len + 1), UNCOVERED, dtype=np.uint8)
    ins_cnt = np.zeros((N, out_len + 1), dtype=i32)
    pk = np.full((N, out_len + 1), -1, dtype=i32)
    if ops:
        op_t = np.stack(ops, axis=1).astype(i32)
        i_t = np.stack(idx_i, axis=1)
        jc_t = np.stack(idx_j, axis=1)
        rb_t = np.take_along_axis(reads.astype(i32), i_t.astype(np.int64), axis=1)
        rb_known = rb_t < 4
        set_hit = (op_t == OP_DEL) | ((op_t == OP_DIAG) & rb_known)
        set_j = np.where(set_hit, jc_t, out_len)
        set_v = np.where(op_t == OP_DEL, DELETION, rb_t).astype(np.uint8)
        ins_hit = (op_t == OP_INS) & rb_known
        ins_j = np.where(ins_hit, jc_t, out_len)
        ts = np.arange(op_t.shape[1], dtype=i32)[None, :]
        rows = np.broadcast_to(np.arange(N)[:, None], set_j.shape)
        keep = set_j < out_len  # each kept (lane, column) is written once
        base_at[rows[keep], set_j[keep]] = set_v[keep]
        np.add.at(ins_cnt, (rows, ins_j), 1)
        np.maximum.at(pk, (rows, ins_j), ts * 4 + (rb_t & 3))
    base_at, ins_cnt, pk = (x[:, :out_len] for x in (base_at, ins_cnt, pk))
    ins_base = np.where(pk >= 0, pk % 4, 0).astype(np.uint8)
    spans = np.stack([rstart, i0 + 1, fstart, jend + 1], axis=1)
    return base_at, ins_cnt, ins_base, spans


def pileup(sub: np.ndarray, slens: np.ndarray, drafts: np.ndarray, dlens: np.ndarray, W: int):
    """Every subread of each cluster aligned to its draft: (base_at,
    ins_cnt, ins_base) (C, S, Wd) tensors and spans (C, S, 4) numpy."""
    Cn, S, L = sub.shape
    reads = np.ascontiguousarray(sub.reshape(Cn * S, L))
    best, planes = _forward(reads, slens.reshape(Cn * S), np.repeat(drafts, S, axis=0),
                            np.repeat(dlens.astype(np.int32), S), W)
    base_at, ins_cnt, ins_base, spans = _traceback(best, planes, reads, W, L)
    return (torch.from_numpy(base_at.reshape(Cn, S, L)), torch.from_numpy(ins_cnt.reshape(Cn, S, L)),
            torch.from_numpy(ins_base.reshape(Cn, S, L)), spans.reshape(Cn, S, 4))


# ---------------------------------------------------------------------------
# the vote rounds (frozen from ops/consensus.py)


def _vote(base_at, ins_cnt, ins_base, drafts, dlens):
    """One round's column vote: plurality per column (ties: a base before
    a deletion, the smaller code first), an insertion where more than half
    of the covering subreads report one."""
    Cn, S, Ld = base_at.shape
    drafts = torch.from_numpy(np.ascontiguousarray(drafts))
    dlens_t = torch.from_numpy(np.ascontiguousarray(dlens.astype(np.int32)))
    covered = base_at != UNCOVERED
    depth = covered.sum(dim=1)
    counts = torch.stack([(base_at == code).sum(dim=1) for code in range(5)], dim=1)
    order_bonus = torch.arange(4, -1, -1)[None, :, None]
    winner = torch.argmax(counts * 8 + order_bonus, dim=1).to(torch.uint8)
    in_draft = torch.arange(Ld)[None, :] < dlens_t[:, None]
    keep_base = torch.where(depth > 0, winner, drafts[:, :Ld].to(torch.uint8))
    slot_base = torch.where(in_draft, keep_base, PAD_CODE).to(torch.uint8)
    slot_keep = in_draft & ~((depth > 0) & (winner == DELETION))
    has_ins_row = (ins_cnt > 0) & covered
    has_ins = has_ins_row.sum(dim=1)
    do_ins = (has_ins * 2 > depth) & (depth > 0) & in_draft
    ins_counts = torch.stack([((ins_base == code) & has_ins_row).sum(dim=1) for code in range(4)],
                             dim=1)
    ins_winner = torch.argmax(ins_counts * 8 + order_bonus[:, :4], dim=1).to(torch.uint8)
    slots = torch.stack([slot_base, torch.where(do_ins, ins_winner, PAD_CODE).to(torch.uint8)],
                        dim=2).reshape(Cn, 2 * Ld)
    keep = torch.stack([slot_keep, do_ins], dim=2).reshape(Cn, 2 * Ld)
    new_lens = keep.sum(dim=1).to(torch.int32)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out = torch.full((Cn, 2 * Ld + 1), PAD_CODE, dtype=torch.uint8)
    out.scatter_(1, torch.where(keep, pos, 2 * Ld), slots)
    return out[:, :Ld].numpy(), new_lens.numpy()


def _extend_ends(drafts, dlens, subreads, subread_lens, spans, aligned_dlens):
    """A strict majority of the subreads reaching a draft end with bases
    beyond it votes one base onto that end (the left end first)."""
    Cn, S, W = subreads.shape
    r_start, r_end = spans[:, :, 0], spans[:, :, 1]
    f_start, f_end = spans[:, :, 2], spans[:, :, 3]

    def vote(bases, voters):
        votes = np.stack([((bases == code) & voters).sum(axis=1) for code in range(4)], axis=1)
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


def vote_consensus(sub: np.ndarray, slens: np.ndarray, rounds: int, W: int):
    """Consensus of C same-shape clusters (subreads (C, S, Wd) codes in the
    molecule's orientation, 0-length rows padding): the subread of
    lower-median length seeds the draft; each round aligns, votes and
    extends, a cluster stopping once its draft is a fixed point. Returns
    (drafts, dlens, pileup): the pileup each cluster's final draft got, or
    a fresh one where the rounds ran out first."""
    Cn, S, Wd = sub.shape
    real = slens > 0
    nreal = real.sum(axis=1)
    key = np.where(real, slens, np.iinfo(np.int32).max)
    order = np.argsort(key, axis=1, kind="stable")
    mid = (np.maximum(nreal, 1) - 1) // 2
    seed = np.take_along_axis(order, mid[:, None], axis=1)[:, 0]
    dlens = np.where(nreal > 0, slens[np.arange(Cn), seed], 0).astype(np.int32)
    pos = np.arange(Wd)[None, :]
    drafts = np.where(pos < dlens[:, None], sub[np.arange(Cn), seed], PAD_CODE).astype(np.uint8)
    final = [None] * Cn
    active = np.where(nreal > 0)[0]
    for _ in range(rounds):
        if not len(active):
            break
        base_at, ins_cnt, ins_base, spans = pileup(sub[active], slens[active], drafts[active],
                                                   dlens[active], W)
        nd, nl = _vote(base_at, ins_cnt, ins_base, drafts[active], dlens[active])
        if (nl > Wd).any():
            raise ValueError("consensus grew past the padded width")
        old_d, old_l = drafts[active].copy(), dlens[active].copy()
        nd, nl = _extend_ends(nd.copy(), nl.astype(np.int32), sub[active], slens[active], spans,
                              old_l)
        stable = (nl == old_l) & (nd == old_d).all(axis=1)
        drafts[active], dlens[active] = nd, nl
        for k in np.where(stable)[0]:
            final[active[k]] = (base_at[k], ins_cnt[k], ins_base[k])
        active = active[~stable]
    if len(active):
        base_at, ins_cnt, ins_base, _ = pileup(sub[active], slens[active], drafts[active],
                                               dlens[active], W)
        for k, c in enumerate(active):
            final[c] = (base_at[k], ins_cnt[k], ins_base[k])
    return drafts, dlens, final


# ---------------------------------------------------------------------------
# the polisher: features, network, splice


def features(base_at, ins_cnt, ins_base, drafts: np.ndarray) -> torch.Tensor:
    """(S, Ld) pileup columns of one cluster -> (Ld, 15) float32: log1p of
    the A/C/G/T/deletion counts, of the per-base insertion counts, of the
    insertion-reporting count and of the depth; the draft base one-hot."""
    Ld = base_at.shape[1]
    counts = torch.stack([(base_at == code).sum(dim=0) for code in range(5)], dim=1).float()
    has_ins = (ins_cnt > 0) & (base_at != UNCOVERED)
    ins_counts = torch.stack([(has_ins & (ins_base == code)).sum(dim=0) for code in range(4)],
                             dim=1).float()
    ins = has_ins.sum(dim=0).float()[:, None]
    depth = (base_at != UNCOVERED).sum(dim=0).float()[:, None]
    onehot = (torch.from_numpy(drafts[:Ld].astype(np.int64))[:, None]
              == torch.arange(4)).float()
    return torch.cat([torch.log1p(counts), torch.log1p(ins_counts), torch.log1p(ins),
                      torch.log1p(depth), onehot], dim=1)


def load_weights(path: str) -> dict:
    """A Flax params tree (nested dicts of float32 arrays) from its msgpack
    file: extension type 1 is an ndarray as (shape, dtype name, bytes)."""
    import msgpack

    def ext_hook(code, data):
        if code != 1:
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = msgpack.unpackb(data, raw=True)
        return np.frombuffer(raw, dtype=np.dtype(dtype.decode())).reshape(shape)

    with open(path, "rb") as fh:
        return msgpack.unpackb(fh.read(), ext_hook=ext_hook, raw=False)


def polisher_logits(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """(B, L, F) -> (B, L, 10) float32 logits of the network the weights
    describe: Dense -> GELU (tanh) -> bi-GRU layers over the whole padded
    width (the backward cell run from the last position) -> Dense. Each GRU
    cell: r = s(x Wir + bir + h Whr), z = s(x Wiz + biz + h Whz),
    n = tanh(x Win + bin + r (h Whn + bhn)), h' = (1 - z) n + z h."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    x = feats @ t(params["embed"]["kernel"]) + t(params["embed"]["bias"])
    x = torch.nn.functional.gelu(x, approximate="tanh")
    layers = sorted((k for k in params if k.startswith("bigru")), key=lambda k: int(k[5:]))
    for layer in layers:
        outs = []
        for cell, backward in (("GRUCell_0", False), ("GRUCell_1", True)):
            c = params[layer][cell]
            wi = torch.cat([t(c[g]["kernel"]) for g in ("ir", "iz", "in")], dim=1)
            bi = torch.cat([t(c[g]["bias"]) for g in ("ir", "iz", "in")])
            wh = torch.cat([t(c[g]["kernel"]) for g in ("hr", "hz", "hn")], dim=1)
            bhn = t(c["hn"]["bias"])
            hsz = bhn.shape[0]
            xi = x @ wi + bi
            h = torch.zeros((x.shape[0], hsz))
            seq = [None] * x.shape[1]
            steps = range(x.shape[1] - 1, -1, -1) if backward else range(x.shape[1])
            for s in steps:
                hh = h @ wh
                r = torch.sigmoid(xi[:, s, :hsz] + hh[:, :hsz])
                z = torch.sigmoid(xi[:, s, hsz:2 * hsz] + hh[:, hsz:2 * hsz])
                n = torch.tanh(xi[:, s, 2 * hsz:] + r * (hh[:, 2 * hsz:] + bhn))
                h = (1 - z) * n + z * h
                seq[s] = h
            outs.append(torch.stack(seq, dim=1))
        x = torch.cat(outs, dim=2)
    return x @ t(params["head"]["kernel"]) + t(params["head"]["bias"])


def splice(draft: np.ndarray, dlen: int, live: int, cls: np.ndarray, conf: np.ndarray,
           depth: np.ndarray, ins_pred: np.ndarray, ins_conf: np.ndarray,
           min_confidence: float, min_depth: int) -> np.ndarray:
    """The gated splice of one cluster: a covered position takes a
    confident class (a deletion drops it) and gains a confident insertion;
    a cluster of fewer than ``min_depth`` live subreads keeps its draft.
    Returns the polished codes, cut to the draft's width."""
    W = draft.shape[0]
    pos = np.arange(W)
    in_draft = pos < dlen
    covered = in_draft & (depth > 0) & (live >= min_depth)
    apply = covered & (conf >= min_confidence)
    base = np.where(apply, cls, draft)
    keep = in_draft & ~(apply & (cls == 4))
    do_ins = covered & (ins_conf >= min_confidence) & (ins_pred > 0)
    slot_base = np.stack([base, np.where(do_ins, ins_pred - 1, 0)], axis=1).reshape(-1)
    slot_keep = np.stack([keep, do_ins], axis=1).reshape(-1)
    return slot_base[slot_keep].astype(np.uint8)[:W]


def decisions(logits: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Per position: class argmax, its softmax probability, insertion argmax
    and its probability (numpy)."""
    cls, ins = logits[..., :5], logits[..., 5:]
    return (torch.argmax(cls, -1).numpy().astype(np.uint8),
            torch.softmax(cls, -1).amax(-1).numpy(),
            torch.argmax(ins, -1).numpy().astype(np.uint8),
            torch.softmax(ins, -1).amax(-1).numpy())
