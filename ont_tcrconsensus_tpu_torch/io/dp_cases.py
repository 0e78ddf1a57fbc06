"""Seeded inputs for the DPs and their walks (kernels B1-B6 and their
plain twins).

Every case is made with numpy from a seed, so the JAX reference, the plain
PyTorch versions and the CUDA kernels can be fed the same bytes: the
parity tests use :func:`dp_case` at small sizes, ``chip_smoke.py`` uses
:func:`dp_batch` at the main path's shapes (off the diagonal through
:func:`nonzero_offsets`); both hold B2 and B3 at band centres to
:func:`band_centre_cluster`, both walk B3 over
:func:`random_planes` and B4 over :func:`cs_tiles` and :func:`cs_crafted`,
and hold B5 to :func:`fuzzy_case` and B6 to :func:`dovetail_case` at any
size.
"""

from __future__ import annotations

import numpy as np

from ont_tcrconsensus_tpu_torch.ops import encode

PAD = 5

DP_KINDS = ("noisy", "homopolymer", "repeat", "n_bases", "pad", "band_edge", "zero")


def noisy_copy(rng: np.random.Generator, ref: np.ndarray, err: float) -> np.ndarray:
    """``ref`` with substitutions, deletions and insertions at ~err/3 each."""
    op = rng.random(len(ref))
    reps = np.where(op < err / 3, 0, np.where(op < 2 * err / 3, 2, 1))
    out = np.repeat(ref, reps)
    ins = (np.cumsum(reps) - 1)[reps == 2]
    out[ins] = rng.integers(0, 4, len(ins))
    sub = rng.random(len(out)) < err / 3
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return out.astype(np.uint8)


def pack(rows: list[np.ndarray], width: int) -> tuple[np.ndarray, np.ndarray]:
    """PAD-filled (n, width) uint8 batch and its (n,) int32 lengths."""
    out = np.full((len(rows), width), PAD, np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.uint8)[:width]
        out[i, : len(r)] = r
        lens[i] = len(r)
    return out, lens


def dp_case(kind: str, n: int = 12, L: int = 256, W: int = 128, seed: int = 0):
    """(reads, read_lens, refs, ref_lens, diag_offsets) for one DP case.

    Kinds: ``noisy`` (8% errors, flanks, offsets near the true diagonal),
    ``homopolymer`` (every cell ties), ``repeat`` (two-base repeat, shifted
    copies tie), ``n_bases`` (runs of N), ``pad`` (empty reads and
    references, pad codes inside the band), ``band_edge`` (offsets at and
    past the band's edges), ``zero`` (nothing scores above 0).
    """
    rng = np.random.default_rng(seed)
    reads, refs, offs = [], [], []
    for b in range(n):
        tlen = int(rng.integers(L // 2, L - 16))
        ref = rng.integers(0, 4, tlen).astype(np.uint8)
        off = 0
        if kind == "noisy":
            flank = int(rng.integers(0, 20))
            read = np.concatenate([rng.integers(0, 4, flank).astype(np.uint8),
                                   noisy_copy(rng, ref, 0.08)])
            off = -flank + int(rng.integers(-8, 9))
        elif kind == "homopolymer":
            ref[:] = b % 4
            read = np.full(int(rng.integers(L // 4, L - 16)), b % 4, np.uint8)
            off = int(rng.integers(-W // 2, W // 2))
        elif kind == "repeat":
            unit = np.array([b % 4, (b + 1 + b // 4) % 4], np.uint8)
            ref = np.resize(unit, tlen)
            read = np.resize(unit[::-1] if b % 3 == 0 else unit, tlen - int(rng.integers(0, 9)))
            off = int(rng.integers(-3, 4))
        elif kind == "n_bases":
            read = noisy_copy(rng, ref, 0.05)
            read[rng.random(len(read)) < 0.1] = 4
            start = int(rng.integers(0, max(len(read) - 20, 1)))
            read[start : start + 15] = 4
            ref[rng.random(tlen) < 0.03] = 4
        elif kind == "pad":
            read = noisy_copy(rng, ref, 0.05)
            if b % 3 == 0:
                read = read[:0]
            elif b % 3 == 1:
                ref = ref[:0]
            else:
                read[len(read) // 2 : len(read) // 2 + 10] = PAD
        elif kind == "band_edge":
            read = noisy_copy(rng, ref, 0.05)
            off = [-(W // 2), W // 2 - 1, W // 2, -(W // 2) - 1, W, -W, W // 2 - 2][b % 7]
        elif kind == "zero":
            read = np.full(int(rng.integers(L // 4, L - 16)), b % 4, np.uint8)
            ref[:] = (b + 1) % 4
        else:
            raise ValueError(kind)
        reads.append(read)
        refs.append(ref)
        offs.append(off)
    r, rl = pack(reads, L)
    t, tl = pack(refs, L)
    return r, rl, t, tl, np.asarray(offs, np.int32)


def dp_batch(n: int, L: int, W: int, seed: int, offsets: bool = True):
    """A main-path-sized batch of ``n`` pairs: half ``noisy``, the other
    half split evenly over the tie-heavy and edge kinds, in a seeded
    shuffled order. Without ``offsets`` every diagonal offset is 0 (the
    pileup forward's case)."""
    per_kind = n // (2 * (len(DP_KINDS) - 1))
    counts = [n - per_kind * (len(DP_KINDS) - 1)] + [per_kind] * (len(DP_KINDS) - 1)
    parts = [dp_case(kind, m, L, W, seed + k)
             for k, (kind, m) in enumerate(zip(DP_KINDS, counts)) if m]
    order = np.random.default_rng(seed).permutation(n)
    reads, rl, refs, tl, offs = (np.concatenate(f)[order] for f in zip(*parts))
    if not offsets:
        offs = np.zeros_like(offs)
    return reads, rl, refs, tl, offs


BAND_CENTRES = (-40, -7, 0, 5, 37)
BAND_CENTRE_KINDS = ("on_diagonal", "on_diagonal", "at_zero", "unrelated", "n_bases", "dead")


def band_centre_cluster(seed: int, S: int, L: int, offsets=BAND_CENTRES):
    """One draft and ``S`` subreads for the pileup at off-diagonal band
    centres (kernels B2 and B3 with offsets): lane s at offset
    ``offsets[s % len(offsets)]`` and of kind ``BAND_CENTRE_KINDS[s //
    len(offsets) % 6]``. ``on_diagonal`` reads place read base i over draft
    base ~i + off (the template clipped, or random bases before it), so the
    band's first cells lie past either end of the draft; ``at_zero`` reads
    lie on diagonal 0 whatever the offset; ``unrelated`` reads share
    nothing; ``n_bases`` ones are on the diagonal with 8% N; ``dead`` ones
    are empty. Returns (subreads (S, L) uint8, lens (S,) int32, draft (L,)
    uint8, draft_len int, offsets (S,) int32)."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, L - 30).astype(np.uint8)
    draft = noisy_copy(rng, tpl, 0.02)
    reads, offs = [], []
    for s in range(S):
        off = offsets[s % len(offsets)]
        kind = BAND_CENTRE_KINDS[s // len(offsets) % len(BAND_CENTRE_KINDS)]
        if kind == "at_zero":
            read = noisy_copy(rng, tpl, 0.05)
        elif kind == "unrelated":
            read = rng.integers(0, 4, int(rng.integers(60, L))).astype(np.uint8)
        elif kind == "dead":
            read = tpl[:0]
        else:
            body = tpl[off:] if off >= 0 else np.concatenate(
                [rng.integers(0, 4, -off).astype(np.uint8), tpl])
            read = noisy_copy(rng, body, 0.05)
            if kind == "n_bases":
                read = read.copy()
                read[rng.random(len(read)) < 0.08] = 4
        reads.append(read[:L])
        offs.append(off)
    sub, lens = pack(reads, L)
    d, dl = pack([draft], L)
    return sub, lens, d[0], int(dl[0]), np.asarray(offs, np.int32)


def nonzero_offsets(seed: int, offs: np.ndarray, W: int) -> np.ndarray:
    """``offs`` (a :func:`dp_batch`'s band centres) with each 0 drawn anew
    from +-[1, W]: every lane off the diagonal."""
    rng = np.random.default_rng(seed)
    zero = offs == 0
    n = int(zero.sum())
    out = offs.copy()
    out[zero] = rng.integers(1, W + 1, n) * rng.choice(np.array([-1, 1]), n)
    return out


def random_planes(seed: int, N: int, L: int, W: int):
    """A seeded random direction field for the polish traceback (kernel B3):
    (best (N, 3) int32, planes (N, L, W) int16 holding the u16 cells
    ``tdir | fjump << 4``, reads (N, L) uint8).

    Cells are mostly diagonal, 8% insertion (half of them closing the
    insertion run), 0.2% fresh starts and 0.2% diagonal stops; 2% start a
    deletion run of 1-40 columns. Reads carry 5% N bases. Lanes cycle over
    starts: the last row at the band's centre (long walks that cross many
    chunks), the last row at slot 0 or W - 1 (walks that leave the band at
    once or soon), a random row and slot, and dead lanes (score <= 0 or
    row -1), so that the walks reach b = 0 and W - 1."""
    rng = np.random.default_rng(seed)
    planes = np.empty((N, L, W), np.int16)
    for n in range(N):  # a lane at a time: the main path's shapes stay small in memory
        u = rng.random((L, W))
        tdir = np.where(u < 0.002, 3, np.where(u < 0.082, 1, 0))
        diag_stop = (tdir == 0) & (rng.random((L, W)) < 0.002)
        e_open = rng.random((L, W)) < 0.5
        jump = np.where(rng.random((L, W)) < 0.02, rng.integers(1, 41, (L, W)), 0)
        planes[n] = tdir | diag_stop * 4 | e_open * 8 | jump << 4
    reads = rng.integers(0, 4, (N, L)).astype(np.uint8)
    reads[rng.random((N, L)) < 0.05] = 4
    best = np.zeros((N, 3), np.int32)
    for n in range(N):
        kind = n % 6
        score = int(rng.integers(1, 500))
        if kind in (0, 1):
            row, slot = L - 1, W // 2 + int(rng.integers(-4, 5))
        elif kind == 2:
            row, slot = L - 1 - int(rng.integers(0, 8)), 0
        elif kind == 3:
            row, slot = L - 1 - int(rng.integers(0, 8)), W - 1
        elif kind == 4:
            row, slot = int(rng.integers(0, L)), int(rng.integers(0, W))
        else:
            score, row, slot = (-int(rng.integers(0, 3)), int(rng.integers(0, L)), W // 2) \
                if n % 12 == 5 else (score, -1, W // 2)
        best[n] = score, row, slot
    return best, planes, reads


# ---------------------------------------------------------------------------
# the QC error profile's tiles (kernel B4)


def cs_ragged(rng: np.random.Generator, k: int):
    """Noisy reads of 1-400 nt (substitutions, deletions, insertions),
    some with N bases in the query or the reference."""
    qs, rs = [], []
    for _ in range(k):
        r = rng.integers(0, 4, int(rng.integers(1, 400))).astype(np.uint8)
        q = noisy_copy(rng, r, 0.08) if len(r) > 1 else r.copy()
        if rng.random() < 0.3 and len(q):
            q[rng.random(len(q)) < 0.05] = 4
        if rng.random() < 0.2:
            r = r.copy()
            r[rng.random(len(r)) < 0.05] = 4
        qs.append(q if len(q) else r[:1].copy())
        rs.append(r)
    return qs, rs


def cs_leading_insertions(rng: np.random.Generator, k: int):
    """Queries with 3-12 extra bases before the reference: walks that reach
    j == 0 with i > 0."""
    qs, rs = [], []
    for _ in range(k):
        r = rng.integers(0, 4, int(rng.integers(40, 200))).astype(np.uint8)
        qs.append(np.concatenate([rng.integers(0, 4, int(rng.integers(3, 13))).astype(np.uint8),
                                  noisy_copy(rng, r, 0.03)]))
        rs.append(r)
    return qs, rs


def cs_far_from_diagonal(rng: np.random.Generator, k: int):
    """A 55-70 base deletion early and as long an insertion late: equal
    lengths, but the true path runs farther from the interpolated diagonal
    than the band's half (48), so the band's edge shapes the alignment."""
    qs, rs = [], []
    for _ in range(k):
        r = rng.integers(0, 4, int(rng.integers(280, 360))).astype(np.uint8)
        cut = int(rng.integers(55, 71))
        q = np.concatenate([r[:30], r[30 + cut: 230],
                            rng.integers(0, 4, cut).astype(np.uint8), r[230:]])
        qs.append(q)
        rs.append(r)
    return qs, rs


def cs_wide_bands(rng: np.random.Generator):
    """|n - m| up to the live cap of 120 (ws 257, w_pad 320), on short
    reads whose band start moves 7-13 positions a row, both ways round."""
    qs, rs = [], []
    for n, m in ((10, 130), (15, 135), (20, 140), (130, 10), (140, 22), (380, 260),
                 (250, 370), (90, 200)):
        long_ = rng.integers(0, 4, max(n, m)).astype(np.uint8)
        short = long_[np.sort(rng.choice(max(n, m), min(n, m), replace=False))]
        q, r = (short, long_) if n < m else (long_, short.copy())
        flip = rng.random(len(r)) < 0.05  # substitutions, lengths kept
        r[flip] = (r[flip] + 1) % 4
        qs.append(q)
        rs.append(r)
    return qs, rs


def cs_tiles():
    """{label: (queries, refs)} of the two profile tiles, made from seed 13:
    ``ragged_n_leading_far`` (34 live reads, pad reads filling its 64 rows)
    and ``wide_bands`` (w_pad 320)."""
    rng = np.random.default_rng(13)
    ragged = cs_ragged(rng, 24)
    lead = cs_leading_insertions(rng, 6)
    far = cs_far_from_diagonal(rng, 4)
    wide = cs_wide_bands(rng)
    return {
        "ragged_n_leading_far": tuple(a + b + c for a, b, c in zip(ragged, lead, far)),
        "wide_bands": wide,
    }


def cs_tile_arrays(qs, rs):
    """A tile's inputs to kernel B4 as ``banded_cs_batch_device`` lays them
    out (its band halves, ``_tile_inputs``): ([qpad, rpad, n, m, lo_all,
    ws], w_pad), numpy."""
    from ont_tcrconsensus_tpu_torch.qc.error_profile import _tile_inputs

    qs16 = [np.asarray(q, np.int16) for q in qs]
    rs16 = [np.asarray(r, np.int16) for r in rs]
    ns, ms = np.array([len(q) for q in qs]), np.array([len(r) for r in rs])
    halves = np.maximum(48, np.abs(ns - ms) + 8)
    *arrays, w_pad = _tile_inputs(qs16, rs16, list(range(len(qs))), halves)
    return arrays, w_pad


CS_CRAFTED = ("negative_shift", "band_jump")


def cs_crafted(case: str):
    """A tile whose band starts are not the host's: ([qpad, rpad, n, m,
    lo_all, ws], w_pad). ``band_jump`` moves each read's first n / 2 rows
    right by more than the band: row n / 2 cannot reach them (a shift below
    -ws), every cell below holds BIG or more, and the walk leaves the band
    there. ``negative_shift`` does that to rows 0 and 1 of reads with
    leading insertions: from row 2 down, lane 0 (j == 0) is out of reach of
    the row above and its direction is 0, so the walk takes the tail
    insertion (i > 0, j == 0, p != 1) up to row 1. Host band starts are
    monotone and wide enough for neither to happen; the kernel takes any."""
    if case not in CS_CRAFTED:
        raise ValueError(case)
    rng = np.random.default_rng(5)
    qs, rs = cs_leading_insertions(rng, 8) if case == "negative_shift" else cs_ragged(rng, 12)
    arrays, w_pad = cs_tile_arrays(qs, rs)
    lo, ws = arrays[4], arrays[5]
    ns = arrays[2]
    for k in range(len(qs)):
        lo[k, : 2 if case == "negative_shift" else ns[k] // 2] += ws[k] + 3
    return arrays, w_pad


# the IUPAC letters a pattern is drawn from (ACGT four times as often)
_IUPAC = list("ACGT" * 4 + "RYSWKMBDHVN")

# _SET_BITS[x, k]: the k-th set bit of the mask x; _N_BITS[x]: how many
_SET_BITS = np.array([[b for b in (1, 2, 4, 8) if b & x] + [0] * (4 - bin(x).count("1"))
                      for x in range(16)], np.uint8)
_N_BITS = np.array([bin(x).count("1") for x in range(16)])

FUZZY_KINDS = ("random", "planted", "at_start", "at_end", "twice", "tandem", "n_bases",
               "zero_masks", "empty", "short")

# lengths either side of one and two 64-row words: where the bit-parallel
# kernels B5 and B6 carry a column from one word into the next (B5's
# pattern lengths, B6's first sequences' lengths; 129 rows take 3 words)
WORD_EDGES = (63, 64, 65, 127, 128, 129)
# a shape of each whose columns take three words and more: B5 (P, m, B, Lw)
# and B6 (n, L, lens)
FUZZY_MULTIWORD = (2, 200, 60, 260)
DOVETAIL_MULTIWORD = (64, 300, (150, 300))


def _instance(rng: np.random.Generator, pattern: np.ndarray, edits: int) -> np.ndarray:
    """A concrete base (one bit of each mask) for each pattern position,
    then ``edits`` random substitutions, insertions and deletions."""
    pattern = np.asarray(pattern, np.int64)
    bases = _SET_BITS[pattern, (rng.random(len(pattern)) * _N_BITS[pattern]).astype(np.int64)]
    for _ in range(edits):
        pos = int(rng.integers(0, max(len(bases), 1)))
        op = int(rng.integers(0, 3))
        new = np.uint8(1 << int(rng.integers(0, 4)))
        if op == 0 and len(bases):
            bases[pos] = new
        elif op == 1:
            bases = np.insert(bases, pos, new)
        elif len(bases) > 1:
            bases = np.delete(bases, pos)
    return bases


def fuzzy_case(seed: int, P: int, m: int, B: int, Lw: int, plens=None):
    """Inputs of the infix fuzzy match (kernel B5): (pattern_masks (P, m)
    uint8 zero-padded past each length, pattern_lens (P,) int32, windows
    (B, Lw) uint8 masks zero past each length, window_lens (B,) int32).

    Pattern 0 fills m; the others are shorter (padded), with IUPAC codes
    and N. Windows cycle over :data:`FUZZY_KINDS`: random bases; an
    instance of a pattern with 0-3 edits planted inside, at position 0 or
    ending at the window's end; two exact instances (ties on the end);
    tandem copies of a pattern's head (ties on the start); runs of N
    (mask 15); masks 0 inside the window (never a match); an empty window;
    a window shorter than the patterns. Window lengths run from 0 to Lw.
    ``plens``, when given, are the patterns' lengths (each at most m,
    cycled over the P patterns) in place of drawn ones."""
    rng = np.random.default_rng(seed)
    drawn = [m] + [int(rng.integers(min(max(m // 2, 1), m), m + 1)) for _ in range(P - 1)]
    if plens is not None:
        drawn = [plens[p % len(plens)] for p in range(P)]
    plens = np.array(drawn, np.int32)[:P]
    pmasks = np.zeros((P, m), np.uint8)
    for p in range(P):
        pmasks[p, : plens[p]] = encode.encode_mask("".join(rng.choice(_IUPAC, plens[p])))
    windows = np.zeros((B, Lw), np.uint8)
    wlens = np.zeros(B, np.int32)
    for b in range(B):
        kind = FUZZY_KINDS[b % len(FUZZY_KINDS)]
        pat = pmasks[b % P, : plens[b % P]]
        wl = int(rng.integers(max(Lw // 2, 1), Lw + 1))
        row = (1 << rng.integers(0, 4, wl)).astype(np.uint8)
        inst = _instance(rng, pat, int(rng.integers(0, 4)))[:wl]
        if kind == "planted" and len(inst) < wl:
            pos = int(rng.integers(0, wl - len(inst) + 1))
            row[pos : pos + len(inst)] = inst
        elif kind == "at_start":
            row[: len(inst)] = inst
        elif kind == "at_end":
            row[wl - len(inst) :] = inst
        elif kind == "twice":
            exact = _instance(rng, pat, 0)[: wl // 2]
            row[: len(exact)] = exact
            row[wl - len(exact) :] = exact
        elif kind == "tandem":
            head = _instance(rng, pat[: max(len(pat) // 4, 1)], 0)
            if len(head):
                row[:] = np.tile(head, wl // len(head) + 1)[:wl]
            tail = inst[: wl // 2]
            row[wl - len(tail) :] = tail
        elif kind == "n_bases":
            row[rng.random(wl) < 0.15] = 15
            row[: len(inst)] = inst
        elif kind == "zero_masks":
            row[rng.random(wl) < 0.1] = 0
        elif kind == "empty":
            wl = 0
        elif kind == "short":
            wl = int(rng.integers(1, max(int(plens.min()) // 2, 1) + 1))
            row = row[:wl]
        windows[b, :wl] = row[:wl]
        wlens[b] = wl
    return pmasks, plens, windows, wlens


DOVETAIL_KINDS = ("noisy", "unrelated", "a_empty", "b_empty", "both_empty", "a_longer",
                  "n_codes", "shifted")


def dovetail_case(seed: int, n: int, L: int, lens: tuple[int, int] = (58, 68),
                  a_lens=None):
    """Pairs of UMI-like codes for the budgeted-dovetail distance (kernel
    B6): (a (n, L) uint8, a_lens (n,) int32, b (n, L) uint8, b_lens (n,)
    int32), PAD-filled past each length. Lengths are drawn from ``lens``
    (capped at L). Pairs cycle over :data:`DOVETAIL_KINDS`: b a noisy copy
    of a (10% errors); unrelated; a_len 0, b_len 0 or both; b a copy of a
    cut short (a_len > b_len); runs of N (code 4); b a copy of a shifted
    by up to 20 bases at either end (overhangs past the free budget).
    ``a_lens``, when given, are the first sequences' lengths (cycled over
    the pairs, capped at L) in place of drawn ones."""
    rng = np.random.default_rng(seed)
    lo, hi = min(lens[0], L), min(lens[1], L)
    rows_a, rows_b = [], []
    for i in range(n):
        kind = DOVETAIL_KINDS[i % len(DOVETAIL_KINDS)]
        a_len = int(rng.integers(lo, hi + 1))
        if a_lens is not None:
            a_len = min(a_lens[i % len(a_lens)], L)
        a = rng.integers(0, 4, a_len).astype(np.uint8)
        b = noisy_copy(rng, a, 0.1)
        if kind == "unrelated":
            b = rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(np.uint8)
        elif kind in ("a_empty", "both_empty"):
            a = a[:0]
        if kind in ("b_empty", "both_empty"):
            b = b[:0]
        elif kind == "a_longer":
            b = b[: int(rng.integers(0, max(len(a) - 1, 1)))]
        elif kind == "n_codes":
            a = a.copy()
            a[rng.random(len(a)) < 0.1] = 4
        elif kind == "shifted":
            s = int(rng.integers(1, 21))
            b = (np.concatenate([rng.integers(0, 4, s).astype(np.uint8), a])
                 if rng.random() < 0.5 else a[s:])
        rows_a.append(a[:L])
        rows_b.append(b[:L])
    a, al = pack(rows_a, L)
    b, bl = pack(rows_b, L)
    return a, al, b, bl
