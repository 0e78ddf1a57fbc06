"""Seeded inputs for the banded DPs (kernels B1 and B2 and their plain twins).

Every case is made with numpy from a seed, so the JAX reference, the plain
PyTorch versions and the CUDA kernels can be fed the same bytes: the
parity tests use :func:`dp_case` at small sizes, ``chip_smoke.py`` uses
:func:`dp_batch` at the main path's shapes.
"""

from __future__ import annotations

import numpy as np

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
