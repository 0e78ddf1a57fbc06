"""Hashed k-mer sketching: candidate selection + strand detection.

The counterpart of the JAX package's ``ops/sketch.py``: every sequence
becomes a dense hashed k-mer count profile, and read->reference candidate
selection is one float32 ``(reads, D) @ (D, refs)`` product followed by a
top-k. The top-k is a stable descending sort, so ties go to the lower
index exactly as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
order). Profiles hold exact integer counts and their norms are exact; only
the float32 product's summation order differs from XLA's.
"""

from __future__ import annotations

import torch

_HASH_MULT = 2654435761


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k`` order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def kmer_profile(codes: torch.Tensor, lengths: torch.Tensor, k: int = 8,
                 dim: int | None = 4096) -> torch.Tensor:
    """(B, L) dense codes -> (B, dim) float32 k-mer count profiles.

    Windows containing N or padding contribute nothing. With ``dim`` set,
    the packed 2-bit k-mer is bucketed by a multiplicative hash (uint32
    wraparound); ``dim=None`` means exact 4**k buckets.
    """
    B, L = codes.shape
    dev = codes.device
    c = codes.to(torch.int64)
    n = max(L - k + 1, 0)
    valid = (c < 4) & (torch.arange(L, device=dev)[None, :] < lengths.to(dev)[:, None])
    packed = torch.zeros((B, n), dtype=torch.int64, device=dev)
    ok = torch.ones((B, n), dtype=torch.bool, device=dev)
    for off in range(k):
        packed = packed * 4 + c[:, off : n + off]
        ok = ok & valid[:, off : n + off]
    if dim is None:
        dim = 4**k
        bucket = packed
    else:
        bucket = ((packed * _HASH_MULT) & 0xFFFFFFFF) % dim
    bucket = torch.where(ok, bucket, dim)  # overflow bucket, dropped below
    out = torch.zeros((B, dim + 1), dtype=torch.float32, device=dev)
    out.scatter_add_(1, bucket, torch.ones_like(bucket, dtype=torch.float32))
    return out[:, :dim]


def top_candidates(q_profiles: torch.Tensor, t_profiles: torch.Tensor, k: int) -> torch.Tensor:
    """Rank targets by raw profile dot product; (Q, k) int32 indices."""
    scores = q_profiles @ t_profiles.T
    return top_k(scores, k)[1].to(torch.int32)


def revcomp_batch(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Length-aware reverse complement of a padded dense-code batch."""
    B, L = codes.shape
    pos = torch.arange(L, device=codes.device, dtype=torch.int64)[None, :]
    src = lengths.to(torch.int64)[:, None] - 1 - pos
    gathered = codes.to(torch.int64).gather(1, src.clamp(0, L - 1))
    comp = torch.where(gathered < 4, 3 - gathered, gathered)
    return torch.where(src >= 0, comp, gathered).to(torch.uint8)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True)).clamp(min=1e-6)


def candidates_both_strands(read_codes, read_lens, ref_profiles, top_k_: int = 4,
                            k: int = 8, dim: int = 4096):
    """Score reads (both strands) against a reference profile panel.

    Returns (cand_idx (B, top_k) int32 best-first, cand_score (B, top_k)
    float32 cosines, is_reverse (B,) bool).
    """
    fwd = kmer_profile(read_codes, read_lens, k=k, dim=dim)
    rev = kmer_profile(revcomp_batch(read_codes, read_lens), read_lens, k=k, dim=dim)
    refs_n = _norm(ref_profiles)
    fwd_scores = _norm(fwd) @ refs_n.T
    rev_scores = _norm(rev) @ refs_n.T
    is_reverse = rev_scores.max(dim=1).values > fwd_scores.max(dim=1).values
    scores = torch.where(is_reverse[:, None], rev_scores, fwd_scores)
    best, idx = top_k(scores, top_k_)
    return idx.to(torch.int32), best, is_reverse


def similarity_matrix(profiles_a: torch.Tensor, profiles_b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity panel-vs-panel (the self-homology prefilter)."""
    return _norm(profiles_a) @ _norm(profiles_b).T


def diag_offset(read_lens, ref_lens):
    """Band-centre estimate for :func:`.sw_align.align_banded`: the
    symmetric overhang ``-(read_len - ref_len) // 2`` (floor division),
    which keeps the true diagonal within a 256-wide band for any split of
    the amplicon's <= ~90 nt softclips between the two ends."""
    return -((read_lens - ref_lens) // 2)
