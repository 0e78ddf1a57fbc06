"""Reference self-homology mapping and region clustering.

The counterpart of the JAX package's ``cluster/regions.py``: hashed k-mer
cosine prefilter -> banded SW on the shortlisted pairs (kernel B1 on the
card) -> the reference's own filters and greedy clustering:

- pairs kept iff alignment block length > 0.99 * min(len_a, len_b),
- per query the most-similar partner by blast identity,
- greedy clustering over tuples sorted by similarity desc.

If NO pair survives the overlap filter, ``max_blast_id`` is None and the
caller falls back to a configured default.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.ops import encode, sketch, sw_kernel

# reference names of negative controls, left out of the detected-region
# fraction (the reference's region split)
NEGATIVE_CONTROL_SUFFIXES = ("_v_n", "cdr3j_n", "full_n")

@dataclasses.dataclass
class HomologyResult:
    region_cluster: dict[str, int]              # region name -> cluster index
    most_similar: list[tuple[str, str, float]]  # (query, partner, blast_id)
    max_blast_id: float | None                  # the dynamic precision bar
    stats: dict[str, float]


def greedy_most_similar_clustering(
    tuples: list[tuple[str, str, float]], similarity_threshold: float
) -> list[set[str]]:
    """The reference's greedy single-link pass, quirks included:
    sub-threshold pairs of two unseen regions are skipped without marking
    them seen, and a pair touching an existing cluster joins the *first*
    cluster containing either region."""
    sorted_data = sorted(tuples, key=lambda x: x[2], reverse=True)
    clusters: list[set[str]] = []
    seen: set[str] = set()
    for a, b, sim in sorted_data:
        if a not in seen and b not in seen:
            if sim >= similarity_threshold:
                clusters.append({a, b})
                seen.update([a, b])
        elif a in seen or b in seen:
            for cluster in clusters:
                if a in cluster or b in cluster:
                    if sim >= similarity_threshold:
                        cluster.update([a, b])
                        seen.update([a, b])
                    break
    return clusters


def self_homology_map(
    reference: dict[str, str],
    cluster_threshold: float,
    device: str | torch.device | None = None,
    prefilter_cosine: float = 0.12,
    band_width: int = 512,
    sketch_k: int = 8,
    sketch_dim: int = 4096,
    pair_batch: int = 256,
) -> HomologyResult:
    """All-vs-all reference homology -> region clusters + precision bar, on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    names = list(reference)
    seqs = [reference[n] for n in names]
    if not names:
        return HomologyResult({}, [], None, {"num_pairs_prefilter": 0})
    max_len = max(len(s) for s in seqs)
    codes, lens = encode.encode_batch(seqs, pad_to=max_len)
    d_codes = torch.from_numpy(codes).to(device)
    d_lens = torch.from_numpy(lens).to(device)
    profiles = sketch.kmer_profile(d_codes, d_lens, k=sketch_k, dim=sketch_dim)
    sim = sketch.similarity_matrix(profiles, profiles).cpu().numpy()

    ii, jj = np.where(np.triu(sim, k=1) >= prefilter_cosine)
    tuples: list[tuple[str, str, float]] = []
    if len(ii):
        blast_ids = np.zeros(len(ii), dtype=np.float64)
        block_lens = np.zeros(len(ii), dtype=np.int64)
        offs = (-((lens[ii] - lens[jj]) // 2)).astype(np.int32)
        for s in range(0, len(ii), pair_batch):
            sl = slice(s, min(s + pair_batch, len(ii)))
            qi = torch.from_numpy(ii[sl]).to(device)
            ti = torch.from_numpy(jj[sl]).to(device)
            res = sw_kernel.align_banded_auto(
                d_codes[qi], d_lens[qi], d_codes[ti], d_lens[ti],
                torch.from_numpy(offs[sl]).to(device), band_width=band_width,
            )
            blast_ids[sl] = res.blast_id.cpu().numpy()
            block_lens[sl] = res.n_cols.cpu().numpy()
        min_len = np.minimum(lens[ii], lens[jj])
        keep = block_lens > 0.99 * min_len
        best: dict[int, tuple[int, float]] = {}
        for qi, ti, bid in zip(ii[keep], jj[keep], blast_ids[keep]):
            cur = best.get(qi)
            if cur is None or bid > cur[1]:
                best[qi] = (ti, bid)
        tuples = [(names[q], names[t], float(b)) for q, (t, b) in sorted(best.items())]

    clusters = greedy_most_similar_clustering(tuples, cluster_threshold)
    region_cluster: dict[str, int] = {}
    idx = 0
    for cl in clusters:
        for region in cl:
            region_cluster[region] = idx
        idx += 1
    for region in names:  # singletons, in reference order
        if region not in region_cluster:
            region_cluster[region] = idx
            idx += 1

    bids = [t[2] for t in tuples]
    stats = {
        "num_pairs_prefilter": int(len(ii)),
        "num_most_similar_pairs": len(tuples),
        "num_region_clusters": idx,
    }
    if bids:
        stats.update({
            "median_blast_id": float(np.median(bids)),
            "q925_blast_id": float(np.quantile(bids, 0.925)),
            "q950_blast_id": float(np.quantile(bids, 0.950)),
            "q975_blast_id": float(np.quantile(bids, 0.975)),
            "q990_blast_id": float(np.quantile(bids, 0.990)),
            "max_blast_id": float(np.max(bids)),
        })
    return HomologyResult(
        region_cluster=region_cluster,
        most_similar=tuples,
        max_blast_id=float(np.max(bids)) if bids else None,
        stats=stats,
    )


def region_length_dict(reference: dict[str, str]) -> dict[str, int]:
    """Each region's length (the reference's region_split.py:52-58)."""
    return {name: len(seq) for name, seq in reference.items()}


def countable_regions(reference: dict[str, str]) -> set[str]:
    """Regions that count toward detection stats: negative controls
    excluded (the reference's region_split.py:302-309)."""
    return {n for n in reference if not n.endswith(NEGATIVE_CONTROL_SUFFIXES)}
