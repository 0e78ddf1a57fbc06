"""Device-memory-budgeted batch sizing (a copy of the JAX package's
``parallel/budget.py`` model; only :func:`detect_hbm_gb` differs, reading
the card through ``torch.cuda.mem_get_info``).

Footprint models (bytes, from the shapes the kernels allocate):

- fused read pass: per read of padded width W — ~10 u8 planes of W, two
  k-mer-profile scatters of (dim+1) f32, top_k banded-SW outputs, and the
  (R,) candidate score rows.
- polish cluster tile: per cluster of S subreads x width W — the traceback
  planes (one u16 per band cell) plus the base/ins pileup columns.
"""

from __future__ import annotations

import dataclasses

DEFAULT_HBM_GB = 12.0  # conservative budget when there is no card to ask


def detect_hbm_gb(device=None) -> float:
    """Total memory of the CUDA card ``device`` in GB; the default budget
    for a CPU run."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return DEFAULT_HBM_GB
    _, total = torch.cuda.mem_get_info(torch.device(device))
    return total / 1e9


def _pow2_floor(n: int, lo: int, hi: int) -> int:
    p = lo
    while p * 2 <= min(n, hi):
        p *= 2
    return max(p, lo)


@dataclasses.dataclass
class BudgetModel:
    """Derives device batch sizes from one memory budget.

    ``working_fraction`` reserves headroom for temporaries.
    """

    hbm_gb: float
    working_fraction: float = 0.25

    @property
    def budget_bytes(self) -> int:
        return int(self.hbm_gb * 1e9 * self.working_fraction)

    def read_bytes(self, width: int, profile_dim: int = 4096,
                   top_k: int = 2, band_width: int = 256,
                   num_refs: int = 1024) -> int:
        planes = 10 * width
        profiles = 2 * 4 * (profile_dim + 1)
        scores = 2 * 4 * num_refs
        sw_out = top_k * 6 * 4 * band_width
        return planes + profiles + scores + sw_out

    def read_batch(self, width: int, profile_dim: int = 4096,
                   top_k: int = 2, band_width: int = 256,
                   num_refs: int = 1024) -> int:
        per = self.read_bytes(width, profile_dim, top_k, band_width, num_refs)
        return _pow2_floor(self.budget_bytes // per, 128, 16384)

    def cluster_bytes(self, s_bucket: int, width: int,
                      band_width: int = 128,
                      keep_final_pileup: bool = True,
                      keep_pos: bool = False) -> int:
        traceback = 2 * s_bucket * width * band_width
        per_cell = (1 + 4 + 1) + (4 if keep_pos else 0)
        pileup = (2 if keep_final_pileup else 1) * s_bucket * width * per_cell
        votes = 2 * width * 4 * 8
        return traceback + pileup + votes

    # flat alignment lanes (clusters x subreads) per polish dispatch
    MAX_POLISH_LANES = 4096

    def cluster_batch(self, s_bucket: int, width: int,
                      band_width: int = 128,
                      keep_final_pileup: bool = True,
                      keep_pos: bool = False) -> int:
        per = self.cluster_bytes(s_bucket, width, band_width,
                                 keep_final_pileup, keep_pos)
        hi = min(256, max(1, self.MAX_POLISH_LANES // max(s_bucket, 1)))
        return _pow2_floor(self.budget_bytes // per, 1, hi)
