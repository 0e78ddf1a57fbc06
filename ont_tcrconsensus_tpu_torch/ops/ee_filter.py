"""Expected-error read filtering (the JAX package's ``ops/ee_filter.py``).

A read passes iff ``sum_i 10^(-Q_i/10) / len(read) <= max_ee_rate`` and
``len(read) >= min_len`` — vsearch ``--fastq_filter --fastq_maxee_rate``.
float32 like the reference; sums are taken in another order than XLA's, so
the EE values agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch


def expected_errors_span(quals: torch.Tensor, t_start: torch.Tensor,
                         t_end: torch.Tensor) -> torch.Tensor:
    """(B,) float32 expected errors over each read's [t_start, t_end)."""
    q = quals.to(torch.float32)
    pos = torch.arange(q.shape[1], device=q.device, dtype=torch.int32)[None, :]
    in_span = (pos >= t_start[:, None]) & (pos < t_end[:, None])
    perr = torch.pow(torch.tensor(10.0, device=q.device), -q / 10.0)
    return torch.where(in_span, perr, 0.0).sum(dim=1)


def ee_rate_mask_span(quals, t_start, t_end, max_ee_rate: float, min_len: int):
    """Keep-mask of the quality+length filter over the trimmed span."""
    ee = expected_errors_span(quals, t_start, t_end)
    lens = t_end - t_start
    rate = ee / lens.clamp(min=1).to(torch.float32)
    limit = torch.tensor(max_ee_rate, dtype=torch.float32, device=rate.device)
    return (rate <= limit) & (lens >= min_len)
