"""Length bucketing: ragged reads -> fixed-shape device batches.

A copy of the JAX package's record path (``io/bucketing.py``): reads are
grouped into a small set of padded widths, and each bucket is emitted in
fixed-size batches (a final partial batch is padded up with dummy rows,
masked out by ``valid``). The fused read pass picks its SW subset per
batch, so batch composition is part of the result and must match the
reference package row for row.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Iterator, Sequence

import numpy as np

from ont_tcrconsensus_tpu_torch.ops import encode

DEFAULT_WIDTHS = (256, 512, 1024, 2048, 3072, 4096)

# phred fill for quality-less rows of a mixed FASTQ/FASTA stream
QUAL_FILL = 18


@dataclasses.dataclass
class IngestCounters:
    """Records drawn from the parser, and those dropped by the length gates."""

    n_records: int = 0
    n_dropped_short: int = 0
    n_dropped_long: int = 0


@dataclasses.dataclass
class ReadBatch:
    """One padded batch.

    codes: (B, W) uint8 dense codes; quals: (B, W) uint8 Phred or None;
    lengths: (B,) int32; valid: (B,) bool (False rows are padding);
    ids: the per-read identifiers (headers), length B (padding rows '').
    """

    codes: np.ndarray
    quals: np.ndarray | None
    lengths: np.ndarray
    valid: np.ndarray
    ids: list[str]
    width: int

    @property
    def batch_size(self) -> int:
        return self.codes.shape[0]

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())


def bucket_width(length: int, widths: Sequence[int] = DEFAULT_WIDTHS) -> int | None:
    """Smallest configured width that fits; None if the read is too long."""
    for w in widths:
        if length <= w:
            return w
    return None


def pow2_ceil(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo)."""
    p = lo
    while p < n:
        p *= 2
    return p


def batch_reads(
    records: Iterable,
    batch_size: int = 2048,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    with_quals: bool = True,
    min_len: int = 1,
    counters: IngestCounters | None = None,
) -> Iterator[ReadBatch]:
    """Group FastxRecords into per-width padded batches.

    Reads longer than the largest width (or shorter than ``min_len``) are
    dropped and tallied into ``counters``. Emission order within a bucket
    preserves input order; buckets flush when full and at end-of-stream.
    """
    pending: dict[int, list] = {w: [] for w in widths}

    def flush(w: int) -> ReadBatch:
        recs = pending[w]
        pending[w] = []
        return _make_batch(recs, w, batch_size, with_quals)

    for rec in records:
        ln = len(rec.sequence)
        if counters is not None:
            counters.n_records += 1
        if ln < min_len:
            if counters is not None:
                counters.n_dropped_short += 1
            continue
        w = bucket_width(ln, widths)
        if w is None:
            if counters is not None:
                counters.n_dropped_long += 1
            continue
        pending[w].append(rec)
        if len(pending[w]) == batch_size:
            yield flush(w)
    for w in widths:
        if pending[w]:
            yield flush(w)


def _make_batch(recs: list, width: int, batch_size: int, with_quals: bool) -> ReadBatch:
    n = len(recs)
    # a partial batch pads to the pow2 of its real count (floor 64)
    B = min(batch_size, pow2_ceil(n, 64))
    codes = np.full((B, width), encode.PAD_CODE, dtype=np.uint8)
    # FASTA records carry no quality: quals stay None
    with_quals = with_quals and any(
        getattr(rec, "quality", None) for rec in recs
    )
    quals = np.full((B, width), QUAL_FILL, dtype=np.uint8) if with_quals else None
    lengths = np.zeros((B,), dtype=np.int32)
    valid = np.zeros((B,), dtype=bool)
    ids: list[str] = []
    for i, rec in enumerate(recs):
        seq = rec.sequence
        codes[i, : len(seq)] = encode.encode_seq(seq)
        lengths[i] = len(seq)
        valid[i] = True
        if with_quals and getattr(rec, "quality", None):
            raw = np.frombuffer(rec.quality.encode("ascii"), dtype=np.uint8)
            if raw.size and raw.min() < 33:
                raise ValueError(
                    f"read {rec.name!r}: quality below Phred-33 '!'"
                )
            quals[i, : raw.size] = raw - 33
        ids.append(rec.header if hasattr(rec, "header") else rec.name)
    ids.extend([""] * (B - n))
    return ReadBatch(codes=codes, quals=quals, lengths=lengths, valid=valid, ids=ids, width=width)
