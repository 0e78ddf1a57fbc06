"""Length bucketing: ragged reads -> fixed-shape device batches.

A copy of the JAX package's ``io/bucketing.py``: the record path
(:func:`batch_reads`), the columnar paths the native parser feeds
(:func:`batch_parsed_reads` over a whole-file parse,
:func:`batch_parsed_chunks` over a stream of chunks, the default ingest)
and the pre-encoded path (:class:`EncodedRecords`, the graph executor's
round-1 to round-2 hand-off). Reads are grouped into a small set of padded
widths, and each bucket is emitted in fixed-size batches (a final partial
batch is padded up with dummy rows, masked out by ``valid``); every path
gives the record path's batches on the same data. The fused read pass picks its SW subset per
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


def _rows_to_batch(rows: list, w: int, batch_size: int, has_quals: bool) -> ReadBatch:
    """One padded batch from (codes, quals or None, name) rows: the padded
    batch policy of the columnar and pre-encoded paths, byte for byte
    :func:`_make_batch`'s on the same data (a partial batch pads to the
    pow2 of its real count, floor 64)."""
    B = min(batch_size, pow2_ceil(len(rows), 64))
    codes = np.full((B, w), encode.PAD_CODE, dtype=np.uint8)
    quals = np.full((B, w), QUAL_FILL, dtype=np.uint8) if has_quals else None
    lengths = np.zeros((B,), dtype=np.int32)
    valid = np.zeros((B,), dtype=bool)
    ids: list[str] = []
    for i, (c, q, nm) in enumerate(rows):
        codes[i, : c.size] = c
        if has_quals and q is not None:
            quals[i, : q.size] = q
        lengths[i] = c.size
        valid[i] = True
        ids.append(nm)
    ids.extend([""] * (B - len(rows)))
    return ReadBatch(codes=codes, quals=quals, lengths=lengths, valid=valid, ids=ids, width=w)


def batch_parsed_reads(
    parsed,
    batch_size: int = 2048,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    min_len: int = 1,
) -> Iterator[ReadBatch]:
    """Batches straight from a columnar :class:`..native.ParsedFastx` parse:
    bucketing is a vectorized ``searchsorted`` and each batch is filled by
    row slicing, with no per-read record objects. Emission order is
    :func:`batch_reads`' on the same file: input order within a bucket,
    buckets flushed when full and at end-of-stream in width order."""
    lens = np.asarray(parsed.lengths)
    widths_arr = np.asarray(widths)
    bucket_idx = np.searchsorted(widths_arr, lens)  # widths[i-1] < len <= widths[i]
    eligible = (lens >= min_len) & (bucket_idx < len(widths_arr))
    has_quals = parsed.quals is not None
    pending: dict[int, list[int]] = {int(w): [] for w in widths}

    def flush(w: int) -> ReadBatch:
        rows = pending[w]
        pending[w] = []
        return _rows_to_batch(
            [(parsed.codes[parsed.offsets[r]:parsed.offsets[r + 1]],
              parsed.quals[parsed.offsets[r]:parsed.offsets[r + 1]] if has_quals else None,
              parsed.names[r]) for r in rows],
            w, batch_size, has_quals,
        )

    for r in np.where(eligible)[0]:
        w = int(widths_arr[bucket_idx[r]])
        pending[w].append(int(r))
        if len(pending[w]) == batch_size:
            yield flush(w)
    for w in widths:
        if pending[int(w)]:
            yield flush(int(w))


def batch_parsed_chunks(
    chunks,
    batch_size: int = 2048,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    min_len: int = 1,
    subsample: int | None = None,
    counters: IngestCounters | None = None,
) -> Iterator[ReadBatch]:
    """:func:`batch_parsed_reads` over a STREAM of ParsedFastx chunks.

    Buckets carry across chunk boundaries, so the batches are a whole-file
    parse's. Pending rows are copied out of a finished chunk (at most
    ``batch_size`` rows a bucket) so each chunk's arrays free once it is
    consumed: peak host memory is O(chunk + pending), not O(file).
    ``subsample`` counts RAW records, the ineligible ones too, as the
    record path's head-subsample does; ``counters`` tallies the records and
    the length gates' drops.
    """
    widths_arr = np.asarray(widths)
    pending: dict[int, list[tuple]] = {int(w): [] for w in widths}
    has_quals = False
    taken = 0

    def flush(w: int) -> ReadBatch:
        rows = pending[w]
        pending[w] = []
        return _rows_to_batch(rows, w, batch_size, has_quals)

    for parsed in chunks:
        if parsed.quals is not None:
            has_quals = True
        n_raw = parsed.num_records
        if subsample is not None:
            n_raw = min(n_raw, subsample - taken)
            taken += n_raw
        lens = np.asarray(parsed.lengths)[:n_raw]
        bucket_idx = np.searchsorted(widths_arr, lens)
        if counters is not None:
            counters.n_records += int(n_raw)
            short = lens < min_len
            counters.n_dropped_short += int(short.sum())
            counters.n_dropped_long += int((~short & (bucket_idx >= len(widths_arr))).sum())
        for r in np.where((lens >= min_len) & (bucket_idx < len(widths_arr)))[0]:
            w = int(widths_arr[bucket_idx[r]])
            s, e = parsed.offsets[r], parsed.offsets[r + 1]
            pending[w].append((parsed.codes[s:e],
                               parsed.quals[s:e] if parsed.quals is not None else None,
                               parsed.names[r]))
            if len(pending[w]) == batch_size:
                yield flush(w)
        # copy the leftover views (their base is the chunk's array) so the
        # chunk can free; rows copied at earlier boundaries are owned
        for w in widths:
            pending[int(w)] = [
                (c if c.base is None else c.copy(),
                 q if q is None or q.base is None else q.copy(), nm)
                for c, q, nm in pending[int(w)]
            ]
        if subsample is not None and taken >= subsample:
            break
    for w in widths:
        if pending[int(w)]:
            yield flush(int(w))


@dataclasses.dataclass
class EncodedRecords:
    """Pre-encoded reads: parallel header/code-vector lists.

    The device-resident hand-off type: round 1's consensus codes (under
    ``keep_codes``) go to round 2 through :func:`batch_encoded` without a
    decode-to-string and re-encode pass. Code vectors are 1-d uint8 in
    0..4; decode∘encode is a bijection on that alphabet, so the batches are
    byte-identical to the string path's for the same sequences.
    """

    headers: list[str]
    codes: list[np.ndarray]

    def __len__(self) -> int:
        return len(self.headers)


def batch_encoded(
    records: EncodedRecords,
    batch_size: int = 2048,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    min_len: int = 1,
    counters: IngestCounters | None = None,
) -> Iterator[ReadBatch]:
    """:func:`batch_reads` over :class:`EncodedRecords`: the same buckets,
    drop gates, counters and flush policy, and no qualities (consensus
    sequences carry none, as FASTA records do)."""
    pending: dict[int, list] = {w: [] for w in widths}

    def flush(w: int) -> ReadBatch:
        rows = pending[w]
        pending[w] = []
        return _rows_to_batch(rows, w, batch_size, has_quals=False)

    for header, codes in zip(records.headers, records.codes):
        codes = np.asarray(codes, dtype=np.uint8)
        ln = int(codes.size)
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
        pending[w].append((codes, None, header))
        if len(pending[w]) == batch_size:
            yield flush(w)
    for w in widths:
        if pending[w]:
            yield flush(w)
