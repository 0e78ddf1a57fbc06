"""Host-side FASTA/FASTQ streaming.

The reference leans on pysam.FastxFile + external tools for all sequence IO
(e.g. ont_tcr_consensus/extract_umis.py:216,
region_split.py:241). Here IO is a first-party streaming layer that feeds the
device batcher: gzip-transparent record iteration, zero intermediate files,
and batched emission sized for padded device arrays. A copy of the JAX
package's pure-Python parser: the port has no native parser and so no
silent fallback between two parsers.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from collections.abc import Iterable, Iterator
from typing import IO


@dataclasses.dataclass
class FastxRecord:
    name: str        # first whitespace-delimited token of the header
    comment: str     # remainder of the header ('' if none)
    sequence: str
    quality: str | None = None  # None for FASTA

    @property
    def header(self) -> str:
        return f"{self.name} {self.comment}".rstrip()


def _open_text(path: str | os.PathLike[str]) -> IO[str]:
    p = os.fspath(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rt")
    return open(p)


def _split_header(line: str) -> tuple[str, str]:
    parts = line[1:].rstrip("\n").split(None, 1)
    if not parts:
        return "", ""
    return parts[0], parts[1] if len(parts) > 1 else ""


def _gzip_context(path, fh, exc) -> ValueError:
    """Wrap a gzip decode failure with file + byte-offset context.

    ``gzip.BadGzipFile``/``EOFError`` out of a streaming read used to
    surface as a raw traceback with no hint of WHICH file died WHERE; the
    quarantine path (io/validate.py) turns these into events, but even
    under ``on_bad_record=fail`` the error must name the file and the
    decompressed offset reached.
    """
    try:
        offset = fh.buffer.tell() if hasattr(fh, "buffer") else fh.tell()
    except (OSError, ValueError):
        offset = -1
    return ValueError(
        f"{os.fspath(path)}: truncated or corrupt gzip stream near "
        f"decompressed byte offset {offset} ({exc}); with "
        "on_bad_record=quarantine the decodable prefix is kept and this "
        "becomes a quarantine event"
    )


def read_fastx(path: str | os.PathLike[str]) -> Iterator[FastxRecord]:
    """Iterate records from a FASTA/FASTQ file (.gz transparent).

    Format is sniffed from the first record character. FASTA sequences may be
    multi-line; FASTQ records must be 4-line (the only form ONT emits).
    A truncated/corrupt ``.gz`` raises ValueError with file + offset context
    instead of a bare gzip traceback.
    """
    with _open_text(path) as fh:
        try:
            yield from _read_fastx_body(path, fh)
        except (gzip.BadGzipFile, EOFError) as exc:
            raise _gzip_context(path, fh, exc) from exc


def _read_fastx_body(path, fh) -> Iterator[FastxRecord]:
    first = fh.read(1)
    if not first:
        return
    if first == ">":
        name, comment = _split_header(">" + fh.readline())
        seq_parts: list[str] = []
        for line in fh:
            if line.startswith(">"):
                yield FastxRecord(name, comment, "".join(seq_parts))
                name, comment = _split_header(line)
                seq_parts = []
            else:
                seq_parts.append(line.strip())
        yield FastxRecord(name, comment, "".join(seq_parts))
    elif first == "@":
        header = "@" + fh.readline()
        while header:
            if not header.strip():  # tolerate blank lines between records
                header = fh.readline()
                continue
            name, comment = _split_header(header)
            seq = fh.readline().strip()
            plus = fh.readline()
            qual = fh.readline().strip()
            if not plus.startswith("+"):
                raise ValueError(f"malformed FASTQ record near {name!r} in {path}")
            if not qual and seq:
                raise ValueError(f"truncated FASTQ record {name!r} in {path}")
            if len(qual) != len(seq):
                raise ValueError(
                    f"FASTQ record {name!r} in {path}: qual length "
                    f"{len(qual)} != seq length {len(seq)}"
                )
            yield FastxRecord(name, comment, seq, qual)
            header = fh.readline()
    else:
        raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def read_fasta_dict(path: str | os.PathLike[str]) -> dict[str, str]:
    """FASTA -> {name: sequence} (reference region_split.py:29-58 analogue)."""
    out: dict[str, str] = {}
    for rec in read_fastx(path):
        if rec.name in out:
            raise ValueError(f"duplicate sequence name {rec.name!r} in {path}")
        out[rec.name] = rec.sequence
    return out


def write_fasta(
    path: str | os.PathLike[str],
    records: Iterable[tuple[str, str]],
    append: bool = False,
    width: int = 0,
) -> int:
    """Write (header, seq) pairs; returns the number written.

    ``width=0`` writes single-line sequences (what every downstream stage of
    the pipeline expects).
    """
    n = 0
    mode = "a" if append else "w"
    p = os.fspath(path)
    opener = gzip.open(p, mode + "t") if p.endswith(".gz") else open(p, mode)
    with opener as fh:
        for header, seq in records:
            fh.write(f">{header}\n")
            if width and len(seq) > width:
                for i in range(0, len(seq), width):
                    fh.write(seq[i : i + width] + "\n")
            else:
                fh.write(seq + "\n")
            n += 1
    return n


def write_fastq(
    path: str | os.PathLike[str],
    records: Iterable[tuple[str, str, str]],
    append: bool = False,
) -> int:
    """Write (header, seq, qual) triples; returns the number written."""
    n = 0
    mode = "a" if append else "w"
    p = os.fspath(path)
    opener = gzip.open(p, mode + "t") if p.endswith(".gz") else open(p, mode)
    with opener as fh:
        for header, seq, qual in records:
            fh.write(f"@{header}\n{seq}\n+\n{qual}\n")
            n += 1
    return n
