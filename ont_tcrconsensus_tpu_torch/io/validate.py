"""Record-level input validation and the quarantine policy.

A copy of the JAX package's ``io/validate.py`` (the port imports nothing of
that package):

- The ``on_bad_record`` config key (:data:`POLICIES`) selects ``fail``
  (the first bad record raises), ``quarantine`` (bad records land in a
  per-library ``quarantine.fastq.gz`` with machine-readable reasons in
  ``robustness_report.json``) or ``drop`` (counted and reported only).
- :func:`parse_bytes_tolerant` is the pure-Python twin of the native C++
  parser's tolerant mode (``io/native/fastx_parser.cpp``
  ``parse_stream_tol``): the same resync algorithm, the same canonical
  reason strings, the same byte offsets. The native parser is the ingest
  path; this twin is the fallback where it does not build, and the
  differential fuzzer (``scripts/torch_fuzz_ingest.py``) and the tests
  hold the two to each other and to the JAX package's.
- :class:`IngestGuard` routes bad records per the policy and feeds the
  robustness report.
- :func:`validate_inputs` backs ``python -m ont_tcrconsensus_tpu_torch
  <config> --validate``: the config, the declared stage graph, an input
  scan and the stage manifests of an existing workdir, with no device work.

Nothing here imports torch: ``--validate`` runs on a host whose card is
wedged.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import sys
import zlib
from collections.abc import Iterator

import numpy as np

from ont_tcrconsensus_tpu_torch.robustness import lockcheck

# Canonical malformation reasons: byte for byte the kReason* strings of
# io/native/fastx_parser.cpp (the fuzzer pins this) and the JAX package's.
R_GZIP = "truncated or corrupt gzip stream"
R_NOT_FASTX = "not FASTA/FASTQ"
R_BAD_HEADER = "malformed FASTQ header"
R_MISSING_PLUS = "malformed FASTQ record (missing +)"
R_LEN_MISMATCH = "FASTQ qual length != seq length"
R_BAD_QUAL = "quality below Phred-33 '!'"
R_TRUNCATED = "truncated FASTQ record"

POLICIES = ("fail", "quarantine", "drop")

# base -> dense code LUT, mirroring ops/encode._CODE_LUT (A=0 C=1 G=2 T=3,
# N/other=4) without importing ops.encode; tests pin the two tables equal.
CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"TtUu", 3)):
    for _ch in _b:
        CODE_LUT[_ch] = _c


@dataclasses.dataclass
class BadRecord:
    """One quarantined region of an input file."""

    offset: int    # absolute byte offset into the DECOMPRESSED stream
    reason: str    # canonical reason string (R_* above)
    raw: bytes     # the raw bytes of the region (quarantine payload)
    path: str = ""


@dataclasses.dataclass
class RawFastxRecord:
    """A record as raw bytes (full header, no name/comment split), the
    form the tests compare with the JAX package's parsers."""

    header: bytes  # full header after the '@'/'>' marker
    seq: bytes
    qual: bytes | None  # None for FASTA
    offset: int         # byte offset of the record's header line


def _split_lines(data: bytes) -> list[tuple[int, int, int]]:
    """(line_start, content_end, next_line_start) per line; content_end
    excludes the '\\n' and one trailing '\\r' (the native parser's
    next_line_t rule)."""
    out: list[tuple[int, int, int]] = []
    pos, n = 0, len(data)
    while pos < n:
        nl = data.find(b"\n", pos)
        if nl == -1:
            start, end, nxt = pos, n, n
        else:
            start, end, nxt = pos, nl, nl + 1
        if end > start and data[end - 1] == 0x0D:  # '\r'
            end -= 1
        out.append((start, end, nxt))
        pos = nxt
    return out


def parse_bytes_tolerant(
    data: bytes, path: str = "",
) -> tuple[list[RawFastxRecord], list[BadRecord]]:
    """Tolerant parse of a whole decompressed buffer.

    The Python twin of the native ``parse_stream_tol`` at EOF: malformed
    regions become :class:`BadRecord` entries and parsing resynchronizes
    at the next candidate record start — a line starting with ``@`` whose
    line+2 starts with ``+`` (the structure check keeps a quality line
    that happens to begin with '@' from being mistaken for a header).
    """
    records: list[RawFastxRecord] = []
    bads: list[BadRecord] = []
    lines = _split_lines(data)
    n = len(lines)

    def content_first(i: int) -> int | None:
        s, e, _ = lines[i]
        return data[s] if e > s else None

    def candidate_from(i: int) -> int | None:
        """Smallest j >= i where line j starts '@' and line j+2 starts '+'."""
        j = i
        while j < n:
            if content_first(j) == 0x40 and j + 2 < n:  # '@'
                if content_first(j + 2) == 0x2B:  # '+'
                    return j
            j += 1
        return None

    # kind detection: skip blanks, quarantine leading junk
    i = 0
    kind = 0
    while i < n:
        s, e, _ = lines[i]
        if e == s:
            i += 1
            continue
        first = data[s]
        if first in (0x40, 0x3E):  # '@' '>'
            kind = first
            break
        # junk prefix: scan for the first record-start line
        j = i + 1
        while j < n:
            cf = content_first(j)
            if cf in (0x40, 0x3E):
                break
            j += 1
        junk_start = lines[i][0]
        junk_end = lines[j][0] if j < n else len(data)
        bads.append(BadRecord(junk_start, R_NOT_FASTX,
                              data[junk_start:junk_end], path))
        if j == n:
            return records, bads
        kind = content_first(j)
        i = j
        break
    if kind == 0:
        return records, bads  # empty / blanks only

    if kind == 0x3E:  # FASTA
        header: bytes | None = None
        hoff = 0
        seq_parts: list[bytes] = []
        while i < n:
            s, e, _ = lines[i]
            i += 1
            if e == s:
                continue
            if data[s] == 0x3E:
                if header is not None:
                    records.append(RawFastxRecord(
                        header, b"".join(seq_parts), None, hoff))
                header = data[s + 1:e]
                hoff = s
                seq_parts = []
            else:
                seq_parts.append(data[s:e])
        if header is not None:
            records.append(RawFastxRecord(header, b"".join(seq_parts), None, hoff))
        return records, bads

    # FASTQ
    while True:
        while i < n and lines[i][1] == lines[i][0]:  # skip blanks
            i += 1
        if i >= n:
            break
        rec_start = lines[i][0]
        hs, he, _ = lines[i]
        if data[hs] != 0x40:  # '@'
            j = candidate_from(i)
            end = lines[j][0] if j is not None else len(data)
            bads.append(BadRecord(rec_start, R_BAD_HEADER,
                                  data[rec_start:end], path))
            if j is None:
                break
            i = j
            continue
        if i + 3 >= n:
            bads.append(BadRecord(rec_start, R_TRUNCATED,
                                  data[rec_start:], path))
            break
        ss, se, _ = lines[i + 1]
        ps, pe, _ = lines[i + 2]
        qs, qe, _ = lines[i + 3]
        if pe == ps or data[ps] != 0x2B:  # '+'
            j = candidate_from(i + 1)
            end = lines[j][0] if j is not None else len(data)
            bads.append(BadRecord(rec_start, R_MISSING_PLUS,
                                  data[rec_start:end], path))
            if j is None:
                break
            i = j
            continue
        rec_end = lines[i + 3][2]
        if se - ss != qe - qs:
            bads.append(BadRecord(rec_start, R_LEN_MISMATCH,
                                  data[rec_start:rec_end], path))
            i += 4
            continue
        qual = data[qs:qe]
        if qual and min(qual) < 33:
            bads.append(BadRecord(rec_start, R_BAD_QUAL,
                                  data[rec_start:rec_end], path))
            i += 4
            continue
        records.append(RawFastxRecord(
            data[hs + 1:he], data[ss:se], qual, rec_start))
        i += 4
    return records, bads


def read_bytes_tolerant(path: str | os.PathLike[str]) -> tuple[bytes, bool]:
    """(decompressed bytes, gzip_error) with gzread-compatible semantics.

    Mirrors zlib's ``gzopen`` transparency: content without the gzip magic
    is returned verbatim regardless of the file extension; a truncated or
    corrupt gzip stream yields the decodable prefix plus ``gzip_error=True``
    instead of an exception. Multi-member (concatenated) gzip is handled.
    """
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] != b"\x1f\x8b":
        return raw, False
    out = bytearray()
    buf = raw
    while buf:
        d = zlib.decompressobj(31)
        try:
            out += d.decompress(buf)
        except zlib.error:
            return bytes(out), True
        if not d.eof:
            return bytes(out), True  # truncated member
        if d.unused_data[:2] == b"\x1f\x8b":
            buf = d.unused_data
        else:
            break  # trailing non-gzip garbage: stop like gzread
    return bytes(out), False


def parse_path_tolerant(
    path: str | os.PathLike[str],
) -> tuple[list[RawFastxRecord], list[BadRecord]]:
    """Tolerant parse of a file (gzip-transparent): the ingest path under
    ``on_bad_record != fail``."""
    p = os.fspath(path)
    data, gz_error = read_bytes_tolerant(p)
    records, bads = parse_bytes_tolerant(data, p)
    if gz_error:
        bads.append(BadRecord(len(data), R_GZIP, b"", p))
    return records, bads


def iter_records_tolerant(
    path: str | os.PathLike[str], guard: "IngestGuard",
) -> Iterator:
    """FastxRecord stream with bad records routed through ``guard``: the
    quarantine/drop ingest path where the native parser does not build
    (the native parser streams and reports bad regions per chunk).

    It materializes the decompressed file: the tolerant resync algorithm
    is whole-buffer, and it stays byte for byte the native twin's (the
    fuzzer's contract). The bad records reach the guard before the first
    record is yielded.
    """
    from ont_tcrconsensus_tpu_torch.io import fastx

    records, bads = parse_path_tolerant(path)
    for bad in bads:
        guard.handle(bad)
    for rec in records:
        header = rec.header.decode("utf-8", "replace")
        parts = header.split(None, 1)
        name = parts[0] if parts else ""
        comment = parts[1] if len(parts) > 1 else ""
        yield fastx.FastxRecord(
            name, comment,
            rec.seq.decode("utf-8", "replace"),
            rec.qual.decode("utf-8", "replace") if rec.qual is not None else None,
        )


class IngestGuard:
    """Routes bad records per the ``on_bad_record`` policy.

    ``quarantine``: raw bytes of every bad region are appended to
    ``quarantine_path`` (a gzip member stream) and machine-readable reasons
    land in ``robustness_report.json`` via the recorder at
    :func:`finalize`. ``drop``: count + report only. The guard is created
    per library and per attempt-scope: :func:`reset` rewinds it so a
    transient-retry of the whole ingest pass cannot double-count or
    double-append.
    """

    MAX_DETAIL_EVENTS = 20  # per-record report entries; the rest summarize

    def __init__(self, policy: str, source: str = "",
                 quarantine_path: str | None = None):
        if policy not in ("quarantine", "drop"):
            raise ValueError(
                f"IngestGuard policy must be quarantine|drop, got {policy!r}"
            )
        self.policy = policy
        self.source = source
        self.quarantine_path = quarantine_path if policy == "quarantine" else None
        self._fh = None
        self._finalized = False
        # bad records arrive from the ingest prefetch worker
        # (pipeline/assign._prefetch) while reset() (the transient-retry
        # hook) runs on the main thread
        self._lock = lockcheck.make_lock()
        self.reset()

    def reset(self) -> None:
        """Rewind for a retry: drop counters and truncate the artifact."""
        with self._lock:
            self._close_locked()
            self.n_bad = 0
            self.by_reason: dict[str, int] = {}
            self.events: list[BadRecord] = []
            if self.quarantine_path and os.path.exists(self.quarantine_path):
                os.remove(self.quarantine_path)
            self._finalized = False

    def handle(self, bad: BadRecord) -> None:
        with self._lock:
            self.n_bad += 1
            self.by_reason[bad.reason] = self.by_reason.get(bad.reason, 0) + 1
            if len(self.events) < self.MAX_DETAIL_EVENTS:
                self.events.append(bad)
            if self.quarantine_path and bad.raw:
                if self._fh is None:
                    self._fh = gzip.open(self.quarantine_path, "wb")
                self._fh.write(bad.raw)

    def _close_locked(self) -> None:
        lockcheck.assert_held(self._lock, "IngestGuard._close_locked")
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def handle_native(self, parsed_bad: list[tuple[int, str, bytes]]) -> None:
        """Consume a native chunk's ``ParsedFastx.bad`` list."""
        for offset, reason, raw in parsed_bad:
            self.handle(BadRecord(offset, reason, raw, self.source))

    def finalize(self, recorder=None) -> dict:
        """Close the artifact, push report events, return the summary."""
        self.close()
        summary = {
            "source": self.source,
            "policy": self.policy,
            "n_bad": self.n_bad,
            "by_reason": dict(self.by_reason),
            # only name the artifact when it was actually written — a
            # zero-raw-bytes event set (e.g. a lone gzip-truncation at a
            # record boundary) creates no file to point an operator at
            "quarantine_path": (
                self.quarantine_path
                if self.quarantine_path and os.path.exists(self.quarantine_path)
                else None
            ),
        }
        if self._finalized or recorder is None or not self.n_bad:
            self._finalized = True
            return summary
        outcome = "quarantined" if self.policy == "quarantine" else "dropped"
        for bad in self.events:
            recorder.record(
                "ingest.quarantine", classification="data_fault",
                outcome=outcome,
                detail={"file": bad.path or self.source, "offset": bad.offset,
                        "reason": bad.reason, "bytes": len(bad.raw)},
            )
        recorder.record(
            "ingest.quarantine", classification="data_fault",
            outcome="summary", detail=summary,
        )
        self._finalized = True
        return summary


# ---------------------------------------------------------------------------
# --validate dry-run (config + input scan, no device work)


def scan_file(path: str | os.PathLike[str]) -> dict:
    """Record-count/size scan of one input file via the tolerant parser
    (native when it builds, the Python twin otherwise). The native path
    streams in O(chunk) host memory: a --validate dry-run over lane-scale
    fastqs never materializes a whole file."""
    p = os.fspath(path)
    out = {
        "path": p,
        "size_bytes": os.path.getsize(p),
        "records": 0,
        "bases": 0,
        "bad_records": 0,
        "bad_reasons": {},
    }
    from ont_tcrconsensus_tpu_torch.io import native

    bads: list[tuple[int, str]] = []
    if native.available():
        for chunk in native.parse_chunks(p, tolerant=True):
            out["records"] += int(chunk.num_records)
            out["bases"] += int(chunk.lengths.sum()) if chunk.num_records else 0
            bads.extend((o, r) for o, r, _ in chunk.bad)
    else:
        records, bad_list = parse_path_tolerant(p)
        out["records"] = len(records)
        out["bases"] = sum(len(r.seq) for r in records)
        bads = [(b.offset, b.reason) for b in bad_list]
    out["bad_records"] = len(bads)
    for _, reason in bads:
        out["bad_reasons"][reason] = out["bad_reasons"].get(reason, 0) + 1
    if bads:
        out["first_bad"] = {"offset": bads[0][0], "reason": bads[0][1]}
    return out


def scan_manifests(fastq_pass_dir: str) -> list[dict]:
    """Integrity scan of an EXISTING workdir's stage manifests (--validate).

    For every ``nano_tcr/<library>/stage_manifest.json``: classify the
    manifest (``v2`` / ``v1`` / ``torn``) and, for v2, verify every
    completed stage's recorded artifacts with FULL sha256 checking — the
    dry-run twin of ``verify_resume=full``, so an operator can audit a
    workdir for silent corruption before committing compute to a resume.
    Returns one dict per manifest: ``{library, path, status,
    stages: {stage: reason|None}}`` (reason None = verified clean).
    """
    import glob
    import json

    from ont_tcrconsensus_tpu_torch.io import layout

    out: list[dict] = []
    pattern = os.path.join(fastq_pass_dir, "nano_tcr", "*", "stage_manifest.json")
    for mpath in sorted(glob.glob(pattern)):
        lib_dir = os.path.dirname(mpath)
        library = os.path.basename(lib_dir)
        entry: dict = {"library": library, "path": mpath, "stages": {}}
        try:
            with open(mpath) as fh:
                raw = json.load(fh)
        except ValueError:
            entry["status"] = "torn"
            out.append(entry)
            continue
        except OSError as exc:
            entry["status"] = "unreadable"
            entry["error"] = str(exc)
            out.append(entry)
            continue
        if not isinstance(raw, dict):
            entry["status"] = "torn"
            out.append(entry)
            continue
        if "version" in raw and not isinstance(raw.get("stages"), dict):
            # valid JSON wearing a v2 header over a broken body: exactly
            # the torn state this scan exists to flag (resume would redo
            # the whole library) — never "v2, 0 stages, all clean"
            entry["status"] = "torn"
            out.append(entry)
            continue
        entry["status"] = "v2" if "version" in raw else "v1"
        lay = layout.LibraryLayout(library=library, library_dir=lib_dir)
        readable = lay.completed_stages()
        # raw keys read_manifest() dropped are damaged entries — the
        # operator should see them, not an undercount that looks clean
        # (a v1 manifest is flat {stage: time}, so its own keys diff the
        # same way as a v2 stages map)
        raw_stages = raw["stages"] if entry["status"] == "v2" else raw
        for stage in raw_stages:
            if stage not in readable:
                entry["stages"][str(stage)] = (
                    "malformed manifest entry (resume will redo it)"
                )
        for stage in readable:
            if entry["status"] == "v1":
                entry["stages"][stage] = "v1 entry — no checksums recorded"
                continue
            ok, why = lay.verify_stage(stage, "full")
            entry["stages"][stage] = None if ok else why
        out.append(entry)
    return out


def _find_fastqs(fastq_pass_dir: str) -> list[str]:
    # the same two-pattern discovery as pipeline/run.py (duplicated so the
    # dry-run never imports the torch-bearing pipeline modules)
    import glob

    found = sorted(glob.glob(os.path.join(fastq_pass_dir, "barcode*", "*fastq*")))
    if not found:
        found = sorted(glob.glob(os.path.join(fastq_pass_dir, "*.fastq*")))
    return found


def validate_inputs(config_path: str, out=None, as_json: bool = False) -> int:
    """``python -m ont_tcrconsensus_tpu_torch <config> --validate``: parse
    the config, scan every input file (record counts/sizes only, no device
    work), print a validation report, return 0 when clean / 1 on any
    problem. ``as_json`` swaps the human lines for one machine-readable
    body (problems + the graftcheck semantic report) with the same exit
    code.

    The text and the JSON body are the JAX package's but for the compile
    cache: the JAX package names its persistent XLA cache, the port its
    kernel build directory (``ops/_build.DEFAULT_BUILD_DIR``, the run's
    ``compile_cache_dir``, or ``"off"``, resolved as
    ``pipeline/run.enable_build_cache`` resolves it)."""
    import json as json_mod

    out = out if out is not None else sys.stdout
    problems: list[str] = []
    graftcheck_body: dict | None = None
    compile_cache: dict | None = None

    def p(*parts):
        if not as_json:
            print(*parts, file=out)

    def finish(rc: int) -> int:
        if as_json:
            print(json_mod.dumps({
                "config": config_path,
                "ok": rc == 0,
                "problems": problems,
                "compile_cache": compile_cache,
                "graftcheck": graftcheck_body,
            }, indent=2), file=out)
        return rc

    p(f"validate: config {config_path}")
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

    try:
        cfg = RunConfig.from_json(config_path)
    except (OSError, ValueError, TypeError) as exc:  # TypeError: missing keys
        problems.append(f"config failed to load/validate: {exc}")
        p(f"PROBLEM: {problems[0]}")
        p("validate: FAIL (1 problem)")
        return finish(1)

    # the kernel build directory (the rules of pipeline/run.py
    # enable_build_cache, without importing torch): "off" builds into a
    # fresh temporary directory, null means the package's build dir.
    # Surfaced so an operator can see where the kernels will be built, and
    # whether a warm build is there, before any device work.
    if cfg.compile_cache_dir == "off":
        compile_cache = {"enabled": False, "dir": None}
        p("validate: compile cache: disabled (compile_cache_dir=\"off\")")
    else:
        from ont_tcrconsensus_tpu_torch.ops import _build

        resolved = cfg.compile_cache_dir or _build.DEFAULT_BUILD_DIR
        compile_cache = {"enabled": True, "dir": resolved,
                         "exists": os.path.isdir(resolved)}
        p(f"validate: compile cache: {resolved}"
          f"{' (will be created)' if not compile_cache['exists'] else ''}")

    # executor knob: a graph-executor config must declare a graph that
    # passes the graph checks (cycles, undeclared/dangling edges, hbm
    # edges crossing a disk-resume boundary, ...): each named problem is
    # surfaced here, BEFORE a run wastes device time. graph/ loads no
    # torch, so this stays safe on a host whose card is wedged.
    if cfg.executor == "graph":
        from ont_tcrconsensus_tpu_torch.graph import pipeline as graph_pipeline
        from ont_tcrconsensus_tpu_torch.graph.ir import GraphValidationError

        try:
            spec = graph_pipeline.build_library_graph(cfg)
        except GraphValidationError as exc:
            problems.extend(f"stage graph: {prob}" for prob in exc.problems)
        else:
            p(f"validate: stage graph: {len(spec.schedule)} nodes, "
              f"{len(spec.edges)} edges, "
              f"{len(spec.side_sinks())} off-critical-path")
            # graftcheck: semantic analysis of the built graph (liveness /
            # donation / placement flow / sharding pairing, graph/check.py,
            # torch-free). Violations are validation problems; advisories
            # (the known host round-trips) are informational. Never-crash:
            # an analyzer bug must not block a run an operator could start.
            try:
                from ont_tcrconsensus_tpu_torch.graph import check as graph_check

                report = graph_check.analyze(
                    spec, graph_check.production_byte_model(cfg))
                graftcheck_body = report.to_dict()
                s = report.summary()
                p(f"validate: graftcheck: {s['verdict']} "
                  f"({s['violations']} violation(s), "
                  f"{s['advisories']} advisory(ies)); hbm high-water "
                  f"~{s['hbm_high_water_bytes_est']} bytes at "
                  f"{s['hbm_high_water_node']}")
                for f in report.advisories:
                    p(f"validate:   graftcheck advisory: {f.kind}: "
                      f"{f.message}")
                problems.extend(
                    f"graftcheck: {f.kind}: {f.message}"
                    for f in report.violations
                )
            except Exception as exc:
                p(f"validate: WARNING: graftcheck analysis failed: {exc!r}")

    from ont_tcrconsensus_tpu_torch.io import fastx

    try:
        reference = fastx.read_fasta_dict(cfg.reference_file)
        p(f"validate: reference {cfg.reference_file}: {len(reference)} regions")
        if not reference:
            problems.append(f"reference {cfg.reference_file} has no sequences")
    except (OSError, ValueError) as exc:
        problems.append(f"reference {cfg.reference_file} unreadable: {exc}")
    if cfg.trim_primers:
        try:
            n_primers = len(cfg.primer_sequences())
            p(f"validate: primers: {n_primers} sequences")
            if not n_primers:
                problems.append("primer trimming enabled but primer set is empty")
        except (OSError, ValueError) as exc:
            problems.append(f"primers fasta unreadable: {exc}")

    fastqs = _find_fastqs(cfg.fastq_pass_dir)
    if not fastqs:
        problems.append(f"no fastq files under {cfg.fastq_pass_dir}")
    total_records = 0
    for fq in fastqs:
        try:
            scan = scan_file(fq)
        except OSError as exc:
            problems.append(f"{fq}: unreadable: {exc}")
            continue
        total_records += scan["records"]
        line = (f"validate: {fq}: {scan['records']} records, "
                f"{scan['bases']} bases, {scan['size_bytes']} bytes")
        if scan["bad_records"]:
            line += f", {scan['bad_records']} BAD"
            first = scan["first_bad"]
            problems.append(
                f"{fq}: {scan['bad_records']} malformed record(s); first at "
                f"byte offset {first['offset']}: {first['reason']} "
                f"(reasons: {scan['bad_reasons']})"
            )
        p(line)
    if fastqs and not total_records:
        problems.append("input files contain zero parseable records")

    # existing-workdir integrity: stage manifests + completed-artifact
    # checksums (the --validate twin of verify_resume=full). A v1 manifest
    # is informational (legacy runs are not an error — resume under
    # fast/full will warn and re-run); torn manifests and checksum
    # mismatches are problems an operator should see BEFORE a resume.
    for m in scan_manifests(cfg.fastq_pass_dir):
        if m["status"] in ("torn", "unreadable"):
            p(f"validate: manifest {m['path']}: {m['status'].upper()}")
            problems.append(
                f"{m['path']}: {m['status']} stage manifest (resume will "
                "redo the library; a crash mid-write or disk fault)"
            )
            continue
        bad = {s: why for s, why in m["stages"].items() if why is not None}
        n_ok = len(m["stages"]) - len(bad)
        line = (f"validate: manifest {m['path']} ({m['status']}): "
                f"{len(m['stages'])} stage(s), {n_ok} verified")
        if m["status"] == "v1":
            p(line + " — v1 (no checksums; verified resume will re-run)")
            # legacy-ness is informational, but a DROPPED (malformed) v1
            # entry is the same damage a v2 audit flags — same verdict
            for stage, why in bad.items():
                if "malformed" in why:
                    problems.append(f"{m['path']}: stage {stage!r}: {why}")
            continue
        p(line)
        for stage, why in bad.items():
            if "no checksums recorded" in why:
                # a migrated manifest's v1-era entries (artifacts: null):
                # legacy, not damage — same informational verdict as a
                # pure-v1 manifest; verified resume will warn and re-run
                p(f"validate:   stage {stage!r}: v1-era entry (no "
                  "checksums; verified resume will re-run)")
                continue
            problems.append(
                f"{m['path']}: stage {stage!r} failed artifact "
                f"verification: {why}"
            )

    if problems:
        for prob in problems:
            p(f"PROBLEM: {prob}")
        p(f"validate: FAIL ({len(problems)} problem(s))")
        return finish(1)
    p(f"validate: OK ({len(fastqs)} input file(s), {total_records} records)")
    return finish(0)
