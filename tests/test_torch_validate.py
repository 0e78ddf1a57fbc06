"""The port's tolerant parser and ingest guard (``io/validate.py``) against
the JAX package's: its Python twin, and its native parser's tolerant mode
where that builds. Inputs are made with numpy from a seed: clean FASTQ
records with every chaos block spliced at seeded slots, a three-record
file cut at every byte offset (plain and gzip), and one file for each kind
of damage. Records, bad regions (offset, reason, raw bytes), the guard's
summary, report events and quarantine artifact, and the batches that
``run_assign(..., guard=)`` builds must all be the JAX package's."""

import gzip
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.io import bucketing as jbucketing  # noqa: E402
from ont_tcrconsensus_tpu.io import validate as JV  # noqa: E402
from ont_tcrconsensus_tpu.pipeline import assign as jassign  # noqa: E402
from ont_tcrconsensus_tpu.robustness import faults as jfaults  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import validate as TV  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import encode  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import assign as tassign  # noqa: E402
from ont_tcrconsensus_tpu_torch.robustness import faults as tfaults  # noqa: E402


def _fastq(rng, n: int, min_len: int = 1, max_len: int = 80) -> bytes:
    """``n`` well-formed FASTQ records: headers with and without a comment,
    bases from ACGTN in both cases, qualities from '!' to 'J'."""
    out = []
    for i in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        seq = bytes(rng.choice(list(b"ACGTNacgt"), size=length).astype(np.uint8))
        qual = bytes(rng.integers(33, 75, size=length).astype(np.uint8))
        header = b"r%d" % i + (b" comment=%d" % i if rng.random() < 0.5 else b"")
        out.append(b"@" + header + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return b"".join(out)


def _splice(data: bytes, blocks: list[bytes], rng) -> bytes:
    """``blocks`` spliced between records at seeded slots (distinct slots,
    0 = before the first record, n = after the last)."""
    lines = data.splitlines(keepends=True)
    n_rec = len(lines) // 4
    slots = sorted(rng.choice(n_rec + 1, size=len(blocks), replace=False).tolist())
    parts, prev = [], 0
    for slot, block in zip(slots, blocks):
        parts += [b"".join(lines[prev * 4:slot * 4]), block]
        prev = slot
    parts.append(b"".join(lines[prev * 4:]))
    return b"".join(parts)


def _cases() -> dict[str, tuple[bytes, str]]:
    """name -> (file bytes, file suffix)."""
    rng = np.random.default_rng(7)
    cases = {}
    for k, block in enumerate(tfaults._CORRUPT_BLOCKS):
        # the block three times, at seeded slots
        cases[f"splice-block{k}"] = (_splice(_fastq(rng, 12), [block] * 3, rng), ".fastq")
    # all four blocks in one file, and gzip-compressed
    mixed = _splice(_fastq(rng, 20), list(tfaults._CORRUPT_BLOCKS), rng)
    cases["splice-all-gzip"] = (gzip.compress(mixed), ".fastq.gz")
    cases["missing-plus"] = (b"@r1\nACGT\n@r2\nGGCC\n+\nIIII\n" + _fastq(rng, 3), ".fastq")
    cases["length-mismatch"] = (_fastq(rng, 2) + b"@bad\nACG\n+\nIIII\n" + _fastq(rng, 2),
                                ".fastq")
    cases["sub-phred"] = (_fastq(rng, 2) + b"@low\nACGT\n+\nII\x1fI\n" + _fastq(rng, 2),
                          ".fastq")
    full = gzip.compress(_fastq(rng, 60, 20, 60))
    cases["gzip-cut-mid-member"] = (full[: len(full) // 2], ".fastq.gz")
    two = gzip.compress(_fastq(rng, 5)) + gzip.compress(_fastq(rng, 5))
    cases["gzip-two-members"] = (two, ".fastq.gz")
    cases["crlf"] = (_fastq(rng, 6).replace(b"\n", b"\r\n"), ".fastq")
    cases["fasta"] = (b">a desc\nACGT\nacgn\n\n>b\n>c\nTTTT\n", ".fasta")
    cases["junk-prefix"] = (b"not a record\nstill not\n" + _fastq(rng, 3), ".fastq")
    cases["truncated-final-record"] = (_fastq(rng, 3) + b"@r9\nACGT\n+", ".fastq")
    cases["blank-lines"] = (b"\n" + _fastq(rng, 2).replace(b"\n@", b"\n\n@"), ".fastq")
    cases["clean"] = (_fastq(rng, 10), ".fastq")
    return cases


CASES = _cases()


def _write(tmp_path, name: str) -> str:
    data, suffix = CASES[name]
    path = tmp_path / f"{name}{suffix}"
    path.write_bytes(data)
    return str(path)


def _view(records, bads):
    return ([(r.header, r.seq, r.qual, r.offset) for r in records],
            [(b.offset, b.reason, b.raw, b.path) for b in bads])


class _Recorder:
    """A robustness recorder that keeps what it is given."""

    def __init__(self):
        self.events = []

    def record(self, site, **kw):
        self.events.append((site, kw))


def _yielded(module, path, guard):
    return [(r.name, r.comment, r.sequence, r.quality)
            for r in module.iter_records_tolerant(path, guard)]


def test_the_chaos_blocks_are_the_jax_package_s():
    assert tfaults._CORRUPT_BLOCKS == jfaults._CORRUPT_BLOCKS


def test_reasons_and_policies_are_the_jax_package_s():
    for name in ("R_GZIP", "R_NOT_FASTX", "R_BAD_HEADER", "R_MISSING_PLUS",
                 "R_LEN_MISMATCH", "R_BAD_QUAL", "R_TRUNCATED", "POLICIES"):
        assert getattr(TV, name) == getattr(JV, name), name
    assert TV.IngestGuard.MAX_DETAIL_EVENTS == JV.IngestGuard.MAX_DETAIL_EVENTS == 20


def test_code_lut_equals_the_port_encode_table():
    np.testing.assert_array_equal(TV.CODE_LUT, encode._CODE_LUT)
    np.testing.assert_array_equal(TV.CODE_LUT, JV.CODE_LUT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_equals_the_jax_python_twin(tmp_path, name):
    path = _write(tmp_path, name)
    got = _view(*TV.parse_path_tolerant(path))
    assert got == _view(*JV.parse_path_tolerant(path))
    data, gz_error = TV.read_bytes_tolerant(path)
    assert (data, gz_error) == JV.read_bytes_tolerant(path)
    assert _view(*TV.parse_bytes_tolerant(data, path)) == _view(
        *JV.parse_bytes_tolerant(data, path))
    if name.startswith("splice"):
        assert len(got[1]) >= 3  # every spliced block is found
    if name == "clean":
        assert got[1] == [] and len(got[0]) == 10
    # the guard's stream: the same records, the same bad regions routed
    guards = [m.IngestGuard("drop", source=path) for m in (TV, JV)]
    assert _yielded(TV, path, guards[0]) == _yielded(JV, path, guards[1])
    assert [_view([], g.events)[1] for g in guards] == [got[1]] * 2


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The JAX package's native parser, or a skip with its build's message."""
    from ont_tcrconsensus_tpu.io import native as jnative

    if not jnative.available():
        out = str(tmp_path_factory.mktemp("native") / "libfastx_probe.so")
        _, msg = jnative.build_library(out)
        pytest.skip(f"the JAX package's native parser does not build here: {msg[-400:]}")
    return jnative


def _native_view(parsed_list):
    """Records as (header, codes, quals) and bad regions as (offset,
    reason, raw), over a list of native chunks."""
    recs, bads = [], []
    for parsed in parsed_list:
        for i in range(parsed.num_records):
            name, codes, quals = parsed.record(i)
            recs.append((name, codes.tobytes(), None if quals is None else quals.tobytes()))
        bads += parsed.bad
    return recs, bads


def _port_as_native(path):
    records, bads = TV.parse_path_tolerant(path)
    recs = [(r.header.decode("utf-8", "replace"),
             TV.CODE_LUT[np.frombuffer(r.seq, np.uint8)].tobytes(),
             None if r.qual is None else (np.frombuffer(r.qual, np.uint8) - 33)
             .astype(np.uint8).tobytes())
            for r in records]
    return recs, [(b.offset, b.reason, b.raw) for b in bads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_equals_the_jax_native_parser(tmp_path, native, name):
    path = _write(tmp_path, name)
    want = _port_as_native(path)
    assert _native_view([native.parse_file(path, tolerant=True)]) == want
    # streamed in small chunks: the carry across chunk boundaries
    assert _native_view(list(native.parse_chunks(path, chunk_bases=16, tolerant=True))) == want


THREE = b"@r1 a\nACGT\n+\nIIII\n@r2\nGGCCA\n+\n!!!!#\n@r3 b c\nTTN\n+\nJJJ\n"


@pytest.mark.parametrize("parser", ["python", "native"])
@pytest.mark.parametrize("form", ["plain", "gzip"])
def test_a_file_cut_at_every_byte_offset_parses_as_in_jax(tmp_path, request, form, parser):
    """Plain: the text cut at every offset. Gzip: the compressed stream
    cut at every offset (mid-header, mid-deflate, before the trailer)."""
    native = request.getfixturevalue("native") if parser == "native" else None
    data = THREE if form == "plain" else gzip.compress(THREE, mtime=0)
    path = str(tmp_path / ("cut.fastq" if form == "plain" else "cut.fastq.gz"))
    reasons = set()
    for cut in range(len(data) + 1):
        with open(path, "wb") as fh:
            fh.write(data[:cut])
        if native is None:
            got = _view(*TV.parse_path_tolerant(path))
            assert got == _view(*JV.parse_path_tolerant(path)), cut
            reasons.update(b[1] for b in got[1])
        else:
            assert _native_view([native.parse_file(path, tolerant=True)]) == \
                _port_as_native(path), cut
    if native is None:
        assert (TV.R_GZIP if form == "gzip" else TV.R_TRUNCATED) in reasons


def _guard_run(module, policy, path, qpath, recorder):
    guard = module.IngestGuard(policy, source=path, quarantine_path=qpath)
    records = _yielded(module, path, guard)
    return guard, records, guard.finalize(recorder)


@pytest.mark.parametrize("policy", ["quarantine", "drop"])
def test_the_guard_equals_jax(tmp_path, policy):
    """Summary, report events and the decompressed artifact; more bad
    regions than MAX_DETAIL_EVENTS, so the detail events are capped."""
    rng = np.random.default_rng(3)
    blocks = [tfaults._CORRUPT_BLOCKS[k % 4] for k in range(24)]
    path = str(tmp_path / "lib.fastq")
    with open(path, "wb") as fh:
        fh.write(_splice(_fastq(rng, 40), blocks, rng))
    out = {}
    for side, module in (("port", TV), ("jax", JV)):
        rec = _Recorder()
        qpath = str(tmp_path / f"{side}_quarantine.fastq.gz")
        guard, records, summary = _guard_run(module, policy, path, qpath, rec)
        artifact = gzip.open(qpath, "rb").read() if os.path.exists(qpath) else None
        # each side writes its own artifact: its path is the one difference
        summary = dict(summary, quarantine_path=summary["quarantine_path"] and "Q")
        events = [(site, {**kw, "detail": summary}) if kw["outcome"] == "summary"
                  else (site, kw) for site, kw in rec.events]
        out[side] = (records, summary, events, artifact, guard.n_bad)
        # finalize is idempotent: no event twice
        guard.finalize(rec)
        assert len(rec.events) == len(out[side][2])
    assert out["port"] == out["jax"]
    records, summary, events, artifact, n_bad = out["port"]
    assert n_bad == summary["n_bad"] >= 24 and len(records) == 40
    outcome = "quarantined" if policy == "quarantine" else "dropped"
    assert [e[1]["outcome"] for e in events] == [outcome] * 20 + ["summary"]
    assert {e[0] for e in events} == {"ingest.quarantine"}
    if policy == "quarantine":  # every spliced block, in file order, and nothing else
        assert artifact == b"".join(blocks)
    else:
        assert artifact is None and summary["quarantine_path"] is None


def test_reset_truncates_and_zeroes_as_in_jax(tmp_path):
    bad = [("lib.fastq", 0, TV.R_LEN_MISMATCH, b"@bad\nACG\n+\nIIII\n"),
           ("lib.fastq", 40, TV.R_BAD_HEADER, b"junk\n")]
    out = {}
    for side, module in (("port", TV), ("jax", JV)):
        qpath = str(tmp_path / f"{side}_q.fastq.gz")
        guard = module.IngestGuard("quarantine", source="lib.fastq", quarantine_path=qpath)
        for path, off, reason, raw in bad:
            guard.handle(module.BadRecord(off, reason, raw, path))
        guard.close()
        assert os.path.exists(qpath)
        guard.reset()
        state = (guard.n_bad, dict(guard.by_reason), len(guard.events), os.path.exists(qpath))
        guard.handle(module.BadRecord(0, bad[0][2], bad[0][3], "lib.fastq"))
        rec = _Recorder()
        summary = guard.finalize(rec)
        out[side] = (state[:2], state[2], state[3], summary["n_bad"],
                     summary["by_reason"], [kw["outcome"] for _, kw in rec.events],
                     gzip.open(qpath, "rb").read())
    assert out["port"] == out["jax"]
    assert out["port"][:3] == ((0, {}), 0, False)
    assert out["port"][-1] == bad[0][3]


def test_a_bad_region_without_bytes_names_no_artifact_as_in_jax(tmp_path):
    """A gzip cut at a record boundary: one event with no raw bytes, so no
    quarantine file exists to point an operator at."""
    data = gzip.compress(THREE, mtime=0)
    path = str(tmp_path / "cut.fastq.gz")
    with open(path, "wb") as fh:
        fh.write(data[:-8])  # the trailer gone, every record intact
    out = {}
    for side, module in (("port", TV), ("jax", JV)):
        qpath = str(tmp_path / f"{side}_q.fastq.gz")
        guard, records, summary = _guard_run(module, "quarantine", path, qpath, _Recorder())
        out[side] = (records, summary["n_bad"], summary["by_reason"],
                     summary["quarantine_path"], os.path.exists(qpath))
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (1, {TV.R_GZIP: 1}, None, False)


def test_the_guard_refuses_the_fail_policy():
    with pytest.raises(ValueError, match="quarantine|drop"):
        TV.IngestGuard("fail")


# --- run_assign(..., guard=) builds JAX's batches ----------------------------


class _Panel:
    lens = np.array([100], np.int32)
    names = ["regionA"]


class _Engine:
    panel = _Panel()


def _no_read_passes(batch, max_ee_rate, min_len):
    """A device pass in which every read fails the EE filter: the store
    stays empty and the filter partition holds."""
    b = batch.codes.shape[0]
    zeros = np.zeros(b, np.int32)
    return {"lens": batch.lengths.astype(np.int32), "ee_ok": np.zeros(b, bool),
            "t_start": zeros, "score": zeros, "ridx": zeros, "ref_start": zeros,
            "ref_end": zeros, "blast_id": np.zeros(b, np.float32),
            "is_rev": np.zeros(b, bool), "sw_done": np.zeros(b, bool),
            **{k: zeros for k in tassign._UMI_KEYS}}


def _port_batches(monkeypatch, path, guard, batch_size, subsample):
    seen = []

    def recording(real):
        def wrapped(*args, **kwargs):
            for batch in real(*args, **kwargs):
                seen.append(batch)
                yield batch
        return wrapped

    # the native parser's columnar path where it builds, else the records'
    for name in ("batch_reads", "batch_parsed_chunks"):
        monkeypatch.setattr(tassign.bucketing, name,
                            recording(getattr(tassign.bucketing, name)))
    store, stats = tassign.run_assign(
        path, _Engine(), max_ee_rate=0.1, min_len=1, minimal_region_overlap=0.9,
        max_softclip_5_end=0, max_softclip_3_end=0, batch_size=batch_size,
        subsample=subsample, dispatch=_no_read_passes, guard=guard)
    assert store.num_reads == 0 and stats.n_ee_fail == stats.n_total
    return seen, stats


def _batch_view(batches):
    return [(b.width, b.ids, b.codes.tobytes(), None if b.quals is None else b.quals.tobytes(),
             b.lengths.tolist(), b.valid.tolist()) for b in batches]


@pytest.mark.parametrize("policy,subsample", [("quarantine", None), ("drop", None),
                                              ("quarantine", 17)])
def test_run_assign_with_a_guard_batches_as_jax(tmp_path, monkeypatch, policy, subsample):
    """Reads of 100-700 nt (three width buckets) with every chaos block
    spliced in: the port's batches equal the JAX package's default ingest
    (its native parser where it builds) batch for batch."""
    rng = np.random.default_rng(11)
    data = _splice(_fastq(rng, 45, 100, 700), list(tfaults._CORRUPT_BLOCKS), rng)
    path = str(tmp_path / "lib.fastq.gz")
    with open(path, "wb") as fh:
        fh.write(gzip.compress(data))
    widths = tuple(w for w in jbucketing.DEFAULT_WIDTHS if w <= 4096)
    guards = {side: m.IngestGuard(policy, source=path,
                                  quarantine_path=str(tmp_path / f"{side}_q.gz"))
              for side, m in (("port", TV), ("jax", JV))}
    port, stats = _port_batches(monkeypatch, path, guards["port"], 8, subsample)
    counters = jbucketing.IngestCounters()
    jax = list(jassign._batches_from_source(path, batch_size=8, widths=widths,
                                            subsample=subsample, counters=counters,
                                            guard=guards["jax"]))
    assert _batch_view(port) == _batch_view(jax)
    assert len({b.width for b in port}) == 3
    assert stats.n_ingested == counters.n_records == (subsample or 45)
    summaries = [dict(g.finalize(), quarantine_path=None) for g in guards.values()]
    assert summaries[0] == summaries[1] and summaries[0]["n_bad"] == 4


def test_run_assign_without_a_guard_still_raises(tmp_path):
    path = tmp_path / "lib.fastq"
    path.write_bytes(b"@r1\nACGT\n+\nII\n")
    with pytest.raises(ValueError):
        tassign.run_assign(str(path), _Engine(), max_ee_rate=0.1, min_len=1,
                           minimal_region_overlap=0.9, max_softclip_5_end=0,
                           max_softclip_3_end=0, dispatch=_no_read_passes)
