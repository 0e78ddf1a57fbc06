"""The port's native C++ FASTQ/FASTA parser (``io/native``) against the
port's Python parsers (``io/fastx`` strict, ``io/validate`` tolerant) and
against the JAX package's native parser where it builds: the cases of the
JAX package's ``tests/test_native.py``, the columnar batching it feeds
(``io/bucketing``), the build's hygiene (warning-clean, the override
variable, the build directory) and the visible fallback."""

import gzip
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io import bucketing, fastx, simulator  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import native as N  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import validate as TV  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import encode  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def native():
    """The port's parser, built once for the module (a skip names the
    compiler's text where g++ or zlib is missing)."""
    if not N.available():
        pytest.skip(f"the native parser does not build here: {N.build_error()}")
    return N


@pytest.fixture(scope="module")
def jnative():
    """The JAX package's native parser, or None where it does not build."""
    from ont_tcrconsensus_tpu.io import native as jn

    return jn if jn.available() else None


def _view(parsed) -> tuple:
    return (parsed.codes.tobytes(), None if parsed.quals is None else parsed.quals.tobytes(),
            parsed.lengths.tolist(), parsed.offsets.tolist(), parsed.names, parsed.bad)


def _compare(path, jnative=None):
    parsed = N.parse_file(path)
    py_records = list(fastx.read_fastx(path))
    assert parsed.num_records == len(py_records)
    for i, rec in enumerate(py_records):
        name, codes, quals = parsed.record(i)
        assert name == rec.header
        np.testing.assert_array_equal(codes, encode.encode_seq(rec.sequence))
        if rec.quality is not None:
            want = np.frombuffer(rec.quality.encode(), np.uint8) - 33
            np.testing.assert_array_equal(quals, want)
        else:
            assert quals is None
    if jnative is not None:
        for tolerant in (False, True):
            assert _view(N.parse_file(path, tolerant=tolerant)) == \
                _view(jnative.parse_file(path, tolerant=tolerant))


def test_fastq_gz_matches_python(tmp_path, jnative):
    path = tmp_path / "x.fastq.gz"
    fastx.write_fastq(path, [("r1 extra=1", "ACGTN", "IIIII"), ("r2", "GGTTAACC", "!!!!!!!!")])
    _compare(str(path), jnative)


def test_fasta_multiline_matches_python(tmp_path, jnative):
    path = tmp_path / "x.fasta"
    fastx.write_fasta(path, [("a desc", "ACGT" * 40), ("b", "TTTTA")], width=13)
    _compare(str(path), jnative)


def test_blank_lines_tolerated(tmp_path):
    path = tmp_path / "x.fastq"
    path.write_text("@r1\nACGT\n+\nIIII\n\n\n@r2\nGG\n+\nII\n")
    parsed = N.parse_file(str(path))
    assert parsed.num_records == 2
    assert parsed.names == ["r1", "r2"]


def test_malformed_raises_as_the_jax_parser_does(tmp_path, jnative):
    path = tmp_path / "bad.fastq"
    path.write_text("@r1\nACGT\n+\nII\n")  # qual length mismatch
    with pytest.raises(ValueError, match="qual length") as got:
        N.parse_file(str(path))
    with pytest.raises(ValueError, match="qual length"):
        list(N.parse_chunks(str(path)))
    if jnative is not None:
        with pytest.raises(ValueError) as want:
            jnative.parse_file(str(path))
        assert str(got.value) == str(want.value)


CLEAN_CASES = [
    ("header_comment", "x.fastq",
     b"@r1 runid=abc ch=1\nACGT\n+\nIIII\n@r2 c=2\nGG\n+comment\nII\n"),
    ("empty_seq_record", "x.fastq", b"@r1\n\n+\n\n@r2\nAC\n+\nII\n"),
    ("lowercase_and_n", "x.fastq", b"@r1\nacgtnN\n+\nIIIIII\n"),
    ("fasta_multiline", "x.fasta", b">a first desc\nACGT\nTTTT\nGG\n>b\nCCCC\n\n>c trailing\nAA"),
    ("crlf_fastq", "x.fastq", b"@r1\r\nACGT\r\n+\r\nIIII\r\n"),
    ("blank_separated", "x.fastq", b"@r1\nACGT\n+\nIIII\n\n\n@r2\nGG\n+\nII\n"),
]


@pytest.mark.parametrize("label,name,data", CLEAN_CASES, ids=[c[0] for c in CLEAN_CASES])
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_native_matches_python_on_clean_edge_cases(tmp_path, jnative, label, name, data, gz):
    """Clean inputs, .gz and plain: the strict parse equals the Python
    parser's and the JAX native parser's, and the tolerant parse equals the
    strict one (no bad region) and the Python tolerant twin's."""
    path = tmp_path / (name + (".gz" if gz else ""))
    path.write_bytes(gzip.compress(data) if gz else data)
    _compare(str(path), jnative)
    strict = N.parse_file(str(path))
    tol = N.parse_file(str(path), tolerant=True)
    assert tol.bad == []
    assert _view(tol) == _view(strict)
    py_recs, py_bads = TV.parse_path_tolerant(str(path))
    assert not py_bads
    assert [r.header.decode() for r in py_recs] == tol.names


def test_truncated_gzip_rejected_strict_kept_tolerant(tmp_path, jnative):
    payload = gzip.compress(b"".join(b"@r%d\nACGTACGT\n+\nIIIIIIII\n" % i for i in range(100)))
    path = tmp_path / "t.fastq.gz"
    path.write_bytes(payload[: len(payload) // 2])
    with pytest.raises(ValueError, match="gzip"):
        N.parse_file(str(path))
    tol = N.parse_file(str(path), tolerant=True)
    assert tol.num_records > 0
    assert any("gzip" in reason for _, reason, _ in tol.bad)
    py_recs, py_bads = TV.parse_path_tolerant(str(path))
    assert [(b.offset, b.reason, b.raw) for b in py_bads] == tol.bad
    assert len(py_recs) == tol.num_records
    if jnative is not None:
        assert _view(tol) == _view(jnative.parse_file(str(path), tolerant=True))


def test_a_spliced_lane_gives_the_python_twin_s_bad_regions(tmp_path, jnative):
    """The chaos drill's malformed blocks spliced into a gzip lane: the
    tolerant parse, whole and in chunks, names the Python twin's offsets
    (decompressed), reasons and bytes, and keeps its records."""
    from ont_tcrconsensus_tpu_torch.robustness import faults

    rng = np.random.default_rng(3)
    # ~130 KB decompressed: the stream reads 64 KB blocks, so chunks split
    seqs = rng.choice(list(b"ACGT"), (600, 90)).astype(np.uint8)
    recs = [b"@r%d m=%d\n%s\n+\n%s\n" % (i, i, seq.tobytes(), b"I" * 90)
            for i, seq in enumerate(seqs)]
    for k, block in enumerate(faults._CORRUPT_BLOCKS):
        recs.insert(7 + 150 * k, block)
    path = tmp_path / "spliced.fastq.gz"
    path.write_bytes(gzip.compress(b"".join(recs)))
    py_recs, py_bads = TV.parse_path_tolerant(str(path))
    want_bad = [(b.offset, b.reason, b.raw) for b in py_bads]
    whole = N.parse_file(str(path), tolerant=True)
    assert whole.bad == want_bad and len(want_bad) == len(faults._CORRUPT_BLOCKS)
    assert whole.names == [r.header.decode() for r in py_recs]
    chunks = list(N.parse_chunks(str(path), chunk_bases=256, tolerant=True))
    assert len(chunks) >= 2 and all(c.bad for c in chunks)
    assert [b for c in chunks for b in c.bad] == want_bad
    assert [n for c in chunks for n in c.names] == whole.names
    if jnative is not None:
        assert _view(whole) == _view(jnative.parse_file(str(path), tolerant=True))


def test_the_lane_parses_as_the_python_parser_reads_it(tmp_path, jnative):
    lib = simulator.simulate_library(seed=3, num_regions=4)
    path = tmp_path / "big.fastq.gz"
    fastx.write_fastq(path, lib.reads)
    parsed = N.parse_file(str(path))
    assert parsed.num_records == len(lib.reads) == sum(1 for _ in fastx.read_fastx(path))
    _compare(str(path), jnative)


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.width == w.width and g.ids == w.ids
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.quals, w.quals)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        np.testing.assert_array_equal(g.valid, w.valid)


def test_batch_parsed_matches_batch_reads(tmp_path):
    lib = simulator.simulate_library(seed=3, num_regions=2, molecules_per_region=(2, 3),
                                     reads_per_molecule=(3, 5), region_len=(300, 900))
    path = tmp_path / "reads.fastq.gz"
    fastx.write_fastq(path, lib.reads)
    widths = (512, 1024, 2048)
    want = list(bucketing.batch_reads(fastx.read_fastx(path), batch_size=8, widths=widths))
    _assert_same_batches(list(bucketing.batch_parsed_reads(N.parse_file(path), batch_size=8,
                                                           widths=widths)), want)
    # the length gates: a median minimum, the widest bucket left out
    min_len = int(np.median([len(r[1]) for r in lib.reads]))
    counters, wcounters = bucketing.IngestCounters(), bucketing.IngestCounters()
    got = list(bucketing.batch_parsed_chunks(N.parse_chunks(path, chunk_bases=4096),
                                             batch_size=8, widths=widths[:2], min_len=min_len,
                                             counters=counters))
    want = list(bucketing.batch_reads(fastx.read_fastx(path), batch_size=8, widths=widths[:2],
                                      min_len=min_len, counters=wcounters))
    _assert_same_batches(got, want)
    assert counters == wcounters and counters.n_dropped_short > 0


def _write_big_fastq(path, n=3000, seed=5):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        ln = int(rng.integers(40, 400))
        seq = "".join(rng.choice(list("ACGT"), size=ln))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 40, size=ln))
        reads.append((f"r{i} mol={i}", seq, qual))
    fastx.write_fastq(path, reads)


@pytest.mark.parametrize("chunk_bases", [16_384, 4096])
def test_parse_chunks_concat_equals_parse_file(tmp_path, jnative, chunk_bases):
    path = str(tmp_path / "big.fastq.gz")
    _write_big_fastq(path, n=1500)
    whole = N.parse_file(path)
    chunks = list(N.parse_chunks(path, chunk_bases=chunk_bases))
    assert len(chunks) > 5, "chunking did not actually chunk"
    assert sum(c.num_records for c in chunks) == whole.num_records
    for key in ("codes", "quals", "lengths"):
        np.testing.assert_array_equal(np.concatenate([getattr(c, key) for c in chunks]),
                                      getattr(whole, key))
    assert [n for c in chunks for n in c.names] == whole.names
    if jnative is not None:
        jchunks = list(jnative.parse_chunks(path, chunk_bases=chunk_bases))
        assert [_view(c) for c in chunks] == [_view(c) for c in jchunks]
    # FASTA: multi-line records split across chunk boundaries and the
    # stream's 64 KB blocks
    fpath = str(tmp_path / "big.fasta")
    fastx.write_fasta(fpath, [(f"s{i}", "ACGTTGCA" * (10 + i % 37)) for i in range(1500)],
                      width=60)
    whole = N.parse_file(fpath)
    chunks = list(N.parse_chunks(fpath, chunk_bases=chunk_bases))
    assert len(chunks) > 3
    np.testing.assert_array_equal(np.concatenate([c.codes for c in chunks]), whole.codes)
    assert [n for c in chunks for n in c.names] == whole.names


def test_batch_parsed_chunks_matches_whole_file(tmp_path):
    path = str(tmp_path / "big2.fastq.gz")
    _write_big_fastq(path, n=1200, seed=9)
    want = list(bucketing.batch_parsed_reads(N.parse_file(path), batch_size=256,
                                             widths=(128, 512), min_len=50))
    got = list(bucketing.batch_parsed_chunks(N.parse_chunks(path, chunk_bases=16_384),
                                             batch_size=256, widths=(128, 512), min_len=50))
    _assert_same_batches(got, want)
    records = list(bucketing.batch_reads(fastx.read_fastx(path), batch_size=256,
                                         widths=(128, 512), min_len=50))
    _assert_same_batches(got, records)


def test_batch_parsed_chunks_subsample(tmp_path):
    path = str(tmp_path / "big3.fastq.gz")
    _write_big_fastq(path, n=500, seed=13)
    counters = bucketing.IngestCounters()
    got = list(bucketing.batch_parsed_chunks(N.parse_chunks(path, chunk_bases=8192),
                                             batch_size=64, widths=(512,), min_len=1,
                                             subsample=100, counters=counters))
    assert sum(int(b.valid.sum()) for b in got) == 100 == counters.n_records
    recs = list(fastx.read_fastx(path))[:100]
    _assert_same_batches(got, list(bucketing.batch_reads(iter(recs), batch_size=64,
                                                         widths=(512,))))


def test_parse_chunks_blank_lines_and_crlf(tmp_path):
    path = str(tmp_path / "w.fastq")
    (tmp_path / "w.fastq").write_text("".join(
        f"@r{i}\r\nACGTACGT\r\n+\r\nIIIIIIII\r\n\r\n" for i in range(200)))
    whole = N.parse_file(path)
    assert whole.num_records == 200
    chunks = list(N.parse_chunks(path, chunk_bases=512))
    assert sum(c.num_records for c in chunks) == 200
    np.testing.assert_array_equal(np.concatenate([c.codes for c in chunks]), whole.codes)


def test_scan_file_streams_natively_with_the_python_twin_s_numbers(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    data = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, rng.choice(list(b"ACGT"), 50).astype(np.uint8).tobytes(), b"I" * 50)
                    for i in range(40))
    path = tmp_path / "s.fastq.gz"
    path.write_bytes(gzip.compress(data[:1000] + b"JUNK LINE\n" + data[1000:]))
    got = TV.scan_file(path)
    monkeypatch.setattr(N, "available", lambda: False)
    assert TV.scan_file(path) == got
    assert got["bad_records"] == 1 and got["records"] == 39


# --- the build -------------------------------------------------------------


def test_native_build_is_warning_clean(tmp_path):
    ok, out = N.build_library(str(tmp_path / "libfastx_check.so"))
    assert ok, out
    assert "warning" not in out.lower(), out
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_concurrent_builds_land_one_library(tmp_path):
    """Several builds of one path at once (xdist workers, processes of
    one host): each compiles to its own temporary name, the last
    ``os.replace`` wins, and the library loads."""
    out = str(tmp_path / "libfastx-race.so")
    results = []
    threads = [threading.Thread(target=lambda: results.append(N.build_library(out)))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [ok for ok, _ in results] == [True] * 3
    assert os.listdir(tmp_path) == ["libfastx-race.so"]
    import ctypes

    ctypes.CDLL(out).fastx_parse2  # noqa: B018


def test_the_library_lands_under_build_torch_native_named_by_its_hash():
    path = N._lib_path
    assert path == N.library_path() and os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "torch_native")
    assert os.path.basename(path).startswith("libfastx-")
    assert N.library_path("address,undefined") != path
    assert not [f for f in os.listdir(os.path.dirname(N._SRC)) if f.endswith(".so")]


_MAPS_PROBE = r"""
import json, sys
from ont_tcrconsensus_tpu_torch.io import native
parsed = native.parse_file(sys.argv[1])
maps = open("/proc/self/maps").read()
libs = sorted({ln.split()[-1] for ln in maps.splitlines() if "libfastx" in ln})
print(json.dumps({"n": parsed.num_records, "libs": libs,
                  "jax": sorted(m for m in sys.modules if m.startswith("ont_tcrconsensus_tpu.")
                                or m == "ont_tcrconsensus_tpu")}))
"""


def test_only_the_port_s_library_is_mapped(tmp_path):
    import json

    path = tmp_path / "x.fastq"
    path.write_text("@r1\nACGT\n+\nIIII\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _MAPS_PROBE, str(path)], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] == 1 and got["jax"] == []
    assert got["libs"] == [N.library_path()]


def test_lib_override_env_is_authoritative(tmp_path, monkeypatch):
    assert N.load() is not None  # the default build, cached in-process
    monkeypatch.setenv(N.LIB_OVERRIDE_ENV, str(tmp_path / "missing.so"))
    with pytest.raises(OSError):
        N.load()
    monkeypatch.delenv(N.LIB_OVERRIDE_ENV)
    assert N.load() is not None  # the cached default is still served


def test_the_override_variables_are_the_port_s_own():
    from ont_tcrconsensus_tpu.io import native as jn

    assert {N.LIB_OVERRIDE_ENV, N.SANITIZE_ENV}.isdisjoint({jn.LIB_OVERRIDE_ENV,
                                                            jn.SANITIZE_ENV})


def test_a_failed_build_falls_back_visibly(tmp_path, monkeypatch, capsys):
    """Without a compiler the loader returns None, ``build_error()`` holds
    the reason and stderr says the Python parser is in use; the ingest then
    batches through the Python parser, as the JAX package falls back."""
    for name, value in (("_lib", None), ("_lib_path", None), ("_build_failed", False),
                        ("_build_error", None), ("BUILD_DIR", str(tmp_path))):
        monkeypatch.setattr(N, name, value)
    monkeypatch.setattr(N, "build_command",
                        lambda src, out, sanitize=None: ["no-such-compiler-here", src])
    assert N.load() is None and not N.available()
    assert "no-such-compiler-here" in N.build_error()
    assert "using the Python parser" in capsys.readouterr().err
    from ont_tcrconsensus_tpu_torch.pipeline import assign

    path = tmp_path / "r.fastq"
    fastx.write_fastq(path, [("r1", "ACGT" * 70, "I" * 280)])
    batches = list(assign._batches_from_source(str(path), 8, (512,), None))
    assert [b.ids[:1] for b in batches] == [["r1"]]


def test_the_streaming_proof_gives_both_modes_the_same_batches(tmp_path):
    """``scripts/torch_streaming_ingest_proof.py`` at a small size: the
    streamed and whole-file ingests, each in a process of its own, give
    the same batches, reads and bases."""
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_streaming_ingest_proof.py"),
         "--reads", "1500", "--root", str(tmp_path), "--out", str(tmp_path / "proof.md")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    keys = ("n_batches", "n_reads", "total_bases")
    assert [got["streamed"][k] for k in keys] == [got["wholefile"][k] for k in keys]
    assert got["streamed"]["n_reads"] == 1500
    assert "| streamed |" in (tmp_path / "proof.md").read_text()
    assert os.listdir(tmp_path) == ["proof.md"]  # the generated lane is removed
