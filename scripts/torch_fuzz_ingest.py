#!/usr/bin/env python
"""Differential ingest fuzzing of the PyTorch port: native C++ parser vs
pure-Python twin.

The port's native fastx parser (``ont_tcrconsensus_tpu_torch/io/native``)
is ctypes into C++: a segfault there kills the whole process, and it sits
directly on the ingest path (``pipeline/assign.py``). This harness
drives seeded byte-level corpus mutations through BOTH parsers and asserts
they agree record-for-record AND rejection-for-rejection: no crash, no
hang, no divergence.

Per mutated corpus, four properties are checked:

1. native tolerant whole-file == Python tolerant: record count, raw
   headers, dense codes, phreds, and the (offset, reason, raw) bad list;
2. native tolerant CHUNKED (small chunk_bases, forcing many carry/resync
   boundaries) == native tolerant whole-file;
3. strict cross-check: the strict native parse raises ValueError IFF the
   tolerant parse found at least one bad region;
4. the strict native parse never crashes (any segfault kills the run).

Mutation operators: truncation, CRLF conversion, qual/seq length
mismatch, sub-Phred33 bytes, non-ACGTN bases, mid-stream gzip truncation,
empty files, pathological record sizes, junk splices, blank-line noise.

Usage:
    python scripts/torch_fuzz_ingest.py [--seeds 5] [--cases 200] [--start-seed 0]
    python scripts/torch_fuzz_ingest.py --sanitized [...]

``--sanitized`` replays the same differential corpus through an
ASan/UBSan-instrumented build of the C++ parser: it compiles the library
with ``-fsanitize=address,undefined`` (into ``build/torch_native/``), then
re-runs itself under ``LD_PRELOAD=libasan.so`` with
``TCR_TORCH_FASTX_LIB`` pointing the loader at the instrumented library.
An out-of-bounds read that happens not to change the parse output dies
there on the first touch, with a stack. Any sanitizer report aborts the
process (``abort_on_error=1`` / ``halt_on_error=1``) and fails the run.

Exit status 1 on any divergence. Deterministic per (seed, case index).
Tier-1 runs a 5-seed smoke and a sanitized smoke
(``tests/test_torch_fuzz_ingest.py``); the >=1000-corpus campaigns (plain
and sanitized) are the slow-marked tests and manual runs of this script.
"""

from __future__ import annotations

import argparse
import gzip
import os
import random
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ont_tcrconsensus_tpu_torch.io import native  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import validate as validate_mod  # noqa: E402


# ---------------------------------------------------------------------------
# corpus generation


def gen_clean_corpus(rng: random.Random) -> tuple[bytes, bool]:
    """A clean FASTA/FASTQ corpus; returns (text bytes, prefer_gzip)."""
    kind = rng.random()
    lines: list[bytes] = []
    if kind < 0.15:  # FASTA
        for i in range(rng.randrange(1, 30)):
            lines.append(b">rec%d some description %d\n" % (i, i))
            seq = bytes(rng.choice(b"ACGT") for _ in range(rng.randrange(0, 120)))
            width = rng.randrange(10, 61)
            for j in range(0, max(len(seq), 1), width):
                lines.append(seq[j:j + width] + b"\n")
    else:  # FASTQ
        n = rng.randrange(0, 40)
        for i in range(n):
            if rng.random() < 0.02:  # pathological record size
                ln = rng.randrange(50_000, 200_000)
            else:
                ln = rng.randrange(0, 300)
            seq = bytes(rng.choice(b"ACGTN") for _ in range(ln))
            qual = bytes(rng.randrange(33, 94) for _ in range(ln))
            lines.append(b"@read%d meta=%d\n" % (i, i))
            lines.append(seq + b"\n+\n" + qual + b"\n")
            if rng.random() < 0.1:
                lines.append(b"\n")  # blank separator noise (tolerated)
    return b"".join(lines), rng.random() < 0.4


# ---------------------------------------------------------------------------
# mutation operators (byte level, pre-compression)


def mut_truncate(rng, data):
    if not data:
        return data
    return data[: rng.randrange(len(data))]


def mut_crlf(rng, data):
    return data.replace(b"\n", b"\r\n")


def mut_len_mismatch(rng, data):
    # clip or grow a random qual line (line index 3 mod 4 in clean FASTQ)
    lines = data.split(b"\n")
    idx = [i for i in range(3, len(lines), 4) if lines[i]]
    if not idx:
        return data
    i = rng.choice(idx)
    lines[i] = lines[i][:-1] if rng.random() < 0.5 else lines[i] + b"II"
    return b"\n".join(lines)


def mut_subphred(rng, data):
    lines = data.split(b"\n")
    idx = [i for i in range(3, len(lines), 4) if lines[i]]
    if not idx:
        return data
    i = rng.choice(idx)
    q = bytearray(lines[i])
    q[rng.randrange(len(q))] = rng.randrange(0, 33)
    lines[i] = bytes(q)
    return b"\n".join(lines)


def mut_nonacgtn(rng, data):
    lines = data.split(b"\n")
    idx = [i for i in range(1, len(lines), 4) if lines[i]]
    if not idx:
        return data
    i = rng.choice(idx)
    s = bytearray(lines[i])
    for _ in range(rng.randrange(1, 4)):
        s[rng.randrange(len(s))] = rng.choice(b"XYZ*.-xyzRWSK")
    lines[i] = bytes(s)
    return b"\n".join(lines)


def mut_junk_splice(rng, data):
    junk = rng.choice([
        b"THIS IS NOT A RECORD\n",
        b"\x00\x01\x02 binary garbage \xff\xfe\n",
        b"+orphan plus line\n",
        b"@orphan_header_only\n",
        b"@frag\nACGT\n",
    ])
    pos = rng.randrange(len(data) + 1)
    # bias splices toward line boundaries (record-level damage); raw
    # mid-line splices still occur at 30%
    if rng.random() < 0.7:
        pos = data.rfind(b"\n", 0, pos) + 1
    return data[:pos] + junk + data[pos:]


def mut_byte_flip(rng, data):
    if not data:
        return data
    b = bytearray(data)
    b[rng.randrange(len(b))] = rng.randrange(256)
    return bytes(b)


def mut_empty(rng, data):
    return b""


def mut_blank_noise(rng, data):
    lines = data.split(b"\n")
    for _ in range(rng.randrange(1, 4)):
        lines.insert(rng.randrange(len(lines) + 1), b"")
    return b"\n".join(lines)


MUTATORS = [
    ("truncate", mut_truncate),
    ("crlf", mut_crlf),
    ("len_mismatch", mut_len_mismatch),
    ("subphred", mut_subphred),
    ("nonacgtn", mut_nonacgtn),
    ("junk_splice", mut_junk_splice),
    ("byte_flip", mut_byte_flip),
    ("empty", mut_empty),
    ("blank_noise", mut_blank_noise),
]


def mutate_corpus(rng: random.Random, data: bytes) -> tuple[bytes, list[str]]:
    names: list[str] = []
    for _ in range(rng.randrange(0, 3)):
        name, fn = rng.choice(MUTATORS)
        data = fn(rng, data)
        names.append(name)
    return data, names


# ---------------------------------------------------------------------------
# the differential check


def differential_check(data: bytes, tmp_dir: str, gz: bool,
                       gz_truncate_frac: float | None = None,
                       chunk_bases: int = 512) -> list[str]:
    """Run one corpus through both parsers; returns divergence descriptions
    (empty when the parsers agree on everything)."""
    problems: list[str] = []
    suffix = ".fastq.gz" if gz else ".fastq"
    payload = gzip.compress(data) if gz else data
    if gz and gz_truncate_frac is not None:
        payload = payload[: max(0, int(len(payload) * gz_truncate_frac))]
    fd, path = tempfile.mkstemp(suffix=suffix, dir=tmp_dir)
    with os.fdopen(fd, "wb") as fh:
        fh.write(payload)
    try:
        py_recs, py_bads = validate_mod.parse_path_tolerant(path)
        nat = native.parse_file(path, tolerant=True)
        if nat is None:
            return []  # no toolchain: nothing to differ against
        if nat.num_records != len(py_recs):
            problems.append(
                f"record count: native {nat.num_records} vs py {len(py_recs)}"
            )
        else:
            for i, rec in enumerate(py_recs):
                name, codes, quals = nat.record(i)
                if name != rec.header.decode("utf-8", "replace"):
                    problems.append(f"record {i} header mismatch")
                    break
                want = validate_mod.CODE_LUT[np.frombuffer(rec.seq, np.uint8)]
                if not np.array_equal(codes, want):
                    problems.append(f"record {i} codes mismatch")
                    break
                if rec.qual is not None:
                    wq = np.frombuffer(rec.qual, np.uint8) - 33
                    if quals is None or not np.array_equal(quals, wq):
                        problems.append(f"record {i} quals mismatch")
                        break
        nat_bads = [(o, r, raw) for o, r, raw in nat.bad]
        pyb = [(b.offset, b.reason, b.raw) for b in py_bads]
        if nat_bads != pyb:
            problems.append(
                f"bad-record lists differ: native {[(o, r) for o, r, _ in nat_bads]}"
                f" vs py {[(o, r) for o, r, _ in pyb]}"
            )
        # chunked vs whole-file native (carry/resync across boundaries)
        chunks = list(native.parse_chunks(path, chunk_bases=chunk_bases,
                                          tolerant=True))
        if sum(c.num_records for c in chunks) != nat.num_records:
            problems.append("chunked record count != whole-file")
        elif nat.num_records and not np.array_equal(
            np.concatenate([c.codes for c in chunks]) if chunks else np.array([]),
            nat.codes,
        ):
            problems.append("chunked codes != whole-file")
        if [t for c in chunks for t in c.bad] != nat_bads:
            problems.append("chunked bad list != whole-file")
        # strict cross-check: rejects IFF the tolerant parse found damage
        strict_raised = False
        try:
            native.parse_file(path)
        except ValueError:
            strict_raised = True
        if strict_raised != bool(pyb):
            problems.append(
                f"strict raised={strict_raised} but tolerant found "
                f"{len(pyb)} bad region(s)"
            )
    finally:
        os.remove(path)
    return problems


def run_case(seed: int, case: int, tmp_dir: str) -> list[str]:
    rng = random.Random(f"fuzz:{seed}:{case}")
    data, gz = gen_clean_corpus(rng)
    data, names = mutate_corpus(rng, data)
    gz_trunc = None
    if gz and rng.random() < 0.25:  # mid-stream gzip truncation
        gz_trunc = rng.random()
        names = names + ["gzip_truncate"]
    problems = differential_check(data, tmp_dir, gz, gz_truncate_frac=gz_trunc)
    return [f"seed={seed} case={case} muts={names}: {p}" for p in problems]


def run_campaign(seeds: list[int], cases: int, tmp_dir: str,
                 log=None) -> list[str]:
    failures: list[str] = []
    total = 0
    for seed in seeds:
        for case in range(cases):
            failures.extend(run_case(seed, case, tmp_dir))
            total += 1
        if log:
            log(f"fuzz: seed {seed} done ({total} corpora, "
                f"{len(failures)} divergences)")
    return failures


SANITIZE_FLAGS = "address,undefined"
_SAN_CHILD_ENV = "_TCR_TORCH_SAN_CHILD"


def sanitized_lib_path() -> str:
    """Path of the instrumented build (the loader's build directory, named
    by a hash of the source and the sanitizer flags)."""
    return native.library_path(SANITIZE_FLAGS)


def reexec_sanitized(argv: list[str]) -> int:
    """Build the ASan/UBSan parser and replay ``argv`` under the sanitizer.

    The ASan runtime must be in the process before the instrumented .so
    loads, and this Python is not ASan-linked — so the replay happens in a
    re-exec'd child with ``LD_PRELOAD=libasan.so``. Returns the child's
    exit status; build/toolchain unavailability is a skip (0) with a
    notice, matching the plain fuzzer's no-toolchain behavior.
    """
    lib = sanitized_lib_path()
    if not os.path.exists(lib):
        ok, out = native.build_library(lib, sanitize=SANITIZE_FLAGS)
        if not ok:
            print(f"fuzz --sanitized: sanitized build failed/unavailable; "
                  f"skipping ({out.strip()[:200]})", file=sys.stderr)
            return 0
    asan = native.asan_runtime_path()
    if asan is None:
        print("fuzz --sanitized: libasan.so not found; skipping", file=sys.stderr)
        return 0
    env = dict(
        os.environ,
        LD_PRELOAD=asan,
        ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
        UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1:abort_on_error=1",
        **{native.LIB_OVERRIDE_ENV: lib, _SAN_CHILD_ENV: "1"},
    )
    # leak detection off on purpose: the interpreter + numpy leak-at-exit
    # noise would drown real reports; the fuzzer's own allocations are
    # handle-scoped (fastx_free) and OOB/UAF/UB all still abort
    import subprocess

    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), *argv], env=env,
    )
    if proc.returncode:
        print(f"fuzz --sanitized: FAIL (child exit {proc.returncode}; a "
              "sanitizer report aborts the replay)", file=sys.stderr)
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5, help="number of seeds")
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=200,
                    help="mutated corpora per seed")
    ap.add_argument("--sanitized", action="store_true",
                    help="replay through the ASan/UBSan parser build")
    args = ap.parse_args(argv)
    if args.sanitized and not os.environ.get(_SAN_CHILD_ENV):
        child_argv = [a for a in (argv if argv is not None else sys.argv[1:])
                      if a != "--sanitized"]
        return reexec_sanitized(["--sanitized", *child_argv])
    if args.sanitized:
        print(f"fuzz: sanitized replay (fsanitize={SANITIZE_FLAGS}, "
              f"lib={os.environ.get(native.LIB_OVERRIDE_ENV)})", file=sys.stderr)
    if not native.available():
        print("fuzz: native parser unavailable (no C++ toolchain); nothing "
              "to differ against", file=sys.stderr)
        return 0
    seeds = list(range(args.start_seed, args.start_seed + args.seeds))
    with tempfile.TemporaryDirectory(prefix="fuzz_ingest_") as tmp_dir:
        failures = run_campaign(seeds, args.cases, tmp_dir,
                                log=lambda m: print(m, file=sys.stderr))
    n = args.seeds * args.cases
    if failures:
        for f in failures[:50]:
            print(f"DIVERGENCE: {f}", file=sys.stderr)
        print(f"fuzz: FAIL — {len(failures)} divergence(s) over {n} corpora",
              file=sys.stderr)
        return 1
    print(f"fuzz: OK — {n} corpora, zero crashes, zero divergences")
    return 0


if __name__ == "__main__":
    sys.exit(main())
