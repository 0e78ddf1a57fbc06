"""Differential ingest fuzzing of the port (``scripts/torch_fuzz_ingest.py``):
the port's native C++ parser and its pure-Python tolerant twin agree
record for record and rejection for rejection on seeded byte-level
mutations of clean corpora: no crash, no hang, no divergence; each
targeted gzip truncation also parses as the JAX package's native parser
parses it. The 5-seed smoke and a sanitized (ASan/UBSan) smoke run here;
the >= 1000-corpus campaigns are slow-marked, as in the JAX package's
``tests/test_fuzz_ingest.py``."""

import gzip
import importlib.util
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io import native  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(REPO, "scripts", "torch_fuzz_ingest.py")


@pytest.fixture(scope="module")
def fuzz():
    if not native.available():
        pytest.skip(f"the native parser does not build here: {native.build_error()}")
    spec = importlib.util.spec_from_file_location("torch_fuzz_ingest", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fuzz_smoke_5_seeds(tmp_path, fuzz):
    failures = fuzz.run_campaign(list(range(5)), cases=12, tmp_dir=str(tmp_path))
    assert not failures, "\n".join(failures[:20])


def test_fuzz_targeted_gzip_truncation(tmp_path, fuzz):
    """Every gzip truncation fraction of one corpus agrees across the
    port's parsers, and with the JAX package's native parser."""
    from ont_tcrconsensus_tpu.io import native as jnative

    data = b"".join(b"@r%d\nACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII\n" % i for i in range(100))
    payload = gzip.compress(data)
    for pct in range(5, 100, 10):
        problems = fuzz.differential_check(data, str(tmp_path), gz=True,
                                           gz_truncate_frac=pct / 100.0)
        assert not problems, f"truncation at {pct}%: {problems}"
        if jnative.available():
            path = tmp_path / f"t{pct}.fastq.gz"
            path.write_bytes(payload[: int(len(payload) * pct / 100.0)])
            got, want = (m.parse_file(str(path), tolerant=True) for m in (native, jnative))
            assert (got.names, got.bad, got.codes.tobytes()) == \
                (want.names, want.bad, want.codes.tobytes())


@pytest.mark.slow
def test_fuzz_full_campaign(tmp_path, fuzz):
    failures = fuzz.run_campaign(list(range(5)), cases=200, tmp_dir=str(tmp_path))
    assert not failures, "\n".join(failures[:50])


def _run_sanitized(*args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", native.LIB_OVERRIDE_ENV, native.SANITIZE_ENV)}
    return subprocess.run([sys.executable, _SCRIPT, "--sanitized", *args], capture_output=True,
                          text=True, timeout=240, env=env, cwd=REPO)


def test_sanitized_fuzz_smoke():
    """A seeded corpus replays through the ASan/UBSan parser with no
    sanitizer report (any report aborts the child: nonzero exit)."""
    if native.asan_runtime_path() is None:
        pytest.skip("g++'s libasan.so is not on this host")
    proc = _run_sanitized("--seeds", "1", "--cases", "10")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "sanitized replay" in proc.stderr, proc.stderr[-2000:]
    assert f"lib={native.library_path('address,undefined')}" in proc.stderr


@pytest.mark.slow
def test_sanitized_fuzz_full_campaign():
    if native.asan_runtime_path() is None:
        pytest.skip("g++'s libasan.so is not on this host")
    proc = _run_sanitized("--seeds", "5", "--cases", "250")
    assert proc.returncode == 0, proc.stderr[-4000:]
