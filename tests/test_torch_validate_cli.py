"""``python -m ont_tcrconsensus_tpu_torch <config> --validate`` against the
JAX package's ``--validate``, on the JAX package's cases
(``tests/test_validate.py``): a clean lane, bad records, a bad config and
a missing reference, a clean v2 stage manifest, a checksum mismatch, torn,
v1 and malformed manifests, a mixed-version manifest, and the compile
cache's three settings. The text and the ``--json`` body must be the JAX
package's, but for the compile cache line and ``compile_cache.dir``: the
JAX package names its XLA cache, the port its kernel build directory. And
``--validate`` loads no torch."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.pipeline import cli as jcli  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import fastx, layout  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import _build  # noqa: E402
from ont_tcrconsensus_tpu_torch.pipeline import cli as tcli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_LINE = "validate: compile cache: "


def _write_config(tmp_path, **overrides):
    ref = tmp_path / "reference.fa"
    fastx.write_fasta(ref, [("regionA", "ACGT" * 200), ("regionB", "GGCC" * 200)])
    fq_dir = tmp_path / "fastq_pass" / "barcode01"
    fq_dir.mkdir(parents=True, exist_ok=True)
    fastx.write_fastq(fq_dir / "barcode01.fastq.gz", [("r1", "ACGT" * 100, "I" * 400)])
    cfg = {"reference_file": str(ref), "fastq_pass_dir": str(tmp_path / "fastq_pass")}
    cfg.update(overrides)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path, fq_dir


def _mark_counts_done(tmp_path, content=b"TCR,Count\nregionA,3\n"):
    """A completed library under <fastq_pass>/nano_tcr/barcode01."""
    nano = tmp_path / "fastq_pass" / "nano_tcr"
    nano.mkdir(parents=True, exist_ok=True)
    lay = layout.init_library_dir("/x/barcode01.fastq.gz", nano, resume=True)
    art = nano / "barcode01" / "counts" / "umi_consensus_counts.csv"
    art.write_bytes(content)
    lay.mark_stage_done("counts", artifacts=[art])
    return lay, art


def _manifest(tmp_path):
    return tmp_path / "fastq_pass" / "nano_tcr" / "barcode01" / "stage_manifest.json"


def _clean(tmp_path):
    return _write_config(tmp_path)[0]


def _bad_records(tmp_path):
    cfg, fq_dir = _write_config(tmp_path)
    (fq_dir / "bad.fastq").write_bytes(b"@r1\nACGT\n+\nII\n@r2\nAC\n+\n\x05\x05\njunk\n")
    return cfg


def _config_missing_key(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"reference_file": "r.fa"}))
    return bad


def _reference_missing(tmp_path):
    return _write_config(tmp_path, reference_file=str(tmp_path / "nope.fa"))[0]


def _no_inputs(tmp_path):
    cfg, fq_dir = _write_config(tmp_path)
    os.remove(fq_dir / "barcode01.fastq.gz")
    return cfg


def _v2_clean(tmp_path):
    cfg = _clean(tmp_path)
    _mark_counts_done(tmp_path)
    return cfg


def _checksum_mismatch(tmp_path):
    cfg = _clean(tmp_path)
    _, art = _mark_counts_done(tmp_path)
    data = bytearray(art.read_bytes())
    data[len(data) // 2] ^= 0x01
    art.write_bytes(bytes(data))  # same size: only sha256 can see this
    return cfg


def _manifest_text(text):
    def make(tmp_path):
        cfg = _clean(tmp_path)
        _mark_counts_done(tmp_path)
        _manifest(tmp_path).write_text(text)
        return cfg
    return make


def _mixed_version(tmp_path):
    cfg = _clean(tmp_path)
    lay, art = _mark_counts_done(tmp_path)
    _manifest(tmp_path).write_text(json.dumps({"align": 1700000000.0}))
    lay.mark_stage_done("counts", artifacts=[art])  # migrates to v2, align: null
    assert json.loads(_manifest(tmp_path).read_text())["version"] == 2
    return cfg


# name -> (what sets the case up, the exit code both must give)
CASES = {
    "clean": (_clean, 0),
    "bad-records": (_bad_records, 1),
    "config-missing-key": (_config_missing_key, 1),
    "reference-missing": (_reference_missing, 1),
    "no-inputs": (_no_inputs, 1),
    "v2-manifest-clean": (_v2_clean, 0),
    "checksum-mismatch": (_checksum_mismatch, 1),
    "v1-manifest": (_manifest_text(json.dumps({"counts": 1700000000.0})), 0),
    "torn-manifest": (_manifest_text('{"version": 2, "stages": {"coun'), 1),
    "v2-header-broken-body": (_manifest_text(json.dumps({"version": 2, "stages": [1, 2]})),
                              1),
    "malformed-v2-entry": (_manifest_text(json.dumps(
        {"version": 2, "stages": {"counts": {"t": None, "artifacts": None}}})), 1),
    "malformed-v1-entry": (_manifest_text(json.dumps({"counts": "not-a-time"})), 1),
    "mixed-version-manifest": (_mixed_version, 0),
    "imperative-executor": (lambda t: _write_config(t, executor="imperative")[0], 0),
    "compile-cache-off": (lambda t: _write_config(t, compile_cache_dir="off")[0], 0),
    "compile-cache-dir": (lambda t: _write_config(t, compile_cache_dir=str(t / "kc"))[0], 0),
}


def _validate(main, cfg, capsys, *extra) -> tuple[int, str]:
    rc = main([str(cfg), "--validate", *extra])
    return rc, capsys.readouterr().out


def _port_cache_dir(cfg_path) -> str | None:
    with open(cfg_path) as fh:
        cache = json.load(fh).get("compile_cache_dir")
    return None if cache == "off" else cache or _build.DEFAULT_BUILD_DIR


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_text_is_the_jax_package_s(tmp_path, capsys, name):
    make, want_rc = CASES[name]
    cfg = make(tmp_path)
    (rc, out), (jrc, jout) = (_validate(m, cfg, capsys) for m in (tcli.main, jcli.main))
    assert rc == jrc == want_rc
    lines, jlines = out.splitlines(), jout.splitlines()
    assert [ln for ln in lines if not ln.startswith(CACHE_LINE)] == \
        [ln for ln in jlines if not ln.startswith(CACHE_LINE)]
    cache = [ln for ln in lines if ln.startswith(CACHE_LINE)]
    assert len(cache) == len([ln for ln in jlines if ln.startswith(CACHE_LINE)])
    if name == "config-missing-key":
        assert cache == []
        return
    d = _port_cache_dir(cfg)
    if d is None:
        assert cache == [CACHE_LINE + 'disabled (compile_cache_dir="off")']
    else:
        assert cache == [CACHE_LINE + d + ("" if os.path.isdir(d) else " (will be created)")]
    assert lines[-1].startswith("validate: OK" if want_rc == 0 else "validate: FAIL")


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_json_body_is_the_jax_package_s(tmp_path, capsys, name):
    make, want_rc = CASES[name]
    cfg = make(tmp_path)
    (rc, out), (jrc, jout) = (_validate(m, cfg, capsys, "--json")
                              for m in (tcli.main, jcli.main))
    assert rc == jrc == want_rc
    body, jbody = json.loads(out), json.loads(jout)
    assert body["ok"] is (rc == 0)
    cache, jcache = body.pop("compile_cache"), jbody.pop("compile_cache")
    assert body == jbody
    if name == "config-missing-key":
        assert cache is jcache is None
        return
    d = _port_cache_dir(cfg)
    assert set(cache) == set(jcache)
    assert cache["enabled"] is jcache["enabled"] is (d is not None)
    assert cache["dir"] == d
    if d is not None:
        assert cache["exists"] is os.path.isdir(d)


def test_the_cli_refuses_what_the_jax_cli_refuses(tmp_path):
    cfg = _clean(tmp_path)
    for args in (["--json"], ["--validate", "--live-port", "0"]):
        with pytest.raises(SystemExit) as e:
            tcli.main([str(cfg), *args])
        assert e.value.code == 2


_PROBE = r"""
import runpy, sys
sys.argv = ["ont_tcrconsensus_tpu_torch", sys.argv[1], "--validate"]
try:
    runpy.run_module("ont_tcrconsensus_tpu_torch", run_name="__main__")
    rc = 0
except SystemExit as exc:
    rc = exc.code or 0
loaded = any(m == "torch" or m.startswith("torch.") for m in sys.modules)
sys.stderr.write(f"TORCH_LOADED={loaded}\n")
sys.exit(rc)
"""


@pytest.mark.parametrize("name", ["clean", "bad-records"])
def test_validate_loads_no_torch(tmp_path, name):
    make, want_rc = CASES[name]
    cfg = make(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(cfg)], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == want_rc, proc.stderr[-2000:]
    assert "TORCH_LOADED=False" in proc.stderr
    assert ("validate: OK" if want_rc == 0 else "validate: FAIL") in proc.stdout
