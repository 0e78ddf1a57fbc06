"""The PyTorch port stands alone: importing every one of its modules loads
neither JAX nor any module of the JAX package. Its DP constants, polish
band, pileup codes and plane bit layout (Python and CUDA sources) are
pinned to the JAX package's."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import ont_tcrconsensus_tpu_torch  # noqa: E402
from ont_tcrconsensus_tpu.ops import consensus as jconsensus  # noqa: E402
from ont_tcrconsensus_tpu.ops import encode as jencode  # noqa: E402
from ont_tcrconsensus_tpu.ops import pileup as jpileup  # noqa: E402
from ont_tcrconsensus_tpu.ops import sw_align as jsw  # noqa: E402
from ont_tcrconsensus_tpu_torch.ops import consensus, encode, pileup, sw_align  # noqa: E402

PKG_DIR = os.path.dirname(ont_tcrconsensus_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)

_PROBE = r"""
import importlib, json, pkgutil, sys
import ont_tcrconsensus_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "flax", "ont_tcrconsensus_tpu")
             or m.startswith(("jax.", "jaxlib.", "flax.", "ont_tcrconsensus_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_every_port_module_loads_no_jax():
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for must in ("ops.sw_kernel", "ops.pileup_kernel", "pipeline.run", "convert",
                 "pipeline.cli", "__main__", "models.polisher", "device",
                 "pipeline.overlap", "qc.artifacts", "qc.error_profile", "qc.timing",
                 "qc.umi_overlap", "robustness.contracts", "robustness.jobscope",
                 "robustness.retry"):
        assert f"ont_tcrconsensus_tpu_torch.{must}" in report["modules"]


def test_no_source_names_the_jax_package():
    """Guard against a lazy import inside a function, which the import
    probe cannot see."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|ont_tcrconsensus_tpu)(\.|\s|$)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pat.search(fh.read()):
                        offenders.append(os.path.join(root, f))
    assert offenders == []


def test_dp_constants_match_the_jax_package():
    for name in ("MATCH", "MISMATCH", "GAP_OPEN", "GAP_EXT", "NEG", "PAD_SENTINEL"):
        assert getattr(sw_align, name) == getattr(jsw, name), name
    assert sw_align.PAD_SENTINEL == encode.PAD_CODE == jencode.PAD_CODE
    assert consensus.POLISH_BAND_WIDTH == jconsensus.POLISH_BAND_WIDTH
    assert (pileup.UNCOVERED, pileup.DELETION) == (jpileup.UNCOVERED, jpileup.DELETION)
    for name in ("_DIAG", "_EGAP", "_FRESH", "_DIAG_STOP_BIT", "_EOPEN_BIT"):
        assert getattr(pileup, name) == getattr(jpileup, name), name


def _cuh_constants() -> dict[str, int]:
    with open(os.path.join(PKG_DIR, "csrc", "dp_common.cuh")) as fh:
        text = fh.read()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        shift = re.fullmatch(r"-\(1 << (\d+)\)", expr)
        consts[name] = -(1 << int(shift.group(1))) if shift else int(expr)
    return consts


def test_cuda_constants_match_the_jax_package():
    c = _cuh_constants()
    assert c["kNeg"] == jsw.NEG
    assert c["kPad"] == jsw.PAD_SENTINEL == jencode.PAD_CODE
    assert (c["kDiag"], c["kEGap"], c["kFresh"]) == (jpileup._DIAG, jpileup._EGAP,
                                                     jpileup._FRESH)
    assert c["kDiagStopBit"] == jpileup._DIAG_STOP_BIT
    assert c["kEOpenBit"] == jpileup._EOPEN_BIT
    # the packed plane is ``tdir | fjump << 4`` (pileup._forward_batch)
    assert c["kJumpShift"] == 4


def test_the_kernels_ship_as_package_data():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    globs = data["ont_tcrconsensus_tpu_torch"]
    assert "csrc/*.cu" in globs and "csrc/*.cuh" in globs and "primers/*.fasta" in globs


def test_the_polisher_weights_ship_as_package_data():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    assert data["ont_tcrconsensus_tpu_torch.models"] == ["weights/*.msgpack", "weights/*.json"]
    weights = os.listdir(os.path.join(PKG_DIR, "models", "weights"))
    assert {"polisher_v3.msgpack", "polisher_v3_eval.json", "polisher_v4.msgpack",
            "polisher_depth_gate_blastid.json"} <= set(weights)
