"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library that
is loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). Libraries land in ``build/torch_kernels/`` beside the package,
named by a hash of their sources, so an edited source never loads a stale
build. Builds happen at first use, never at import; :func:`build_all`
starts every ``nvcc`` at once. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_kernels",
)
KERNELS = ("sw_banded", "pileup_forward")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # the toolkit's home when not on PATH

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources(name: str) -> list[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [os.path.join(CSRC, h) for h in headers]


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for src in _sources(name):
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(ARCH.encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _nvcc_command(name: str, out: str) -> list[str]:
    return [
        nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", out, os.path.join(CSRC, f"{name}.cu"),
    ]


def _start(name: str):
    """Start ``nvcc`` for one kernel; None when its library already exists."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        _nvcc_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for a build started by :func:`_start`; returns nvcc's report."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel in parallel (one ``nvcc`` each, started together);
    returns {name: nvcc's -Xptxas -v report} ('' for an existing build)."""
    with _lock:
        started = {name: _start(name) for name in KERNELS}
        return {name: _finish(name, started[name]) for name in KERNELS}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(library_path(name))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


def check(name: str, rc: int) -> None:
    """Raise on a non-zero return from a launcher: ValueError when it
    refused its arguments before launching (the limits live in the
    launcher alone), RuntimeError for any other CUDA error."""
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"{name} refused its arguments: the band width must be one it is built for, and "
            f"the scoring and lengths must fit its packed keys (see {name}_launch in "
            f"csrc/{name}.cu and scores_fit in csrc/dp_common.cuh)")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
