"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library that
is loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). Libraries land in ``build/torch_kernels/`` beside the package,
named by a hash of their sources, so an edited source never loads a stale
build. Builds happen at first use, never at import; :func:`build_all`
starts every ``nvcc`` at once. A failed build raises. :func:`load`
reports each library it makes ready, an ``nvcc`` build or a load from the
build directory, to the telemetry build audit (``obs/device.kernel_built``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_kernels",
)
BUILD_DIR = DEFAULT_BUILD_DIR  # where libraries are built and looked up
KERNELS = ("sw_banded", "pileup_forward", "pileup_traceback", "error_profile_cs", "fuzzy_match",
           "dovetail")
# each launcher's C signature: its pointers, its ints, then the stream
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "sw_banded": [_P] * 6 + [_I] * 8 + [_P],
    "pileup_forward": [_P] * 7 + [_I] * 8 + [_P],
    "pileup_traceback": [_P] * 9 + [_I] * 4 + [_P],
    "error_profile_cs": [_P] * 10 + [_I] * 4 + [_P],
    "fuzzy_match": [_P] * 5 + [_I] * 4 + [_P],
    "dovetail": [_P] * 5 + [_I] * 5 + [_P],
}
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # the toolkit's home when not on PATH

_lock = threading.Lock()  # guards BUILD_DIR, _loaded, _builds and _seconds
_loaded: dict[str, ctypes.CDLL] = {}
_builds: dict[str, concurrent.futures.Future] = {}  # library path -> its build
_seconds = 0.0  # spent in build_all and load


def use_build_dir(path: str) -> None:
    """Build and look up libraries under ``path`` from now on (a run's
    ``compile_cache_dir``); libraries already loaded stay loaded."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = path


def nvcc_path() -> str:
    found = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources(name: str) -> list[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [os.path.join(CSRC, h) for h in headers]


def library_path(name: str) -> str:
    with _lock:
        build_dir = BUILD_DIR
    h = hashlib.sha256()
    for src in _sources(name):
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(ARCH.encode())
    return os.path.join(build_dir, f"lib{name}-{h.hexdigest()[:16]}.so")


def _nvcc_command(name: str, out: str) -> list[str]:
    return [
        nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", out, os.path.join(CSRC, f"{name}.cu"),
    ]


def _start(name: str):
    """Claim the build of ``name``'s library; start ``nvcc`` when this call
    builds it. Returns (path, the build's future, (process, temporary
    path) or None when the library exists or another call builds it).

    One build a library: the first caller records a future under
    :data:`_lock`, later callers wait on it. A finished build is looked at
    on disk under the same hold of the lock, after its future was seen
    done (its library is renamed into place before that), so a build that
    ends while this call runs is never taken for a removed library.
    ``nvcc`` starts, and is waited for and its output renamed into place
    (:func:`_finish`), outside the lock."""
    out = library_path(name)
    with _lock:
        fut = _builds.get(out)
        mine = fut is None or (fut.done() and not os.path.exists(out))  # removed since
        if mine:
            fut = _builds[out] = concurrent.futures.Future()
    if not mine:
        return out, fut, None
    if os.path.exists(out):  # built by an earlier process: this call owns the claim
        fut.set_result("")
        return out, fut, None
    try:
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = _nvcc_command(name, tmp)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    except BaseException as exc:
        _settle(out, fut, exc)
        raise
    return out, fut, (proc, tmp)


def _settle(out: str, fut, exc: BaseException) -> None:
    """A failed build: its waiters get the error, and a later call may
    build the library again."""
    with _lock:
        if _builds.get(out) is fut:
            del _builds[out]
    fut.set_exception(exc)


def _finish(name: str, started) -> tuple[str, bool]:
    """Wait for a build claimed by :func:`_start`: (nvcc's report, '' when
    this call did not build it; whether this call built it)."""
    out, fut, job = started
    if job is None:
        fut.result()  # another call's build: wait for it, raise its error
        return "", False
    proc, tmp = job
    try:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    except BaseException as exc:
        _settle(out, fut, exc)
        raise
    fut.set_result(log)
    return log, True


def build_all() -> dict[str, str]:
    """Build every kernel in parallel (one ``nvcc`` each, started together);
    returns {name: nvcc's -Xptxas -v report} ('' for an existing build).
    The first error is raised after every started build has ended."""
    global _seconds
    t0 = time.monotonic()
    started, logs, error = {}, {}, None
    for name in KERNELS:
        try:
            started[name] = _start(name)
        except Exception as exc:  # no nvcc: settle the builds already started
            error = exc
            break
    for name, claim in started.items():
        try:
            logs[name] = _finish(name, claim)[0]
        except Exception as exc:
            error = error or exc
    with _lock:
        _seconds += time.monotonic() - t0
    if error is not None:
        raise error
    return logs


def seconds() -> float:
    """Seconds this process has spent building and loading kernel
    libraries (:func:`build_all` and :func:`load`)."""
    with _lock:
        return _seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    global _seconds
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    from ont_tcrconsensus_tpu_torch.obs import device as obs_device

    t0 = time.monotonic()
    started = _start(name)
    built = _finish(name, started)[1]
    lib = ctypes.CDLL(started[0])
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    with _lock:
        kept = _loaded.setdefault(name, lib)  # a racing load keeps the first
        if kept is lib:
            _seconds += time.monotonic() - t0
    if kept is lib:
        obs_device.kernel_built(name, time.monotonic() - t0, built=built)
    return kept


CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


# what each launcher refuses, beyond negative sizes (each launcher alone holds
# its limits)
_LIMITS = {
    "fuzzy_match": "the pattern length m must be at most 1787 (28 words of match tables and "
                   "column a block) and the patterns must fit the grid (P <= 65535)",
    "dovetail": "the first sequences' width La must be at most 1452 (23 words of match "
                "tables and column a lane)",
}
_PACKED = ("the band width must be one it is built for, and the scoring and lengths must fit "
           "its packed keys")


def check(name: str, rc: int) -> None:
    """Raise on a non-zero return from a launcher: ValueError when it
    refused its arguments before launching (the limits live in the
    launcher alone), RuntimeError for any other CUDA error."""
    if rc == CUDA_ERROR_INVALID_VALUE:
        where = (f"{name}_launch in csrc/{name}.cu" if name in _LIMITS else
                 f"{name}_launch in csrc/{name}.cu and scores_fit in csrc/dp_common.cuh")
        raise ValueError(f"{name} refused its arguments: {_LIMITS.get(name, _PACKED)} "
                         f"(see {where})")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
