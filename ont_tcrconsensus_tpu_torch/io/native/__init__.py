"""ctypes loader for the native FASTQ/FASTA parser (built at first use).

``fastx_parser.cpp`` compiles with the host's g++ against zlib into
``build/torch_native/libfastx-<hash>.so`` beside the package, named by a
hash of the source and the flags, so an edited source or another flag set
never loads a stale build. Builds happen at first use, never at import,
into a temporary name that :func:`os.replace` moves into place: several
processes may build at once. Where g++ or zlib is missing every consumer
falls back to the pure-Python parsers (:mod:`..fastx`, strict, and
:mod:`..validate`, tolerant), which have the same semantics; the fallback
is visible: :func:`build_error` returns the compiler's text and a line on
stderr says which parser a process uses.

Sanitized builds: ``TCR_TORCH_SANITIZE=address,undefined`` (any
``-fsanitize=`` value) switches the build to ``-O1 -g -fsanitize=...
-fno-omit-frame-pointer``. An ASan library only loads into a process that
preloaded the ASan runtime, so the sanitized fuzz replay re-runs itself
under ``LD_PRELOAD=libasan.so`` (``scripts/torch_fuzz_ingest.py
--sanitized``) with ``TCR_TORCH_FASTX_LIB`` pointing the loader at the
sanitized library. Both variables are the port's own, so a process that
imports another package with a native parser never points both loaders
at one library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import sys
import threading
import time

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastx_parser.cpp")
DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))), "build", "torch_native")
BUILD_DIR = DEFAULT_BUILD_DIR

#: the parser compiles warning-clean and stays that way
WARN_FLAGS = ("-Wall", "-Wextra")

SANITIZE_ENV = "TCR_TORCH_SANITIZE"  # e.g. "address,undefined"
LIB_OVERRIDE_ENV = "TCR_TORCH_FASTX_LIB"  # load exactly this .so, never build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_path: str | None = None  # where the cached _lib was loaded from
_build_failed = False
_build_error: str | None = None
_build_s = 0.0


def build_command(src: str, out: str, sanitize: str | None = None) -> list[str]:
    """The g++ command line for ``src`` -> ``out``.

    ``sanitize`` is a ``-fsanitize=`` value ("address,undefined"); it drops
    -O3 to -O1 and keeps frame pointers so reports carry usable stacks.
    """
    if sanitize:
        opt = ["-O1", "-g", f"-fsanitize={sanitize}", "-fno-omit-frame-pointer"]
    else:
        opt = ["-O3"]
    return ["g++", *opt, *WARN_FLAGS, "-shared", "-fPIC", src, "-lz", "-o", out]


def library_path(sanitize: str | None = None) -> str:
    """Where the build of the current source under ``sanitize`` lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(build_command("SRC", "OUT", sanitize)).encode())
    return os.path.join(BUILD_DIR, f"libfastx-{h.hexdigest()[:16]}.so")


def build_library(out_path: str, sanitize: str | None = None,
                  timeout: int = 240) -> tuple[bool, str]:
    """Compile the parser to ``out_path`` through a temporary name moved
    into place on success; returns (ok, compiler output)."""
    out_dir = os.path.dirname(os.path.abspath(out_path))
    tmp = f"{out_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(out_dir, exist_ok=True)
        proc = subprocess.run(build_command(_SRC, tmp, sanitize=sanitize),
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            return False, (proc.stderr or proc.stdout or f"g++ exited {proc.returncode}")
        os.replace(tmp, out_path)
        return True, (proc.stderr or proc.stdout or "")
    except (OSError, subprocess.TimeoutExpired) as exc:
        return False, str(exc)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def asan_runtime_path() -> str | None:
    """Path to g++'s libasan.so (to LD_PRELOAD); None when unavailable."""
    try:
        proc = subprocess.run(
            ["g++", "-print-file-name=libasan.so"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    path = proc.stdout.strip()
    return path if proc.returncode == 0 and os.path.isabs(path) else None


def _bind(lib: ctypes.CDLL) -> None:
    lib.fastx_parse.restype = ctypes.c_void_p
    lib.fastx_parse.argtypes = [ctypes.c_char_p]
    lib.fastx_error.restype = ctypes.c_char_p
    lib.fastx_error.argtypes = [ctypes.c_void_p]
    for fn in ("fastx_num_records", "fastx_total_bases", "fastx_names_size"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fastx_has_qual.restype = ctypes.c_int
    lib.fastx_has_qual.argtypes = [ctypes.c_void_p]
    lib.fastx_copy.restype = None
    lib.fastx_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
    ]
    lib.fastx_free.restype = None
    lib.fastx_free.argtypes = [ctypes.c_void_p]
    # the tolerant (quarantine-mode) API: bad-region accessors and the
    # tolerant parse/open variants
    lib.fastx_parse2.restype = ctypes.c_void_p
    lib.fastx_parse2.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fastx_num_bad.restype = ctypes.c_int64
    lib.fastx_num_bad.argtypes = [ctypes.c_void_p]
    lib.fastx_bad_offset.restype = ctypes.c_int64
    lib.fastx_bad_offset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fastx_bad_reason.restype = ctypes.c_char_p
    lib.fastx_bad_reason.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fastx_bad_raw_size.restype = ctypes.c_int64
    lib.fastx_bad_raw_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fastx_bad_raw_copy.restype = None
    lib.fastx_bad_raw_copy.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
    lib.fastx_open2.restype = ctypes.c_void_p
    lib.fastx_open2.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_stream_error.restype = ctypes.c_char_p
    lib.fastx_stream_error.argtypes = [ctypes.c_void_p]
    lib.fastx_next_chunk.restype = ctypes.c_void_p
    lib.fastx_next_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fastx_close.restype = None
    lib.fastx_close.argtypes = [ctypes.c_void_p]


def load() -> ctypes.CDLL | None:
    """The shared library, building it if needed; None when unavailable."""
    global _lib, _lib_path, _build_failed, _build_error, _build_s
    with _lock:
        # the override is consulted BEFORE any cached state: an explicit
        # library (the sanitized fuzz child) loads exactly that .so or
        # fails loudly, even after an earlier load() cached the default
        # build or a build failure
        override = os.environ.get(LIB_OVERRIDE_ENV)
        if _lib is not None and (not override or _lib_path == override):
            return _lib
        if override:
            lib = ctypes.CDLL(override)
            lib_path = override
        else:
            if _build_failed:
                return None
            lib_path = library_path(os.environ.get(SANITIZE_ENV) or None)
            try:
                if not os.path.exists(lib_path):
                    t0 = time.monotonic()
                    ok, text = build_library(lib_path,
                                             sanitize=os.environ.get(SANITIZE_ENV) or None)
                    _build_s += time.monotonic() - t0
                    if not ok:
                        raise OSError(text)
                lib = ctypes.CDLL(lib_path)
            except OSError as exc:
                _build_failed, _build_error = True, str(exc) or repr(exc)
                last = (_build_error.strip().splitlines() or [""])[-1][:300]
                print(f"native FASTQ parser unavailable, using the Python parser: {last}",
                      file=sys.stderr)
                return None
        _bind(lib)
        _lib, _lib_path = lib, lib_path
        return _lib


def available() -> bool:
    """True when the native parser builds and loads on this host."""
    return load() is not None


def build_error() -> str | None:
    """Why this process uses the Python parser (the compiler's or the
    loader's text), or None while the native parser is in use or has not
    been tried."""
    with _lock:
        return _build_error


def build_seconds() -> float:
    """Seconds this process has spent compiling the parser (0 when the
    build was already there)."""
    with _lock:
        return _build_s


@dataclasses.dataclass
class ParsedFastx:
    """Columnar parse result: dense codes ready for the device batcher."""

    codes: np.ndarray     # (total_bases,) uint8 dense codes
    quals: np.ndarray | None  # (total_bases,) uint8 phred, None for FASTA
    lengths: np.ndarray   # (N,) int32
    offsets: np.ndarray   # (N+1,) int64 into codes/quals
    names: list[str]      # full headers
    # tolerant mode: (absolute decompressed byte offset, canonical reason,
    # raw bytes) per quarantined region; always [] under the strict parse
    bad: list[tuple[int, str, bytes]] = dataclasses.field(default_factory=list)

    @property
    def num_records(self) -> int:
        return len(self.lengths)

    def record(self, i: int) -> tuple[str, np.ndarray, np.ndarray | None]:
        s, e = self.offsets[i], self.offsets[i + 1]
        return (
            self.names[i],
            self.codes[s:e],
            self.quals[s:e] if self.quals is not None else None,
        )


def _copy_out(lib, handle, path) -> ParsedFastx:
    """Copy a native ParsedFile handle into numpy arrays (then free it)."""
    try:
        err = lib.fastx_error(handle)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n = lib.fastx_num_records(handle)
        total = lib.fastx_total_bases(handle)
        has_qual = bool(lib.fastx_has_qual(handle))
        codes = np.zeros(total, np.uint8)
        quals = np.zeros(total, np.uint8) if has_qual else None
        lengths = np.zeros(n, np.int32)
        offsets = np.zeros(n + 1, np.int64)
        names_buf = ctypes.create_string_buffer(int(lib.fastx_names_size(handle)))
        lib.fastx_copy(
            handle,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if has_qual else None,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            names_buf,
        )
        names = names_buf.raw.decode("utf-8", "replace").split("\n")[:n]
        bad: list[tuple[int, str, bytes]] = []
        for i in range(int(lib.fastx_num_bad(handle))):
            size = int(lib.fastx_bad_raw_size(handle, i))
            raw_buf = ctypes.create_string_buffer(size) if size else None
            if raw_buf is not None:
                lib.fastx_bad_raw_copy(handle, i, raw_buf)
            bad.append((
                int(lib.fastx_bad_offset(handle, i)),
                lib.fastx_bad_reason(handle, i).decode("utf-8", "replace"),
                raw_buf.raw if raw_buf is not None else b"",
            ))
        return ParsedFastx(codes=codes, quals=quals, lengths=lengths,
                           offsets=offsets, names=names, bad=bad)
    finally:
        lib.fastx_free(handle)


def parse_file(
    path: str | os.PathLike[str], tolerant: bool = False,
) -> ParsedFastx | None:
    """Parse a whole file with the native library; None when it is
    unavailable.

    Strict (default): raises ValueError on malformed input (the contract of
    ``fastx.read_fastx``). ``tolerant=True``: malformed records and regions
    land in ``ParsedFastx.bad`` (offset, canonical reason, raw bytes) and
    parsing resynchronizes at the next record, the quarantine ingest path.
    It materializes the WHOLE file: lane-scale read files go through
    :func:`parse_chunks`.
    """
    lib = load()
    if lib is None:
        return None
    handle = lib.fastx_parse2(os.fspath(path).encode(), 1 if tolerant else 0)
    return _copy_out(lib, handle, path)


def parse_chunks(
    path: str | os.PathLike[str], chunk_bases: int = 32 << 20,
    tolerant: bool = False,
):
    """Generator of ParsedFastx chunks with O(chunk) host memory.

    Yields nothing (and returns) when the native library is unavailable:
    callers check :func:`available` first or fall back themselves. Raises
    ValueError on malformed input, like :func:`parse_file`; with
    ``tolerant=True`` malformed regions ride along in each chunk's ``bad``
    list instead (a chunk may carry bad entries and no records).
    """
    lib = load()
    if lib is None:
        return
    stream = lib.fastx_open2(os.fspath(path).encode(), 1 if tolerant else 0)
    try:
        err = lib.fastx_stream_error(stream)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        while True:
            handle = lib.fastx_next_chunk(stream, chunk_bases)
            if not handle:
                err = lib.fastx_stream_error(stream)
                if err:
                    raise ValueError(f"{path}: {err.decode()}")
                return
            yield _copy_out(lib, handle, path)
    finally:
        lib.fastx_close(stream)
