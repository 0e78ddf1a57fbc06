"""Device instrumentation on the card: the dispatch split, the kernel-build
audit, and the memory high-water marks.

The JAX package's ``obs/device.py`` on PyTorch and CUDA, under the same
site names and the same ``telemetry.json`` tables.

**The dispatch split.** :func:`dispatch` wraps a dispatch scope and
:func:`timed_get` a readback; together they split each device call into

- ``block_s``: seconds the calling thread waited for the card, and
- ``host_s``: the rest of the scope (staging, Python, launches,
  bookkeeping).

Only :func:`timed_get` waits, and its wait covers the calling thread's
current CUDA stream only, never the whole device
(``torch.cuda.synchronize`` is never called here): the QC worker runs on
its own stream (pipeline/overlap.py), and a device-wide wait would make
the polish thread wait for the error profile. The copy to the host would
wait on that stream anyway, so arming telemetry adds no synchronization:
a :func:`dispatch` scope ends without a wait, as in the JAX package, and
the work it queued is waited for by the readback that needs it. A
:func:`timed_get` nested inside a dispatch scope on the same thread
credits its wait to the enclosing site (``polish.dispatch`` owns the
readbacks its chunk makes in ops/consensus and the polisher); a frameless
get records under its own site (``assign.dispatch``'s readbacks, made
after their scope on assign's readback thread as in the JAX package;
that thread waits for each batch's :func:`record_ready` events, not for
its current stream, which holds the next batch's launches). Disarmed,
both are one module-attribute check (a get still returns its host copy).

What the split cannot see: a wait the code makes without
:func:`timed_get` (a ``.item()``, ``.cpu()`` or ``.tolist()`` inside the
polish traceback or the error profile's loops, a data-dependent shape)
blocks the thread all the same but lands in ``host_s``. For those loops,
``host_s`` is host time plus implicit waits; the card's busy share comes
from a ``torch.profiler`` trace instead (``profile_trace_dir``).

**The build audit.** The card has no XLA compile; what the port compiles
is its kernels (ops/_build.load). Each ``nvcc`` build is counted under
``compile`` with its seconds, attributed like a JAX compile to the active
stage span and the innermost dispatch frame's bucket
(``round1_fused_assign[2048]``), with an ``xla.compile`` trace instant (the
JAX site name, so the vocabularies compare equal). A library loaded from a
warm build directory costs no build: it adds an instant with
``"built": false`` and no count, so a warm directory gives a count of 0.

**Memory.** :class:`MemorySampler` (``telemetry: full``) polls the caching
allocator's ``allocated_bytes.all.current`` on the run's device and the
host RSS as high-water gauges and trace counters; it reads allocator
statistics only, which synchronize nothing. :func:`finalize_memory`
one-shots the allocator's ``allocated_bytes.all.peak`` (what
``torch.cuda.max_memory_allocated`` reports) and ``ru_maxrss`` at roll-up.
On the CPU the device gauge is absent, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import resource
import sys
import threading
import time

import torch

from ont_tcrconsensus_tpu_torch.obs import metrics, trace, transfers

_tls = threading.local()

#: allocator statistics read for the device gauge (current) and its peak
ALLOCATED_CURRENT = "allocated_bytes.all.current"
ALLOCATED_PEAK = "allocated_bytes.all.peak"


class _Frame:
    __slots__ = ("site", "bucket", "block_s")

    def __init__(self, site: str, bucket):
        self.site = site
        self.bucket = bucket
        self.block_s = 0.0


def _frames() -> list[_Frame]:
    frames = getattr(_tls, "frames", None)
    if frames is None:
        frames = _tls.frames = []
    return frames


def _wait_current_stream() -> None:
    """Wait for the calling thread's current CUDA stream (nothing to wait
    for without CUDA in this process)."""
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


@contextlib.contextmanager
def dispatch(site: str, bucket=None):
    """Measure one device-dispatch scope at ``site``.

    ``bucket`` labels the shape family (the width bucket) for build
    attribution. Free no-op when telemetry is off.
    """
    reg = metrics._ARMED
    if reg is None:
        yield
        return
    frames = _frames()
    frame = _Frame(site, bucket)
    frames.append(frame)
    t0 = time.monotonic()
    try:
        yield
    finally:
        elapsed = time.monotonic() - t0
        if frames and frames[-1] is frame:
            frames.pop()
        reg.dispatch_add(
            site, dispatches=1,
            host_s=max(elapsed - frame.block_s, 0.0),
            block_s=frame.block_s,
            stage=trace.current_label(),
        )


def to_host(value, side_streams: dict | None = None):
    """The host copy of a tree of tensors (dict, list, tuple): each tensor
    becomes a numpy array; other leaves pass through. With
    ``side_streams`` (a dict, filled as it goes) a CUDA tensor is copied on
    a side stream of its device, not on the calling thread's current one."""
    if isinstance(value, torch.Tensor):
        if side_streams is not None and value.is_cuda:
            stream = side_streams.get(value.device)
            if stream is None:
                stream = side_streams[value.device] = _side_stream(value.device)
            with torch.cuda.stream(stream):
                # the allocator must not hand the block to the producer's
                # stream while this stream still reads it
                value.record_stream(stream)
                return value.cpu().numpy()
        return value.cpu().numpy()
    if isinstance(value, dict):
        return {k: to_host(v, side_streams) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_host(v, side_streams) for v in value)
    return value


def _side_stream(device: torch.device):
    """The calling thread's readback stream on ``device`` (one a thread and
    device, from the high-priority pool, so no stream of the run's own
    work: a copy there queues behind nothing)."""
    streams = getattr(_tls, "side_streams", None)
    if streams is None:
        streams = _tls.side_streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device=device, priority=-1)
    return streams[device]


def _devices(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value.device]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [d for v in value for d in _devices(v)]
    return []


def record_ready(value) -> list:
    """One CUDA event a CUDA device holding a tensor of ``value`` (a tree
    as :func:`to_host` takes), recorded on the calling thread's current
    stream there: the mark that the work queued so far for those outputs
    is done, for their readback on another thread (``timed_get``'s
    ``ready``). Outputs gathered from other devices' slices count: the
    gather's copy makes that stream wait for them. Empty when no tensor is
    on a CUDA device (the CPU's work is done when its call returns)."""
    events = []
    for dev in dict.fromkeys(_devices(value)):
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
    return events


def _readback(value, ready):
    if ready is None:
        return to_host(value)
    for ev in ready:
        ev.synchronize()
    return to_host(value, side_streams={})


def timed_get(site: str, value, ready: list | None = None):
    """The host copy of ``value`` (:func:`to_host`), with the seconds the
    calling thread waited for its stream and the copy credited to the
    enclosing :func:`dispatch` frame (or to ``site`` when frameless).

    ``ready`` (from :func:`record_ready` on the thread that queued the
    work) replaces the wait for the calling thread's current stream: the
    get waits for those events alone and copies on a side stream, so a
    readback thread neither waits for nor queues behind the launches made
    after the events."""
    reg = metrics._ARMED
    if reg is None:
        return _readback(value, ready)
    t0 = time.monotonic()
    if ready is None:
        _wait_current_stream()
    out = _readback(value, ready)
    dt = time.monotonic() - t0
    frames = getattr(_tls, "frames", None)
    if frames:
        # the wait flows to the enclosing frame, whose exit carries the
        # stage attribution; only the get count lands here
        frames[-1].block_s += dt
        reg.dispatch_add(site, gets=1, stage=trace.current_label())
    else:
        reg.dispatch_add(site, gets=1, block_s=dt, stage=trace.current_label())
    # every instrumented readback feeds the transfer ledger
    transfers.d2h(site, out)
    return out


# --- the kernel-build audit --------------------------------------------------


def _build_label() -> str:
    label = trace.current_label() or "<unattributed>"
    frames = getattr(_tls, "frames", None)
    if frames and frames[-1].bucket is not None:
        label = f"{label}[{frames[-1].bucket}]"
    return label


def kernel_built(name: str, seconds: float, built: bool) -> None:
    """Record one kernel library made ready by ops/_build.load: an ``nvcc``
    build (``built``, counted with its seconds) or a load from the build
    directory (an instant only). Free no-op when telemetry is off."""
    reg = metrics._ARMED
    if reg is None:
        return
    label = _build_label()
    if built:
        reg.compile_add(label, seconds)
    trace.instant("xla.compile", args={
        "stage": label, "kernel": name, "built": built, "seconds": round(seconds, 4),
    })


# --- memory high-water -------------------------------------------------------


def _rss_bytes() -> int:
    """Current resident set size (0 when /proc is unavailable)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * resource.getpagesize()
    except (OSError, ValueError, IndexError):
        return 0


def _peak_rss_bytes() -> int:
    """Process-lifetime peak RSS (ru_maxrss is KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _device_bytes_in_use(devices, key: str) -> int | None:
    """Sum the allocator statistic ``key`` over CUDA ``devices``; None when
    none reports it (the CPU has no device gauge)."""
    total, seen = 0, False
    for d in devices:
        if torch.device(d).type != "cuda":
            continue
        try:
            stats = torch.cuda.memory_stats(d)
        except Exception:
            stats = None
        if stats and key in stats:
            total += int(stats[key])
            seen = True
    return total if seen else None


#: the CUDA devices the current run declared (None: no run declared any)
_RUN_DEVICES: list | None = None


def set_run_devices(devices: list | None) -> None:
    """Declare the CUDA devices of the run in progress (``[]`` for a CPU
    run; None when it ends), so a sample taken during a CPU run never reads
    a card that an earlier run of the process used."""
    global _RUN_DEVICES
    _RUN_DEVICES = devices


def run_devices() -> list[torch.device]:
    """The CUDA devices the current run declared; without a declaration,
    those this process has used (none before CUDA starts)."""
    if _RUN_DEVICES is not None:
        return list(_RUN_DEVICES)
    if not torch.cuda.is_initialized():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class MemorySampler:
    """Background allocator/RSS sampler (armed at ``telemetry: full``)."""

    def __init__(self, devices=None, interval_s: float = 0.2):
        self.devices = devices
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="obs-memory-sampler", daemon=True
        )

    def start(self) -> "MemorySampler":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # bounded join: the thread is a daemon, so a straggler dies with
        # the process instead of holding up the run's shutdown
        self._thread.join(timeout=2.0)
        if self._thread.is_alive():
            sys.stderr.write(
                "telemetry: memory sampler did not stop within 2s; "
                "leaving the daemon thread\n"
            )

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            reg = metrics._ARMED
            if reg is None:
                continue
            devices = self.devices if self.devices is not None else run_devices()
            hbm = _device_bytes_in_use(devices, ALLOCATED_CURRENT)
            rss = _rss_bytes()
            if hbm is not None:
                reg.gauge_max("device.hbm_bytes_in_use", hbm)
            if rss:
                reg.gauge_max("host.rss_bytes", rss)
            col = trace._ARMED
            if col is not None:
                values = {"host_rss_bytes": rss}
                if hbm is not None:
                    values["hbm_bytes_in_use"] = hbm
                col.add_counter("memory", values)


def start_sampler(devices=None, interval_s: float = 0.2) -> MemorySampler:
    return MemorySampler(devices, interval_s).start()


def finalize_memory(devices=None) -> None:
    """One-shot peak capture at roll-up (any armed level): the allocator's
    own peak cannot miss a spike between sampler ticks, and ``ru_maxrss``
    is the kernel's host peak. ``devices`` defaults to every CUDA device
    of the process; a CPU run passes none."""
    reg = metrics._ARMED
    if reg is None:
        return
    try:
        devs = run_devices() if devices is None else devices
        peak = _device_bytes_in_use(devs, ALLOCATED_PEAK)
        if peak is not None:
            reg.gauge_max("device.hbm_bytes_in_use", peak)
    except Exception:  # telemetry must never fail the run it measures
        pass
    reg.gauge_max("host.rss_bytes", _peak_rss_bytes())
