"""Per-stage wall-clock accounting: ``logs/stage_timing.tsv``.

The JAX package's ``qc/timing.py`` table (stage, seconds, calls; rows by
seconds, largest first), with the port's device rule: on CUDA a stage ends
when the calling thread's current stream has finished its work, so work a
stage queued counts to that stage. Only the calling thread's stream is
waited on: an overlapped QC worker runs on its own stream
(:mod:`..pipeline.overlap`), and a critical-path stage does not wait for it.

Every ``stage()`` scope measures through an :mod:`..obs.trace` span, with
the stream wait inside the span: the one duration computed at the span's
exit feeds this table, the run's ``telemetry.json`` stage table and (at
``telemetry: full``) the ``trace.json`` row. One clock read, three views.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

import torch

from ont_tcrconsensus_tpu_torch.obs import trace


class StageTimer:
    """Accumulates wall seconds per named stage (re-entrant across batches)."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        sp = trace.span(name)
        try:
            with sp:
                try:
                    yield
                finally:
                    if self.device is not None and self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
        finally:
            # sp.dur_s was computed at the span's exit (which ran, exception
            # or not): the same measurement
            self.seconds[name] += sp.dur_s
            self.calls[name] += 1

    def add(self, name: str, seconds: float) -> None:
        """Record externally measured seconds (an overlapped worker's wall
        clock) under ``name``."""
        self.seconds[name] += seconds
        self.calls[name] += 1

    def merge(self, other: "StageTimer") -> None:
        for k, v in other.seconds.items():
            self.seconds[k] += v
            self.calls[k] += other.calls[k]

    def write_tsv(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("stage\tseconds\tcalls\n")
            for name, sec in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
                fh.write(f"{name}\t{sec:.3f}\t{self.calls[name]}\n")
