"""The port's observation layer: metrics, traces and device instrumentation.

A copy of the JAX package's ``obs`` package, on the card:

- :mod:`.metrics`: the process-wide registry of counters, high-water
  gauges, histograms, per-dispatch-site and per-build aggregates; one
  module-attribute check per planted site when disarmed.
- :mod:`.trace`: spans and instants written as a Chrome trace,
  ``logs/trace.json`` (one row per thread). :class:`~..qc.timing.StageTimer`
  measures through these spans, so the stage table, ``telemetry.json`` and
  the trace read one clock.
- :mod:`.device`: the per-site split of host time against time blocked on
  the card, the kernel-build audit, and the memory high-water marks.
- :mod:`.transfers`: the host/device byte ledger.
- :mod:`.history`: the cross-run ledger ``history.jsonl``.
- :mod:`.report`: the ``telemetry.json`` writer and the ``--report``
  renderer (which never imports torch).
- :mod:`.live`: the loopback HTTP plane (``live_port``) and the flight
  recorder.

Config ``telemetry: off|on|full``: ``on`` (the default) arms the registry
and the build audit and writes ``telemetry.json``; ``full`` also arms the
trace collector (``logs/trace.json``) and the memory sampler; ``off``
leaves every planted site one module-attribute check.

:data:`OBS_SITES` is the JAX package's site vocabulary, name for name, so
the two packages' artifacts compare by name; the port plants the names of
its own sites and keeps the rest for the slices that plant them.
"""

from __future__ import annotations

# The site vocabulary, equal to the JAX package's set. Under the JAX names
# the port records: "xla.compile" for a kernel build or load
# (ops/_build.load: an nvcc run or a library loaded from the build
# directory), "device.hbm_bytes_in_use" for the CUDA caching allocator's
# allocated bytes, and the dispatch sites' waits on the calling thread's
# stream. KNOWN_SITES is the JAX package's public alias.
OBS_SITES = frozenset({
    # --- stage spans (qc/timing.StageTimer -> trace.span; the JAX graph's
    # node names) ---
    "round1_fused_assign",
    "round1_error_profile",
    "round1_region_split",
    "write_region_fastas",
    "round1_umi_records",
    "round1_umi_cluster",
    "round1_polish",
    "round1_consensus",
    "round2_fused_assign",
    "round2_error_profile",
    "round2_umi_records",
    "round2_umi_cluster",
    "round2_counts",
    # --- hot-loop counters (metrics.counter_add) ---
    "assign.batches",
    "polish.chunks",
    "cluster.batched",
    # --- histogram observations (metrics.observe) ---
    "polish.chunk_clusters",
    # --- dispatch sites (device.dispatch / device.timed_get) ---
    "assign.dispatch",
    "polish.dispatch",
    "cluster.batched_dispatch",
    "consensus.get",
    "polisher.get",
    "umi.distance",
    # --- worker-pool busy/idle split (metrics.pool_add, overlap.py) ---
    "overlap.pool",
    # --- instant events (trace.instant) ---
    "chaos.inject",
    "xla.compile",
    # --- memory high-water gauges (metrics.gauge_max, device sampler) ---
    "device.hbm_bytes_in_use",
    "host.rss_bytes",
    # --- the live plane (obs/live.py) ---
    "live.requests",
    "live.serve",
    "flight.flush",
    # --- the serve daemon (a later slice of the port) ---
    "serve.submitted",
    "serve.rejected",
    "serve.requeued",
    "serve.retried",
    "serve.done",
    "serve.failed",
    "serve.poisoned",
    "serve.queue_depth",
    "serve.wait_s",
    "serve.first_stage_s",
    "serve.job",
    "serve.drain",
    # --- slice-packed serving (a later slice) ---
    "serve.resident_jobs",
    "serve.slice",
    # --- the data-plane ledger (obs/transfers.py) ---
    "transfer.h2d",
    "transfer.d2h",
    "donation.audit",
    "memory.reconcile",
    # --- sharded execution (parallel/mesh.py mark_mesh_slices, the
    # executor's degraded-mesh loop) ---
    "mesh.slice_busy",
    "mesh.degraded",
})

KNOWN_SITES = OBS_SITES
