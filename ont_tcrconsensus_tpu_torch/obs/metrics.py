"""Process-wide metrics registry (counters, high-water gauges, histograms).

A copy of the JAX package's ``obs/metrics.py``: the same tables, the same
``summary()`` body of ``telemetry.json`` and the same Prometheus text, so
the two packages' artifacts compare key for key. One registry is armed per
run (pipeline/run.py) when ``telemetry`` is ``on`` or ``full``; every
planted site goes through the module functions below, one
module-attribute check when disarmed. Armed, an update is one dict
operation under a lock; the sites are per batch, chunk or call, never per
read or per DP row.

Beside the generic families the registry holds:

- **dispatch sites** (fed by :mod:`.device`): per site, dispatch and get
  counts and the split of host seconds against seconds blocked on the
  card;
- **compiles** (fed by :mod:`.device`): on the card, the kernel builds
  and loads of ``ops/_build.load``, each attributed to its stage and
  dispatch bucket;
- **stages**: span seconds fed by :mod:`.trace` at span exit, the clock
  read that also feeds ``stage_timing.tsv``.

The graph, mesh and serve tables are kept for the slices that fill them.
"""

from __future__ import annotations

import time

from ont_tcrconsensus_tpu_torch.robustness import jobscope, lockcheck


class MetricsRegistry:
    """Thread-safe per-run metric store; see :func:`arm`."""

    def __init__(self):
        self._lock = lockcheck.make_lock()
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}  # high-water (max) semantics
        # last-value (live) semantics: the serve queue depth NOW, not its
        # high-water — /metrics scrapes between jobs must see it fall
        self.gauges_live: dict[str, float] = {}
        # serve-plane rejection reason -> count (queue_full / over_budget /
        # invalid_config / draining / body_too_large); its own table
        # because the reason is a label dimension, not an OBS_SITES site
        self.serve_rejects: dict[str, float] = {}
        # mesh slice ("cpu:0") -> busy fraction (1.0 carrying work, 0.0
        # lost/idle); last-value semantics like gauges_live — a /metrics
        # scrape after a degradation must show the dead slice at 0. Its
        # own table because the slice is a label dimension, not a site.
        self.mesh_slices: dict[str, float] = {}
        # chaos/fault site ("mesh.device_lost") -> count of degraded-mesh
        # re-executions it caused; label dimension, not an OBS_SITES site
        self.mesh_degraded: dict[str, float] = {}
        # mesh slice ("cpu:0") -> resident tenant job id ("" when idle);
        # written by the serve-plane slice allocator (serve/slices.py) so
        # /metrics shows who owns what — label dimension, not a site
        self.slice_tenants: dict[str, str] = {}
        # mesh slice -> quarantine count (device_lost contained to that
        # slice); label dimension, not an OBS_SITES site
        self.slice_quarantined: dict[str, float] = {}
        # site -> [count, sum, min, max]
        self.hists: dict[str, list[float]] = {}
        # name -> [seconds, calls]
        self.stages: dict[str, list[float]] = {}
        # site -> [n_dispatch, n_get, host_s, block_s]
        self.dispatch: dict[str, list[float]] = {}
        # label -> [count, seconds]
        self.compiles: dict[str, list[float]] = {}
        # graph node -> [critical_s, overlapped_s, runs, skips]
        self.graph_nodes: dict[str, list[float]] = {}
        # graph edge -> placement ("hbm" | "host" | "disk")
        self.graph_edges: dict[str, str] = {}
        # graph node -> {"inputs": [...], "outputs": [...], "units": int}
        # (declared structure; lets obs/critical_path.py rebuild the DAG
        # from the artifact alone)
        self.graph_meta: dict[str, dict] = {}
        # pool site -> [busy_s, idle_s, window_s, slots]
        self.pools: dict[str, list[float]] = {}
        # analyzer name -> verdict summary (e.g. "graftcheck" ->
        # graph.check.Report.summary(); static findings ride the same
        # telemetry artifact so the history ledger tracks them per run)
        self.analysis: dict[str, dict] = {}
        # stage label -> [n_dispatch, n_get, host_s, block_s] (the
        # dispatch-tax split re-keyed by the active stage span, so the
        # per-node rollup needs no trace replay)
        self.dispatch_stages: dict[str, list[float]] = {}
        # --- device data-plane ledger (fed by obs/transfers.py) ---
        # site -> [h2d_bytes, h2d_count, d2h_bytes, d2h_count]
        self.transfers: dict[str, list[float]] = {}
        # graph edge -> [bytes, count, direction, placement]
        self.edge_transfers: dict[str, list] = {}
        # graph edge -> {"verdict": donated|copied|unknown, "node": str}
        self.donations: dict[str, dict] = {}
        # graph node -> [delta_bytes_sum, end_bytes_max, samples]
        self.node_hbm: dict[str, list[float]] = {}
        # graph node -> graftcheck static live-HBM estimate (max over
        # libraries; recorded at run start so --report reconciles from
        # the artifact alone)
        self.static_hbm: dict[str, float] = {}
        # [bytes, last_sample] — bytes that left the device and came
        # back (graftcheck round-trip edges); list so the lock rule sees
        # mutation, not rebinding
        self._round_trip = [0.0]
        self._hbm_prev: float | None = None

    # --- update API (called via the module-level wrappers) -----------------

    def counter_add(self, site: str, n: float = 1) -> None:
        with self._lock:
            self.counters[site] = self.counters.get(site, 0) + n

    def gauge_max(self, site: str, value: float) -> None:
        with self._lock:
            if value > self.gauges.get(site, float("-inf")):
                self.gauges[site] = value

    def gauge_set(self, site: str, value: float) -> None:
        """Live gauge: last value wins AND the high-water table keeps its
        max, so one plant feeds both the /metrics live view and the
        telemetry.json high-water roll-up."""
        with self._lock:
            self.gauges_live[site] = value
            if value > self.gauges.get(site, float("-inf")):
                self.gauges[site] = value

    def reject_add(self, reason: str, n: float = 1) -> None:
        with self._lock:
            self.serve_rejects[reason] = self.serve_rejects.get(reason, 0) + n

    def mesh_slice_set(self, slice_id: str, busy: float) -> None:
        with self._lock:
            self.mesh_slices[slice_id] = busy

    def mesh_degraded_add(self, site: str, n: float = 1) -> None:
        with self._lock:
            self.mesh_degraded[site] = self.mesh_degraded.get(site, 0) + n

    def slice_tenant_set(self, slice_id: str, tenant: str) -> None:
        with self._lock:
            self.slice_tenants[slice_id] = tenant

    def slice_quarantine_add(self, slice_id: str, n: float = 1) -> None:
        with self._lock:
            self.slice_quarantined[slice_id] = (
                self.slice_quarantined.get(slice_id, 0) + n)

    def observe(self, site: str, value: float) -> None:
        with self._lock:
            h = self.hists.get(site)
            if h is None:
                self.hists[site] = [1, value, value, value]
            else:
                h[0] += 1
                h[1] += value
                h[2] = min(h[2], value)
                h[3] = max(h[3], value)

    def stage_add(self, name: str, seconds: float) -> None:
        with self._lock:
            s = self.stages.get(name)
            if s is None:
                self.stages[name] = [seconds, 1]
            else:
                s[0] += seconds
                s[1] += 1

    def dispatch_add(self, site: str, *, dispatches: int = 0, gets: int = 0,
                     host_s: float = 0.0, block_s: float = 0.0,
                     stage: str | None = None) -> None:
        with self._lock:
            d = self.dispatch.setdefault(site, [0, 0, 0.0, 0.0])
            d[0] += dispatches
            d[1] += gets
            d[2] += host_s
            d[3] += block_s
            if stage is not None:
                s = self.dispatch_stages.setdefault(stage, [0, 0, 0.0, 0.0])
                s[0] += dispatches
                s[1] += gets
                s[2] += host_s
                s[3] += block_s

    def compile_add(self, label: str, seconds: float) -> None:
        with self._lock:
            c = self.compiles.setdefault(label, [0, 0.0])
            c[0] += 1
            c[1] += seconds

    def graph_node_add(self, name: str, *, critical_s: float = 0.0,
                       overlapped_s: float = 0.0) -> None:
        with self._lock:
            g = self.graph_nodes.setdefault(name, [0.0, 0.0, 0, 0])
            g[0] += critical_s
            g[1] += overlapped_s
            g[2] += 1

    def graph_node_skip(self, name: str) -> None:
        with self._lock:
            g = self.graph_nodes.setdefault(name, [0.0, 0.0, 0, 0])
            g[3] += 1

    def graph_edge_set(self, name: str, placement: str) -> None:
        with self._lock:
            self.graph_edges[name] = placement

    def graph_node_declare(self, name: str, *, inputs=None, outputs=None,
                           units: int | None = None) -> None:
        """Record a node's declared structure (dependency edges) and its
        evaluated workload units (summed over runs, like the seconds)."""
        with self._lock:
            m = self.graph_meta.setdefault(name, {})
            if inputs is not None:
                m["inputs"] = list(inputs)
            if outputs is not None:
                m["outputs"] = list(outputs)
            if units is not None:
                m["units"] = m.get("units", 0) + int(units)

    def pool_add(self, site: str, *, busy_s: float = 0.0, idle_s: float = 0.0,
                 window_s: float = 0.0, slots: int = 0) -> None:
        with self._lock:
            p = self.pools.setdefault(site, [0.0, 0.0, 0.0, 0])
            p[0] += busy_s
            p[1] += idle_s
            p[2] += window_s
            p[3] = max(p[3], slots)

    def analysis_set(self, name: str, summary: dict) -> None:
        with self._lock:
            self.analysis[name] = dict(summary)

    # --- device data-plane ledger (obs/transfers.py) -----------------------

    def transfer_add(self, site: str, direction: str, nbytes: int,
                     n: int = 1) -> None:
        with self._lock:
            t = self.transfers.setdefault(site, [0, 0, 0, 0])
            i = 0 if direction == "h2d" else 2
            t[i] += nbytes
            t[i + 1] += n

    def edge_transfer_add(self, edge: str, direction: str, nbytes: int,
                          placement: str) -> None:
        with self._lock:
            e = self.edge_transfers.setdefault(
                edge, [0, 0, direction, placement])
            e[0] += nbytes
            e[1] += 1

    def donation_set(self, edge: str, verdict: str, node: str) -> None:
        with self._lock:
            # a single "copied" sighting must survive later "donated"
            # materializations of the same edge — the regression is the
            # finding, not the steady state
            prev = self.donations.get(edge)
            if prev is None or prev["verdict"] != "copied":
                self.donations[edge] = {"verdict": verdict, "node": node}

    def node_hbm_add(self, node: str, end_bytes: float) -> None:
        with self._lock:
            prev = self._hbm_prev
            self._hbm_prev = end_bytes
            h = self.node_hbm.setdefault(node, [0.0, 0.0, 0])
            if prev is not None:
                h[0] += end_bytes - prev
            h[1] = max(h[1], end_bytes)
            h[2] += 1

    def static_hbm_set(self, node: str, bytes_est: float) -> None:
        with self._lock:
            if bytes_est > self.static_hbm.get(node, float("-inf")):
                self.static_hbm[node] = bytes_est

    def round_trip_add(self, nbytes: int) -> None:
        with self._lock:
            self._round_trip[0] += nbytes

    # --- roll-up -----------------------------------------------------------

    def summary(self) -> dict:
        """The ``telemetry.json`` body (times rounded for stable artifacts)."""
        with self._lock:
            compile_n = sum(int(c[0]) for c in self.compiles.values())
            compile_s = sum(c[1] for c in self.compiles.values())
            out = {
                "duration_s": round(time.monotonic() - self.t0_mono, 3),
                "t_wall_start": round(self.t0_wall, 3),
                "t_mono_start": round(self.t0_mono, 3),
                "stages": {
                    k: {"seconds": round(v[0], 3), "calls": int(v[1])}
                    for k, v in sorted(self.stages.items(),
                                       key=lambda kv: -kv[1][0])
                },
                "dispatch": {
                    k: {"dispatches": int(v[0]), "gets": int(v[1]),
                        "host_s": round(v[2], 3), "block_s": round(v[3], 3)}
                    for k, v in sorted(self.dispatch.items())
                },
                "compile": {
                    "count": compile_n,
                    "seconds": round(compile_s, 3),
                    "by_stage": {
                        k: {"count": int(v[0]), "seconds": round(v[1], 3)}
                        for k, v in sorted(self.compiles.items(),
                                           key=lambda kv: -kv[1][1])
                    },
                },
                "counters": {k: self.counters[k] for k in sorted(self.counters)},
                "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
                **({"gauges_live": {k: self.gauges_live[k]
                                    for k in sorted(self.gauges_live)}}
                   if self.gauges_live else {}),
                **({"serve_rejected_by_reason": {
                        k: int(self.serve_rejects[k])
                        for k in sorted(self.serve_rejects)}}
                   if self.serve_rejects else {}),
                **({"mesh_slice_busy": {
                        k: self.mesh_slices[k]
                        for k in sorted(self.mesh_slices)}}
                   if self.mesh_slices else {}),
                **({"mesh_degraded_by_site": {
                        k: int(self.mesh_degraded[k])
                        for k in sorted(self.mesh_degraded)}}
                   if self.mesh_degraded else {}),
                **({"slice_tenants": {
                        k: self.slice_tenants[k]
                        for k in sorted(self.slice_tenants)}}
                   if self.slice_tenants else {}),
                **({"slice_quarantined": {
                        k: int(self.slice_quarantined[k])
                        for k in sorted(self.slice_quarantined)}}
                   if self.slice_quarantined else {}),
                "histograms": {
                    k: {"count": int(v[0]), "sum": round(v[1], 3),
                        "min": v[2], "max": v[3]}
                    for k, v in sorted(self.hists.items())
                },
            }
            # data-plane ledger: always present when armed, so a
            # --report --memory over any post-upgrade artifact can tell
            # "nothing moved" apart from "nothing was measured"
            transfers: dict = {
                "sites": {
                    k: {"h2d_bytes": int(v[0]), "h2d": int(v[1]),
                        "d2h_bytes": int(v[2]), "d2h": int(v[3])}
                    for k, v in sorted(self.transfers.items())
                },
                "edges": {
                    k: {"bytes": int(v[0]), "count": int(v[1]),
                        "direction": v[2], "placement": v[3]}
                    for k, v in sorted(self.edge_transfers.items())
                },
                "host_round_trip_bytes": int(self._round_trip[0]),
            }
            if self.donations:
                transfers["donation"] = {
                    k: dict(self.donations[k]) for k in sorted(self.donations)
                }
            if self.node_hbm:
                transfers["node_hbm"] = {
                    k: {"delta_bytes": int(v[0]), "end_bytes": int(v[1]),
                        "samples": int(v[2])}
                    for k, v in sorted(self.node_hbm.items())
                }
            if self.static_hbm:
                transfers["static_hbm_by_node"] = {
                    k: int(self.static_hbm[k]) for k in sorted(self.static_hbm)
                }
            out["transfers"] = transfers
            if self.dispatch_stages:
                out["dispatch_by_stage"] = {
                    k: {"dispatches": int(v[0]), "gets": int(v[1]),
                        "host_s": round(v[2], 3), "block_s": round(v[3], 3)}
                    for k, v in sorted(self.dispatch_stages.items())
                }
            if self.analysis:
                out["analysis"] = {
                    k: dict(self.analysis[k]) for k in sorted(self.analysis)
                }
            pool = None
            if self.pools:
                # one merged busy/idle split (a run has one overlap pool
                # vocabulary entry; summing stays correct if more appear)
                pool = {
                    "busy_s": round(sum(p[0] for p in self.pools.values()), 3),
                    "idle_s": round(sum(p[1] for p in self.pools.values()), 3),
                    "window_s": round(
                        sum(p[2] for p in self.pools.values()), 3),
                    "slots": max(int(p[3]) for p in self.pools.values()),
                }
            # graph-executor section: present only when a graph actually
            # ran, so imperative-path telemetry keeps its exact shape
            if self.graph_nodes or self.graph_edges:
                gnodes = {}
                for k in sorted(set(self.graph_nodes) | set(self.graph_meta)):
                    v = self.graph_nodes.get(k, [0.0, 0.0, 0, 0])
                    entry = {"critical_s": round(v[0], 3),
                             "overlapped_s": round(v[1], 3),
                             "runs": int(v[2]), "skips": int(v[3])}
                    meta = self.graph_meta.get(k)
                    if meta:
                        entry["units"] = int(meta.get("units", 0))
                        entry["inputs"] = list(meta.get("inputs", ()))
                        entry["outputs"] = list(meta.get("outputs", ()))
                    gnodes[k] = entry
                out["graph"] = {
                    "nodes": gnodes,
                    "edges": {k: self.graph_edges[k]
                              for k in sorted(self.graph_edges)},
                }
                if pool is not None:
                    out["graph"]["pool"] = pool
            elif pool is not None:
                # imperative executor with overlap_qc: no graph section to
                # host the pool split, so it rides top-level
                out["overlap_pool"] = pool
            return out

    def prometheus_lines(self) -> list[str]:
        """Prometheus text-exposition (v0.0.4) rendering of the registry,
        served live by obs/live.py's /metrics route.

        One locked pass over the same aggregates ``summary()`` rolls up;
        site/stage/node names become label values (dots and all — label
        VALUES are free-form, only metric names are constrained), so the
        exposition vocabulary is exactly :data:`~ont_tcrconsensus_tpu_torch.obs.
        OBS_SITES` and no scrape-side mapping table can drift.
        """
        def fam(lines: list[str], name: str, kind: str, help_: str,
                samples: list[tuple[str, str, float]]) -> None:
            if not samples:
                return
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for label, value, v in samples:
                lines.append(f'{name}{{{label}="{prom_label(value)}"}} {v:g}')

        with self._lock:
            lines: list[str] = [
                "# HELP tcr_run_duration_seconds Seconds since the "
                "registry was armed.",
                "# TYPE tcr_run_duration_seconds gauge",
                f"tcr_run_duration_seconds "
                f"{time.monotonic() - self.t0_mono:g}",
            ]
            fam(lines, "tcr_counter_total", "counter",
                "Hot-loop counters (metrics.counter_add sites).",
                [("site", k, self.counters[k])
                 for k in sorted(self.counters)])
            fam(lines, "tcr_gauge", "gauge",
                "High-water gauges (HBM in use, host RSS, ...).",
                [("site", k, self.gauges[k]) for k in sorted(self.gauges)])
            fam(lines, "tcr_gauge_current", "gauge",
                "Live last-value gauges (serve queue depth NOW, not its "
                "high-water).",
                [("site", k, self.gauges_live[k])
                 for k in sorted(self.gauges_live)])
            fam(lines, "tcr_serve_rejected_total", "counter",
                "Serve-plane job rejections by reason (queue_full / "
                "over_budget / invalid_config / draining / body_too_large).",
                [("reason", k, self.serve_rejects[k])
                 for k in sorted(self.serve_rejects)])
            # the slice-busy family carries an OPTIONAL second label
            # (tenant occupancy from the serve-plane allocator), so it's
            # rendered by hand — fam() is the single-label helper
            if self.mesh_slices:
                lines.append("# HELP tcr_mesh_slice_busy Per-mesh-slice "
                             "busy fraction (1 carrying work, 0 lost/idle "
                             "after a degradation).")
                lines.append("# TYPE tcr_mesh_slice_busy gauge")
                for k in sorted(self.mesh_slices):
                    tenant = self.slice_tenants.get(k)
                    labels = f'slice="{prom_label(k)}"'
                    if tenant:
                        labels += f',tenant="{prom_label(tenant)}"'
                    lines.append(
                        f"tcr_mesh_slice_busy{{{labels}}} "
                        f"{self.mesh_slices[k]:g}")
            fam(lines, "tcr_slice_quarantined_total", "counter",
                "Slices quarantined out of the serve-plane free pool "
                "(device_lost contained to one tenant's slice).",
                [("slice", k, self.slice_quarantined[k])
                 for k in sorted(self.slice_quarantined)])
            if "serve.resident_jobs" in self.gauges_live:
                lines.append("# HELP tcr_serve_resident_jobs Tenant jobs "
                             "currently resident on disjoint mesh slices.")
                lines.append("# TYPE tcr_serve_resident_jobs gauge")
                lines.append(
                    f"tcr_serve_resident_jobs "
                    f"{self.gauges_live['serve.resident_jobs']:g}")
            fam(lines, "tcr_mesh_degraded_total", "counter",
                "Degraded-mesh re-executions by the fault site that "
                "caused them.",
                [("site", k, self.mesh_degraded[k])
                 for k in sorted(self.mesh_degraded)])
            for i, (suffix, help_) in enumerate((
                ("count", "Histogram observation counts."),
                ("sum", "Histogram observation sums."),
                ("min", "Histogram observation minima."),
                ("max", "Histogram observation maxima."),
            )):
                fam(lines, f"tcr_observations_{suffix}",
                    "counter" if i < 2 else "gauge", help_,
                    [("site", k, self.hists[k][i])
                     for k in sorted(self.hists)])
            fam(lines, "tcr_stage_seconds_total", "counter",
                "Per-stage span seconds (same clock as stage_timing.tsv).",
                [("stage", k, self.stages[k][0])
                 for k in sorted(self.stages)])
            fam(lines, "tcr_stage_calls_total", "counter",
                "Per-stage span entry counts.",
                [("stage", k, self.stages[k][1])
                 for k in sorted(self.stages)])
            disp = sorted(self.dispatch)
            fam(lines, "tcr_dispatch_total", "counter",
                "Per-site device dispatch counts.",
                [("site", k, self.dispatch[k][0]) for k in disp])
            fam(lines, "tcr_dispatch_gets_total", "counter",
                "Per-site blocking-get counts.",
                [("site", k, self.dispatch[k][1]) for k in disp])
            fam(lines, "tcr_dispatch_host_seconds_total", "counter",
                "Per-site host-gap seconds (dispatch tax).",
                [("site", k, self.dispatch[k][2]) for k in disp])
            fam(lines, "tcr_dispatch_block_seconds_total", "counter",
                "Per-site blocked-on-device seconds.",
                [("site", k, self.dispatch[k][3]) for k in disp])
            fam(lines, "tcr_xla_compiles_total", "counter",
                "XLA backend compiles per stage[shape-bucket].",
                [("stage", k, self.compiles[k][0])
                 for k in sorted(self.compiles)])
            fam(lines, "tcr_xla_compile_seconds_total", "counter",
                "XLA backend compile seconds per stage[shape-bucket].",
                [("stage", k, self.compiles[k][1])
                 for k in sorted(self.compiles)])
            pools = sorted(self.pools)
            fam(lines, "tcr_pool_busy_seconds_total", "counter",
                "Worker-pool busy seconds.",
                [("site", k, self.pools[k][0]) for k in pools])
            fam(lines, "tcr_pool_idle_seconds_total", "counter",
                "Worker-pool idle seconds.",
                [("site", k, self.pools[k][1]) for k in pools])
            fam(lines, "tcr_pool_window_seconds_total", "counter",
                "Worker-pool measurement-window seconds.",
                [("site", k, self.pools[k][2]) for k in pools])
            fam(lines, "tcr_pool_slots", "gauge",
                "Worker-pool slot count.",
                [("site", k, self.pools[k][3]) for k in pools])
            gnodes = sorted(self.graph_nodes)
            fam(lines, "tcr_graph_node_critical_seconds_total", "counter",
                "Per-node critical-path seconds.",
                [("node", k, self.graph_nodes[k][0]) for k in gnodes])
            fam(lines, "tcr_graph_node_overlapped_seconds_total", "counter",
                "Per-node overlapped worker seconds.",
                [("node", k, self.graph_nodes[k][1]) for k in gnodes])
            fam(lines, "tcr_graph_node_runs_total", "counter",
                "Per-node execution counts.",
                [("node", k, self.graph_nodes[k][2]) for k in gnodes])
            fam(lines, "tcr_graph_node_skips_total", "counter",
                "Per-node resume-skip counts.",
                [("node", k, self.graph_nodes[k][3]) for k in gnodes])
            # data-plane families: the edge family carries two labels
            # (edge + direction), so it's rendered by hand — fam() is
            # the single-label helper
            if self.transfers:
                lines.append("# HELP tcr_transfer_site_bytes_total Per-site "
                             "host<->device transfer bytes.")
                lines.append("# TYPE tcr_transfer_site_bytes_total counter")
                for k in sorted(self.transfers):
                    v = self.transfers[k]
                    for direction, b in (("h2d", v[0]), ("d2h", v[2])):
                        if b:
                            lines.append(
                                f'tcr_transfer_site_bytes_total'
                                f'{{site="{prom_label(k)}",'
                                f'direction="{direction}"}} {b:g}')
            if self.edge_transfers:
                lines.append("# HELP tcr_transfer_bytes_total Per-graph-edge "
                             "materialized bytes by direction.")
                lines.append("# TYPE tcr_transfer_bytes_total counter")
                for k in sorted(self.edge_transfers):
                    v = self.edge_transfers[k]
                    lines.append(
                        f'tcr_transfer_bytes_total{{edge="{prom_label(k)}",'
                        f'direction="{prom_label(v[2])}"}} {v[0]:g}')
                lines.append("# HELP tcr_host_round_trip_bytes_total Bytes "
                             "that left the device and came back (graftcheck "
                             "round-trip edges).")
                lines.append("# TYPE tcr_host_round_trip_bytes_total counter")
                lines.append(
                    f"tcr_host_round_trip_bytes_total {self._round_trip[0]:g}")
            hnodes = sorted(self.node_hbm)
            fam(lines, "tcr_node_hbm_delta_bytes", "gauge",
                "Per-node measured HBM delta (bytes-in-use change across "
                "the node's executions).",
                [("node", k, self.node_hbm[k][0]) for k in hnodes])
            fam(lines, "tcr_node_hbm_end_bytes", "gauge",
                "Per-node measured HBM high-water at node exit.",
                [("node", k, self.node_hbm[k][1]) for k in hnodes])
            return lines


def prom_label(value: str) -> str:
    """Escape a Prometheus label VALUE (exposition format: backslash,
    double quote and newline must be escaped inside the quotes)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# Every table of MetricsRegistry is guarded by its _lock.


# --- process-wide armed registry (same discipline as the watchdog) ----------
#
# Under a jobscope (the slice-packed runner pool) a run's arm() binds its
# registry THREAD-LOCALLY: each resident tenant job rolls its own
# telemetry.json while the daemon's process-global registry keeps serving
# /metrics undisturbed. A scoped job whose telemetry is off (or that has
# already disarmed) falls back to the daemon registry — exactly the
# sharing a serial daemon had.

_ARMED: MetricsRegistry | None = None


def _current() -> MetricsRegistry | None:
    reg = jobscope.get("metrics")
    if reg is not None:
        return reg
    return _ARMED


def arm() -> MetricsRegistry:
    global _ARMED
    reg = MetricsRegistry()
    if jobscope.active():
        jobscope.set("metrics", reg)
        return reg
    _ARMED = reg
    return reg


def disarm() -> None:
    global _ARMED
    if jobscope.active():
        jobscope.set("metrics", None)
        return
    _ARMED = None


def armed() -> bool:
    return _current() is not None


def registry() -> MetricsRegistry | None:
    return _current()


def global_registry() -> MetricsRegistry | None:
    """The process-global armed registry, ignoring any jobscope binding.

    Daemon-plane objects (the slice allocator) plant here even when the
    calling thread happens to be inside a tenant job's scope — the mesh
    degrade hook runs the quarantine on the job's own thread, and those
    gauges/counters must reach the daemon's /metrics, not the tenant's
    per-run telemetry.json."""
    return _ARMED


def counter_add(site: str, n: float = 1) -> None:
    """Count ``n`` at ``site``; free no-op when telemetry is off."""
    reg = _current()
    if reg is not None:
        reg.counter_add(site, n)


def gauge_max(site: str, value: float) -> None:
    """Record a high-water observation; free no-op when telemetry is off."""
    reg = _current()
    if reg is not None:
        reg.gauge_max(site, value)


def observe(site: str, value: float) -> None:
    """Record a histogram observation; free no-op when telemetry is off."""
    reg = _current()
    if reg is not None:
        reg.observe(site, value)


def gauge_set(site: str, value: float) -> None:
    """Record a live (last-value) gauge; free no-op when telemetry is off."""
    reg = _current()
    if reg is not None:
        reg.gauge_set(site, value)


def reject_add(reason: str, n: float = 1) -> None:
    """Count a serve-plane rejection under ``reason``; free no-op when
    telemetry is off. The argument is a label value, not an OBS_SITES
    site — the per-site serve.rejected counter is planted separately."""
    reg = _current()
    if reg is not None:
        reg.reject_add(reason, n)


def mesh_slice_set(slice_id: str, busy: float) -> None:
    """Record a mesh slice's busy fraction (``tcr_mesh_slice_busy``);
    free no-op when telemetry is off. The argument is a label value
    (device id), not an OBS_SITES site — the mesh.slice_busy gauge is
    planted separately (parallel/mesh.py ``mark_mesh_slices``)."""
    reg = _current()
    if reg is not None:
        reg.mesh_slice_set(slice_id, busy)


def mesh_degraded_add(site: str, n: float = 1) -> None:
    """Count a degraded-mesh re-execution under the fault site that
    caused it (``tcr_mesh_degraded_total``); free no-op when telemetry
    is off. The argument is a label value, not an OBS_SITES site — the
    mesh.degraded counter is planted separately (graph/executor.py)."""
    reg = _current()
    if reg is not None:
        reg.mesh_degraded_add(site, n)


def slice_tenant_set(slice_id: str, tenant: str) -> None:
    """Record which tenant job occupies a mesh slice (the tenant label
    on ``tcr_mesh_slice_busy``); free no-op when telemetry is off. Both
    arguments are label values, not OBS_SITES sites — the serve.slice
    ring event is planted separately (serve/slices.py)."""
    reg = _current()
    if reg is not None:
        reg.slice_tenant_set(slice_id, tenant)


def slice_quarantine_add(slice_id: str, n: float = 1) -> None:
    """Count a serve-plane slice quarantine
    (``tcr_slice_quarantined_total``); free no-op when telemetry is off.
    The argument is a label value (device id), not an OBS_SITES site."""
    reg = _current()
    if reg is not None:
        reg.slice_quarantine_add(slice_id, n)


def graph_node_add(name: str, *, critical_s: float = 0.0,
                   overlapped_s: float = 0.0) -> None:
    """Record one graph-node execution (critical-path seconds vs seconds
    spent on a worker thread); free no-op when telemetry is off."""
    reg = _current()
    if reg is not None:
        reg.graph_node_add(name, critical_s=critical_s,
                           overlapped_s=overlapped_s)


def graph_node_skip(name: str) -> None:
    """Record a resume skip of a graph node; free no-op when off."""
    reg = _current()
    if reg is not None:
        reg.graph_node_skip(name)


def graph_edge_set(name: str, placement: str) -> None:
    """Record a graph edge's declared placement; free no-op when off."""
    reg = _current()
    if reg is not None:
        reg.graph_edge_set(name, placement)


def graph_node_declare(name: str, *, inputs=None, outputs=None,
                       units: int | None = None) -> None:
    """Record a graph node's declared edges / evaluated workload units
    into the telemetry graph section; free no-op when telemetry is off."""
    reg = _current()
    if reg is not None:
        reg.graph_node_declare(name, inputs=inputs, outputs=outputs,
                               units=units)


def pool_add(site: str, *, busy_s: float = 0.0, idle_s: float = 0.0,
             window_s: float = 0.0, slots: int = 0) -> None:
    """Record a worker pool's busy/idle split; free no-op when off."""
    reg = _current()
    if reg is not None:
        reg.pool_add(site, busy_s=busy_s, idle_s=idle_s, window_s=window_s,
                     slots=slots)


def analysis_set(name: str, summary: dict) -> None:
    """Record a static-analyzer verdict summary (graftcheck) into the
    telemetry artifact; free no-op when telemetry is off."""
    reg = _current()
    if reg is not None:
        reg.analysis_set(name, summary)
