"""Cross-run history ledger: append-only per-run perf/telemetry entries.

Within-run telemetry (telemetry.json) answers *where this run spent its
time*; it cannot answer *did the last change help* — every run's numbers
evaporate with the run directory. This module persists one compact JSON
line per run into an append-only ledger:

- ``<nano_tcr>/history.jsonl`` — always, from the run roll-up path
  (pipeline/run.py) whenever telemetry is armed;
- an opt-in cross-run ledger (``history_ledger`` config knob) — the
  baseline pool a perf gate compares against.

Entries are keyed by **git sha** (what code ran), **config fingerprint**
(a stable hash of the resolved RunConfig minus pure filesystem-location
keys — the same workload run from a different directory must land in the
same baseline pool), **backend** and **n_reads** (what workload ran on
what hardware). The gate compares a run only against entries agreeing on
fingerprint/backend/n_reads, using median + MAD so one noisy historical
sample cannot fail a healthy run.

Contracts, matching the repo's artifact discipline:

- **never-crash**: :func:`read_entries` degrades garbage/torn lines to
  named problems and keeps the readable rest; :func:`record_run` never
  fails the run it records.
- **bounded**: :func:`append_entry` rotates the file down to the newest
  ``max_entries`` lines, so a long-lived ledger cannot grow unbounded.
- **torch-free**: nothing here imports torch (:func:`detect_backend` only
  reads an already-imported module), so ``--report`` works on a host
  whose card is wedged.

A copy of the JAX package's ``obs/history.py``: the same entry schema and
gates, and the same fingerprint for the same config. ``backend`` is the
run's device type, ``"cuda"`` or ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

SCHEMA_VERSION = 1
HISTORY_BASENAME = "history.jsonl"
DEFAULT_MAX_ENTRIES = 512

#: resolved-config keys excluded from the fingerprint: pure filesystem
#: locations (and the ledger path itself) never change the computation,
#: only where it reads/writes — two runs of one workload from different
#: directories or machines must share a baseline pool
FINGERPRINT_EXCLUDED_KEYS = frozenset({
    "reference_file",
    "fastq_pass_dir",
    "nanopore_tcr_seq_primers_fasta",
    "profile_trace_dir",
    "history_ledger",
    # observation endpoints, not workload knobs: a live-armed run must
    # share a baseline pool (and /progress ETA priors) with a live-off
    # run of the same workload
    "live_port",
    # executable-cache location and daemon-mode serving knobs: where
    # compiled programs persist and how deep the serve queue is never
    # change the computation — a job run through the warm daemon must
    # share a baseline pool with the same workload run one-shot
    "compile_cache_dir",
    "serve_queue_max",
    "serve_prewarm",
    "serve_workers",
})

#: MAD -> sigma-equivalent scale for normally-distributed noise
MAD_SCALE = 1.4826


# --- keys ---------------------------------------------------------------------


def config_fingerprint(cfg) -> str:
    """Stable hash of the resolved config (RunConfig or plain dict).

    Every perf-relevant knob participates (batch sizes, executor, chaos,
    polish method, ...); only the :data:`FINGERPRINT_EXCLUDED_KEYS` path
    knobs are dropped. 16 hex chars: collision-safe for a ledger, short
    enough to eyeball-diff in a JSON line.
    """
    d = cfg if isinstance(cfg, dict) else cfg.to_dict()
    d = {k: v for k, v in d.items() if k not in FINGERPRINT_EXCLUDED_KEYS}
    blob = json.dumps(d, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_sha(cwd: str | None = None) -> str | None:
    """Best-effort ``git rev-parse HEAD`` of the package's repo (or
    ``cwd``); None outside a repo / without git — never raises."""
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5.0,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
        )
    except (OSError, subprocess.SubprocessError):
        return None
    if proc.returncode != 0:
        return None
    return proc.stdout.strip() or None


def mesh_config_str(mesh_shape) -> str | None:
    """Canonical ledger spelling of a mesh shape: ``"data=4"`` /
    ``"data=4,model=2"`` (axis order as declared); None for no mesh.
    A plain string so ledger entries compare by equality in
    :func:`matching_entries` without dict-ordering worries."""
    if not mesh_shape:
        return None
    return ",".join(f"{k}={v}" for k, v in dict(mesh_shape).items())


def detect_backend() -> str | None:
    """The process's device type without importing torch: ``"cuda"`` once
    the process has initialized CUDA, else ``"cpu"``; None when torch was
    never loaded, so the torch-free consumers (--report) stay torch-free.
    A run passes its own device to :func:`record_run` instead."""
    mod = sys.modules.get("torch")
    if mod is None:
        return None
    try:
        return "cuda" if mod.cuda.is_initialized() else "cpu"
    except Exception:
        return None


# --- entries ------------------------------------------------------------------


def build_entry(source: str, telemetry: dict | None = None, *,
                fingerprint: str | None = None, sha: str | None = None,
                backend: str | None = None, n_reads: int | None = None,
                reads_per_sec: float | None = None,
                warmup_s: float | None = None,
                steady_s: float | None = None,
                extra: dict | None = None) -> dict:
    """One ledger entry. ``telemetry`` is a telemetry.json-shaped summary
    (obs.metrics.MetricsRegistry.summary()); the entry keeps only the
    trend-worthy roll-up, not the full per-site tables.

    ``warmup_s``/``steady_s`` split one-time cost (daemon start + AOT
    prewarm + first-job compiles; bench's untimed warm pass) from the
    repeatable per-job seconds, so the serve cold-start goal is
    ledger-tracked separately from throughput and the perf gate can guard
    either. Omitted (None) on entries without a warm/steady split."""
    entry: dict = {
        "schema": SCHEMA_VERSION,
        "t_wall": round(time.time(), 3),
        "source": source,
        "git_sha": sha,
        "fingerprint": fingerprint,
        "backend": backend,
        "n_reads": n_reads,
        "reads_per_sec": reads_per_sec,
    }
    if warmup_s is not None:
        entry["warmup_s"] = round(float(warmup_s), 3)
    if steady_s is not None:
        entry["steady_s"] = round(float(steady_s), 3)
    if telemetry:
        disp = telemetry.get("dispatch") or {}
        comp = telemetry.get("compile") or {}
        gauges = telemetry.get("gauges") or {}
        entry.update({
            "duration_s": telemetry.get("duration_s"),
            "stages": {
                k: v.get("seconds")
                for k, v in (telemetry.get("stages") or {}).items()
                if isinstance(v, dict)
            },
            "dispatch_host_s": round(sum(
                d.get("host_s", 0.0) for d in disp.values()
                if isinstance(d, dict)
            ), 3),
            "dispatch_block_s": round(sum(
                d.get("block_s", 0.0) for d in disp.values()
                if isinstance(d, dict)
            ), 3),
            "compile_count": comp.get("count", 0),
            "compile_s": comp.get("seconds", 0.0),
            "hbm_high_water_bytes": gauges.get("device.hbm_bytes_in_use"),
            "peak_host_rss_bytes": gauges.get("host.rss_bytes"),
        })
        # static-analyzer verdict (additive schema: older readers and the
        # perf gate ignore unknown keys; see test_history garbage test)
        analysis = telemetry.get("analysis") or {}
        if isinstance(analysis, dict) and "graftcheck" in analysis:
            entry["graftcheck"] = analysis["graftcheck"]
        # device data-plane roll-up (additive): total h2d/d2h bytes, the
        # round-trip budget the transfer gate holds the line on, and the
        # per-edge donation verdicts — pre-upgrade entries simply lack
        # these keys and stay valid baselines (evaluate_bytes_gate warns)
        transfers = telemetry.get("transfers")
        if isinstance(transfers, dict):
            sites = transfers.get("sites")
            if isinstance(sites, dict):
                entry["transfer_bytes"] = {
                    "h2d": sum(s.get("h2d_bytes", 0) for s in sites.values()
                               if isinstance(s, dict)),
                    "d2h": sum(s.get("d2h_bytes", 0) for s in sites.values()
                               if isinstance(s, dict)),
                }
            hrt = transfers.get("host_round_trip_bytes")
            if isinstance(hrt, (int, float)) and not isinstance(hrt, bool):
                entry["host_round_trip_bytes"] = int(hrt)
            donation = transfers.get("donation")
            if isinstance(donation, dict) and donation:
                entry["donation"] = {
                    k: v.get("verdict") for k, v in sorted(donation.items())
                    if isinstance(v, dict)
                }
        # executed-graph per-node seconds (additive): the stage roll-up
        # above loses the executor's critical/overlapped attribution, so
        # the critical-path analyzer and the live plane's /progress ETA
        # priors (obs/live.load_node_priors) would otherwise disagree on
        # what a node costs. Seconds/units are summed over the run's
        # libraries; `runs` lets readers recover per-execution pace.
        graph = telemetry.get("graph")
        gnodes = graph.get("nodes") if isinstance(graph, dict) else None
        if isinstance(gnodes, dict):
            nodes = {}
            for name, g in gnodes.items():
                if isinstance(g, dict) and g.get("runs"):
                    nodes[name] = {
                        "s": g.get("critical_s", 0.0),
                        "overlapped_s": g.get("overlapped_s", 0.0),
                        "runs": g.get("runs", 1),
                        "units": g.get("units", 0),
                    }
            if nodes:
                entry["nodes"] = nodes
    if extra:
        entry.update(extra)
    return entry


def append_entry(path: str, entry: dict,
                 max_entries: int = DEFAULT_MAX_ENTRIES) -> None:
    """Append one JSON line; rotate down to the newest ``max_entries``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(entry, sort_keys=True,
                            separators=(",", ":")) + "\n")
    _rotate(path, max_entries)


def _rotate(path: str, max_entries: int) -> None:
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return
    if len(lines) <= max_entries:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.writelines(lines[-max_entries:])
    os.replace(tmp, path)


def read_entries(path: str) -> tuple[list[dict], list[str]]:
    """(entries, problems). Garbage/torn lines become named problems and
    are dropped; the readable rest survives — a half-written final line
    (the process died mid-append) must not take the whole history down."""
    try:
        with open(path) as fh:
            raw = fh.read()
    except OSError as exc:
        return [], [f"unreadable ledger {path}: {exc!r}"]
    entries: list[dict] = []
    problems: list[str] = []
    for i, line in enumerate(raw.splitlines(), 1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            problems.append(f"line {i}: not valid JSON (torn or garbage "
                            "entry dropped)")
            continue
        if not isinstance(obj, dict):
            problems.append(f"line {i}: not a JSON object (dropped)")
            continue
        entries.append(obj)
    return entries, problems


# --- the regression gate ------------------------------------------------------


@dataclasses.dataclass
class GateResult:
    """Outcome of one gate evaluation; ``status`` drives the exit code
    (fail -> nonzero), everything else is the explanation."""

    status: str  # "pass" | "warn" | "fail"
    reason: str
    metric: str | None = None
    current: float | None = None
    baseline_median: float | None = None
    baseline_mad: float | None = None
    allowance: float | None = None
    n_baseline: int = 0


def matching_entries(entries: list[dict], current: dict) -> list[dict]:
    """Baseline pool: entries agreeing with ``current`` on fingerprint,
    backend, n_reads and mesh_config (``current`` itself excluded by
    identity, so gating the ledger's own latest entry works).

    ``mesh_config`` compares via ``.get()`` on both sides: legacy entries
    (written before sharded execution) and single-device runs both lack
    the key, so they pool together — a ``--mesh data=N`` arm's throughput
    only ever gates against the same mesh shape, never against the
    single-device baseline it is allowed to beat or trail."""
    keys = ("fingerprint", "backend", "n_reads", "mesh_config")
    return [e for e in entries
            if e is not current
            and all(e.get(k) == current.get(k) for k in keys)]


def _median(values: list[float]) -> float:
    s = sorted(values)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def _metric_of(entry: dict) -> tuple[str | None, float | None]:
    """Preferred gate metric of one entry: reads_per_sec (higher better,
    bench entries) else duration_s (lower better, run entries)."""
    for name in ("reads_per_sec", "duration_s"):
        v = entry.get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0:
            return name, float(v)
    return None, None


def evaluate_gate(entries: list[dict], current: dict, *,
                  rel_threshold: float = 0.15, mad_k: float = 4.0,
                  min_samples: int = 3) -> GateResult:
    """Noise-aware regression verdict for ``current`` vs the ledger.

    The allowance is ``max(rel_threshold * median, mad_k * 1.4826 * MAD)``
    over the matching baseline samples: a quiet baseline gates at the
    relative threshold, a noisy one widens to what its own scatter
    justifies — one flaky historical sample cannot fail a healthy run,
    and a machine with inherently noisy timings self-calibrates. Fewer
    than ``min_samples`` usable baselines -> ``warn`` (recorded, not
    gated): a thin ledger must not fail CI on a fresh machine.
    """
    mname, cur = _metric_of(current)
    if mname is None:
        return GateResult(
            "warn", "current entry has no usable metric "
            "(reads_per_sec/duration_s missing or non-positive) — not gated",
        )
    values = [v for e in matching_entries(entries, current)
              for name, v in (_metric_of(e),) if name == mname]
    if len(values) < min_samples:
        return GateResult(
            "warn",
            f"thin ledger: {len(values)} matching baseline sample(s) < "
            f"min_samples={min_samples} — recorded, not gated",
            metric=mname, current=cur, n_baseline=len(values),
        )
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    allowance = max(rel_threshold * med, mad_k * MAD_SCALE * mad)
    if mname == "duration_s":
        regressed = cur > med + allowance
        side = "above"
    else:
        regressed = cur < med - allowance
        side = "below"
    detail = (f"{mname}={cur:.3f} vs baseline median {med:.3f} "
              f"(MAD {mad:.3f}, allowance {allowance:.3f}, "
              f"{len(values)} sample(s))")
    if regressed:
        return GateResult(
            "fail", f"regression: {detail} — current is {side} the "
            "noise allowance", metric=mname, current=cur,
            baseline_median=med, baseline_mad=mad, allowance=allowance,
            n_baseline=len(values),
        )
    return GateResult(
        "pass", f"within noise allowance: {detail}", metric=mname,
        current=cur, baseline_median=med, baseline_mad=mad,
        allowance=allowance, n_baseline=len(values),
    )


def _bytes_of(entry: dict, metric: str) -> float | None:
    """A byte metric of one entry; unlike :func:`_metric_of`, zero is a
    valid (ideal) value — a baseline of 0 round-trip bytes must gate."""
    v = entry.get(metric)
    if isinstance(v, (int, float)) and not isinstance(v, bool) and v >= 0:
        return float(v)
    return None


def evaluate_bytes_gate(entries: list[dict], current: dict, *,
                        metric: str = "host_round_trip_bytes",
                        rel_threshold: float = 0.15, mad_k: float = 4.0,
                        min_samples: int = 3,
                        abs_budget: float | None = None) -> GateResult:
    """Lower-is-better byte gate over a ledger byte metric (the data-plane
    twin of :func:`evaluate_gate`; same median+MAD allowance).

    Pre-upgrade ledger entries simply lack the byte fields: they are
    skipped (never a crash), and a pool left thinner than ``min_samples``
    degrades to ``warn`` — a legacy ledger stays a valid baseline for the
    timing gate without blocking CI on the new metric. The fail reason
    carries measured vs allowed bytes, so a reintroduced host round-trip
    is a sized finding.

    ``abs_budget`` switches the gate to an absolute ceiling that needs no
    ledger history at all: the production data plane is device-resident,
    so the budget is ~0 bytes and ANY measured round-trip fails
    deterministically — including on a fresh machine whose ledger is too
    thin for the relative gate to arm.
    """
    cur = _bytes_of(current, metric)
    if cur is None:
        return GateResult(
            "warn", f"current entry has no {metric} field (pre-upgrade "
            "telemetry or telemetry off) — not gated", metric=metric,
        )
    if abs_budget is not None:
        if cur > abs_budget:
            return GateResult(
                "fail",
                f"data-plane regression: {metric}={cur:.0f} B vs allowed "
                f"{abs_budget:.0f} B (absolute budget) — "
                f"{cur - abs_budget:.0f} B of new host round-trip traffic",
                metric=metric, current=cur, allowance=float(abs_budget),
            )
        return GateResult(
            "pass", f"within absolute budget: {metric}={cur:.0f} B vs "
            f"allowed {abs_budget:.0f} B", metric=metric, current=cur,
            allowance=float(abs_budget),
        )
    pool = matching_entries(entries, current)
    values = [v for e in pool
              for v in (_bytes_of(e, metric),) if v is not None]
    legacy = len(pool) - len(values)
    if len(values) < min_samples:
        return GateResult(
            "warn",
            f"thin ledger: {len(values)} matching baseline sample(s) with "
            f"{metric} < min_samples={min_samples}"
            + (f" ({legacy} legacy entrie(s) without the field skipped)"
               if legacy else "")
            + " — recorded, not gated",
            metric=metric, current=cur, n_baseline=len(values),
        )
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    allowance = max(rel_threshold * med, mad_k * MAD_SCALE * mad)
    allowed = med + allowance
    detail = (f"{metric}={cur:.0f} B vs allowed {allowed:.0f} B "
              f"(baseline median {med:.0f} B, MAD {mad:.0f}, allowance "
              f"{allowance:.0f} B, {len(values)} sample(s)"
              + (f", {legacy} legacy skipped" if legacy else "") + ")")
    if cur > allowed:
        return GateResult(
            "fail", f"data-plane regression: {detail} — "
            f"{cur - allowed:.0f} B of new host round-trip traffic",
            metric=metric, current=cur, baseline_median=med,
            baseline_mad=mad, allowance=allowance, n_baseline=len(values),
        )
    return GateResult(
        "pass", f"within byte allowance: {detail}", metric=metric,
        current=cur, baseline_median=med, baseline_mad=mad,
        allowance=allowance, n_baseline=len(values),
    )


def _load_metric(entry: dict, metric: str) -> float | None:
    """A serve_load SLO metric of one entry; zero is valid (an idle p99
    wait of 0s must gate)."""
    v = entry.get(metric)
    if isinstance(v, (int, float)) and not isinstance(v, bool) and v >= 0:
        return float(v)
    return None


def evaluate_load_gate(entries: list[dict], current: dict | None = None, *,
                       rel_threshold: float = 0.15, mad_k: float = 4.0,
                       min_samples: int = 3) -> GateResult:
    """Serving-SLO regression verdict over ``source:"serve_load"``
    entries: p99 job wait (lower is better) and sustained reads_per_sec
    (higher is better), each under the same median+MAD noise allowance
    as :func:`evaluate_gate`.

    ``current=None`` gates the NEWEST serve_load entry against the rest
    (the perf-gate CLI path, where the latest ledger entry is usually a
    run/bench entry); a ledger with no serve_load history degrades to
    ``warn`` — the load gate arms only once a load report has been
    recorded. A ``current`` whose source is not serve_load is never
    load-gated (warn), keeping the verdict additive for existing
    callers. Any gated metric failing fails the gate; otherwise any
    gated metric passing passes it; all-thin stays warn.
    """
    pool = [e for e in entries if isinstance(e, dict)
            and e.get("source") == "serve_load"]
    if current is None:
        if not pool:
            return GateResult(
                "warn", "no serve_load entries in the ledger — load gate "
                "not armed (run scripts/serve_load.py --ledger to record "
                "one)")
        current = pool[-1]
    elif current.get("source") != "serve_load":
        return GateResult(
            "warn", f"current entry source={current.get('source')!r} is "
            "not serve_load — not load-gated")
    baseline = matching_entries(pool, current)
    verdicts: list[GateResult] = []
    for metric, higher_better in (("p99_wait_s", False),
                                  ("reads_per_sec", True)):
        cur = _load_metric(current, metric)
        if cur is None:
            verdicts.append(GateResult(
                "warn", f"current serve_load entry has no {metric} — "
                "not gated", metric=metric))
            continue
        values = [v for e in baseline
                  for v in (_load_metric(e, metric),) if v is not None]
        if len(values) < min_samples:
            verdicts.append(GateResult(
                "warn",
                f"thin ledger: {len(values)} matching serve_load baseline "
                f"sample(s) with {metric} < min_samples={min_samples} — "
                "recorded, not gated",
                metric=metric, current=cur, n_baseline=len(values),
            ))
            continue
        med = _median(values)
        mad = _median([abs(v - med) for v in values])
        allowance = max(rel_threshold * med, mad_k * MAD_SCALE * mad)
        if higher_better:
            regressed = cur < med - allowance
            side = "below"
        else:
            regressed = cur > med + allowance
            side = "above"
        detail = (f"{metric}={cur:.3f} vs baseline median {med:.3f} "
                  f"(MAD {mad:.3f}, allowance {allowance:.3f}, "
                  f"{len(values)} sample(s))")
        if regressed:
            verdicts.append(GateResult(
                "fail", f"serving regression: {detail} — current is "
                f"{side} the noise allowance", metric=metric, current=cur,
                baseline_median=med, baseline_mad=mad, allowance=allowance,
                n_baseline=len(values),
            ))
        else:
            verdicts.append(GateResult(
                "pass", f"within noise allowance: {detail}", metric=metric,
                current=cur, baseline_median=med, baseline_mad=mad,
                allowance=allowance, n_baseline=len(values),
            ))
    for v in verdicts:
        if v.status == "fail":
            return v
    passes = [v for v in verdicts if v.status == "pass"]
    joined = "; ".join(v.reason for v in verdicts)
    if passes:
        return dataclasses.replace(passes[0], reason=joined)
    return GateResult(
        "warn", joined,
        n_baseline=max((v.n_baseline for v in verdicts), default=0))


# --- the run roll-up hook -----------------------------------------------------


def record_run(nano_dir: str, cfg, *, suffix: str = "",
               backend: str | None = None) -> dict | None:
    """Append this run's entry to ``<nano_dir>/history<suffix>.jsonl``
    (plus ``cfg.history_ledger`` when set) from the armed registry.
    ``backend`` is the run's device type (default :func:`detect_backend`).

    Called from the run roll-up finally-block right after the telemetry
    write; like every telemetry path it must never fail the run it
    records — any trouble degrades to a stderr warning.
    """
    try:
        from ont_tcrconsensus_tpu_torch.obs import metrics

        reg = metrics.registry()
        if reg is None:
            return None
        mesh_shape = getattr(cfg, "mesh_shape", None)
        entry = build_entry(
            "run", reg.summary(),
            fingerprint=config_fingerprint(cfg),
            sha=git_sha(), backend=backend or detect_backend(),
            # per-mesh-config scaling entries: "data=2,model=2" — absent
            # (not null) on single-device runs so they pool with legacy
            # baselines in matching_entries
            extra=({"mesh_config": mesh_config_str(mesh_shape)}
                   if mesh_shape else None),
        )
        name = f"history{suffix}.jsonl" if suffix else HISTORY_BASENAME
        append_entry(os.path.join(nano_dir, name), entry)
        ledger = getattr(cfg, "history_ledger", None)
        if ledger:
            append_entry(ledger, entry)
        return entry
    except Exception as exc:
        sys.stderr.write(
            f"WARNING: could not append run-history entry: {exc!r}\n")
        return None
