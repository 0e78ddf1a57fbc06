"""``telemetry.json`` writer + the ``--report`` artifact renderer.

The writer runs inside the pipeline (pipeline/run.py, next to the
robustness-report write) and rolls the armed registry/collector up into
one machine-readable per-run artifact. The renderer is the inverse: it
reads ONLY committed artifacts — ``telemetry.json``,
``robustness_report.json``, per-library ``stage_timing.tsv``,
``logs/trace.json`` — and prints a human summary. Neither path imports
torch at module scope, and the renderer never imports it at all:
``--report`` must work on a host whose card is wedged (the situation that
makes someone reach for the telemetry).

A copy of the JAX package's ``obs/report.py``: the port's rendering of a
run directory is the JAX renderer's, line for line, so the two packages'
reports compare as text.
"""

from __future__ import annotations

import glob
import json
import os

from ont_tcrconsensus_tpu_torch.obs import critical_path as critical_path_mod
from ont_tcrconsensus_tpu_torch.obs import history as history_mod
from ont_tcrconsensus_tpu_torch.obs import metrics, trace
from ont_tcrconsensus_tpu_torch.obs import transfers as transfers_mod

TELEMETRY_BASENAME = "telemetry.json"
TRACE_RELPATH = os.path.join("logs", "trace.json")


def write_run_telemetry(nano_dir: str, level: str, suffix: str = "") -> str:
    """Roll the armed registry (+ collector at ``full``) into the per-run
    artifacts under ``nano_dir``; returns the telemetry.json path."""
    from ont_tcrconsensus_tpu_torch.robustness import retry

    reg = metrics.registry()
    if reg is None:
        raise RuntimeError("telemetry registry is not armed")
    body = {"telemetry": level, **reg.summary()}
    body["robustness_events"] = {
        site: s["events"] for site, s in sorted(
            retry.recorder().summary().items()
        )
    }
    col = trace.collector()
    trace_rel = None
    if col is not None:
        trace_rel = (TRACE_RELPATH if not suffix
                     else os.path.join("logs", f"trace{suffix}.json"))
        trace_path = os.path.join(nano_dir, trace_rel)
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        col.write(trace_path)
    body["trace_json"] = trace_rel
    path = os.path.join(nano_dir, f"telemetry{suffix}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(body, fh, indent=1)
    os.replace(tmp, path)
    return path


# --- the --report renderer ---------------------------------------------------


def resolve_nano_dir(target: str) -> str | None:
    """Accepts a run-config JSON, a ``fastq_pass`` dir, or the ``nano_tcr``
    dir itself; returns the nano_tcr dir or None."""
    if os.path.isfile(target) and target.endswith(".json"):
        try:
            with open(target) as fh:
                cfg = json.load(fh)
            target = cfg.get("fastq_pass_dir", "")
        except (OSError, ValueError):
            return None
    if not os.path.isdir(target):
        return None
    if (glob.glob(os.path.join(target, "telemetry*.json"))
            or glob.glob(os.path.join(target, "robustness_report*.json"))
            or os.path.basename(os.path.normpath(target)) == "nano_tcr"):
        return target
    child = os.path.join(target, "nano_tcr")
    return child if os.path.isdir(child) else None


def _fmt_bytes(n) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"  # pragma: no cover


def _render_telemetry(data: dict, lines: list[str]) -> None:
    lines.append(f"telemetry level: {data.get('telemetry', '?')}, "
                 f"run duration {data.get('duration_s', 0):.1f}s")
    stages = data.get("stages", {})
    if stages:
        lines.append("stages (critical-path seconds; *_bg ran overlapped):")
        for name, s in stages.items():
            lines.append(f"  {name:28s} {s['seconds']:9.3f}s  "
                         f"x{s['calls']}")
    graph = data.get("graph") or {}
    gnodes = graph.get("nodes", {})
    if gnodes:
        lines.append("stage graph (per-node critical vs overlapped seconds):")
        for name, g in gnodes.items():
            runs, skips = g.get("runs", 0), g.get("skips", 0)
            if runs:
                status = f"x{runs}"
            elif skips:
                status = "resume-skipped"
            else:
                status = "-"
            units = g.get("units")
            lines.append(
                f"  {name:28s} critical {g.get('critical_s', 0.0):8.3f}s  "
                f"overlapped {g.get('overlapped_s', 0.0):8.3f}s  {status}"
                + (f"  ({units} units)" if units else "")
            )
    pool = graph.get("pool") or data.get("overlap_pool")
    if pool:
        lines.append(
            f"overlap pool: busy {pool.get('busy_s', 0.0):.3f}s idle "
            f"{pool.get('idle_s', 0.0):.3f}s across {pool.get('slots')} "
            "worker slot(s)"
        )
    gedges = graph.get("edges", {})
    if gedges:
        lines.append("graph edges (placement): " + ", ".join(
            f"{name}[{placement}]" for name, placement in gedges.items()
        ))
    disp = data.get("dispatch", {})
    if disp:
        lines.append("dispatch sites (host-gap vs blocked-on-device):")
        for site, d in disp.items():
            lines.append(
                f"  {site:28s} {d['dispatches']:5d} dispatches "
                f"{d['gets']:5d} gets  host {d['host_s']:8.3f}s  "
                f"block {d['block_s']:8.3f}s"
            )
    comp = data.get("compile", {})
    lines.append(f"XLA compiles: {comp.get('count', 0)} "
                 f"({comp.get('seconds', 0.0):.1f}s)")
    for label, c in list(comp.get("by_stage", {}).items())[:8]:
        lines.append(f"  {label:28s} {c['count']:4d}  {c['seconds']:.1f}s")
    gauges = data.get("gauges", {})
    lines.append(
        "memory: HBM high-water "
        f"{_fmt_bytes(gauges.get('device.hbm_bytes_in_use'))}, "
        f"peak host RSS {_fmt_bytes(gauges.get('host.rss_bytes'))}"
    )
    transfers = data.get("transfers")
    if transfers is not None:
        # strict indexing on purpose: a garbage transfers section raises
        # into the malformed-artifact handler like every other section
        sites = transfers.get("sites") or {}
        h2d_b = sum(s["h2d_bytes"] for s in sites.values())
        d2h_b = sum(s["d2h_bytes"] for s in sites.values())
        lines.append(
            f"data plane: h2d {_fmt_bytes(h2d_b)}, d2h {_fmt_bytes(d2h_b)} "
            f"across {len(sites)} site(s); host round-trip "
            f"{_fmt_bytes(transfers['host_round_trip_bytes'])}"
        )
        edges = transfers.get("edges") or {}
        for name, e in list(edges.items())[:12]:
            lines.append(
                f"  edge {name:24s} {e['direction']}[{e['placement']}] "
                f"{_fmt_bytes(e['bytes'])} over {e['count']} "
                "materialization(s)"
            )
        donation = transfers.get("donation") or {}
        if donation:
            counts: dict[str, int] = {}
            for d in donation.values():
                counts[d["verdict"]] = counts.get(d["verdict"], 0) + 1
            lines.append("donation verdicts: " + ", ".join(
                f"{k}={counts[k]}" for k in sorted(counts)))
    rob = data.get("robustness_events", {})
    if rob:
        lines.append("robustness events: " + ", ".join(
            f"{site}={n}" for site, n in rob.items()
        ))
    else:
        lines.append("robustness events: none")


def _render_flight_recorder(base: str, rec: dict, lines: list[str]) -> None:
    """Human rendering of one ``logs/flight_recorder*.json`` flush
    (obs/live.py). Raises on a valid-JSON-but-garbage payload — callers
    degrade that to a named problem, matching the telemetry readers."""
    if rec.get("schema") != 1:
        raise ValueError(f"unsupported flight-recorder schema "
                         f"{rec.get('schema')!r}")
    events = rec["events"]
    dropped = int(rec.get("dropped", 0))
    lines.append(
        f"flight recorder {base}: flushed on {rec['reason']!r}, "
        f"{len(events)} buffered event(s)"
        + (f", {dropped} older dropped" if dropped else "")
    )
    for ev in events[-10:]:
        args = ev.get("args")
        lines.append(
            f"  [{ev['kind']:9s}] {ev['name']} "
            f"t+{float(ev['t_s']):.3f}s ({ev.get('thread', '?')})"
            + (f" {args}" if args else "")
        )


def render_report(nano_dir: str, critical_path: bool = False,
                  memory: bool = False) -> tuple[str, int]:
    """(report text, exit code) from the committed artifacts in
    ``nano_dir``. Exit 1 when no telemetry artifact exists. With
    ``critical_path``, each telemetry artifact's executed-graph section is
    additionally run through :mod:`obs.critical_path` (slack / what-if /
    pool efficiency; analysis problems are informational — they name what
    the artifact cannot support, without failing the report). ``memory``
    adds the static-vs-measured HBM reconciliation
    (:func:`obs.transfers.analyze_memory`) under the same contract."""
    lines = [f"run report: {nano_dir}"]
    tele_paths = sorted(glob.glob(os.path.join(nano_dir, "telemetry*.json")))
    tele_paths = [p for p in tele_paths if not p.endswith(".tmp")]
    rc = 0
    if not tele_paths:
        lines.append(
            "no telemetry*.json found — the run predates the telemetry "
            "layer, ran with telemetry=off, or died before roll-up "
            "(robustness/timing artifacts below may still exist)"
        )
        rc = 1
    for path in tele_paths:
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (OSError, ValueError) as exc:
            lines.append(f"unreadable {os.path.basename(path)}: {exc!r}")
            rc = 1
            continue
        if not isinstance(data, dict):
            lines.append(f"malformed telemetry artifact "
                         f"{os.path.basename(path)}: not a JSON object")
            rc = 1
            continue
        if len(tele_paths) > 1:
            lines.append(f"-- {os.path.basename(path)} --")
        try:
            _render_telemetry(data, lines)
        except Exception as exc:
            # never-crash contract (as the manifest readers keep it): a
            # valid-JSON-but-garbage artifact — torn write, hand edit,
            # schema drift — degrades to a named problem, not a traceback
            # on the wedged-host diagnosis path
            lines.append(
                f"malformed telemetry artifact {os.path.basename(path)}: "
                f"{exc!r}"
            )
            rc = 1
            continue
        trace_rel = data.get("trace_json")
        trace_payload = None
        if isinstance(trace_rel, str) and trace_rel:
            tpath = os.path.join(nano_dir, trace_rel)
            try:
                with open(tpath) as fh:
                    trace_payload = json.load(fh)
                if not isinstance(trace_payload, dict):
                    trace_payload = None
                n_events = len((trace_payload or {}).get("traceEvents", []))
                lines.append(f"trace: {trace_rel} ({n_events} events; open "
                             "in chrome://tracing or Perfetto)")
            except (OSError, ValueError) as exc:
                lines.append(f"trace: {trace_rel} unreadable ({exc!r})")
                rc = 1
        else:
            lines.append("trace: none (telemetry=full records one)")
        if critical_path:
            lines.append("-- critical path --")
            critical_path_mod.render(
                critical_path_mod.analyze(data, trace_payload), lines)
        if memory:
            lines.append("-- memory reconciliation --")
            transfers_mod.render_memory(
                transfers_mod.analyze_memory(data), lines)
    for rpath in sorted(glob.glob(
        os.path.join(nano_dir, "robustness_report*.json")
    )):
        try:
            with open(rpath) as fh:
                rep = json.load(fh)
            n_events = len(rep.get("events") or [])
            chaos = rep.get("chaos")
        except (OSError, ValueError, AttributeError, TypeError):
            lines.append(f"unreadable {os.path.basename(rpath)}")
            continue
        lines.append(
            f"{os.path.basename(rpath)}: {n_events} event(s), "
            f"chaos {'armed' if chaos else 'off'}"
        )
    for fpath in sorted(glob.glob(
        os.path.join(nano_dir, "logs", "flight_recorder*.json")
    )):
        base = os.path.basename(fpath)
        try:
            with open(fpath) as fh:
                rec = json.load(fh)
            if not isinstance(rec, dict):
                raise ValueError("not a JSON object")
        except (OSError, ValueError) as exc:
            lines.append(f"unreadable flight recorder {base}: {exc!r}")
            rc = 1
            continue
        try:
            _render_flight_recorder(base, rec, lines)
        except Exception as exc:
            # same never-crash contract as the telemetry readers above
            lines.append(f"malformed flight recorder {base}: {exc!r}")
            rc = 1
    tsvs = sorted(glob.glob(
        os.path.join(nano_dir, "*", "logs", "stage_timing.tsv")
    ))
    if tsvs:
        lines.append(f"per-library stage timing: {len(tsvs)} "
                     "stage_timing.tsv file(s)")
    for hpath in sorted(glob.glob(os.path.join(nano_dir, "history*.jsonl"))):
        entries, problems = history_mod.read_entries(hpath)
        lines.append(
            f"run history: {len(entries)} entrie(s) in "
            f"{os.path.basename(hpath)}"
            + (f", {len(problems)} garbage line(s) skipped" if problems
               else "")
        )
    return "\n".join(lines) + "\n", rc


def collect_report(nano_dir: str, critical_path: bool = False,
                   memory: bool = False) -> tuple[dict, int]:
    """Machine-readable twin of :func:`render_report` (``--report --json``).

    Same resolution rules and exit codes: each telemetry artifact is
    validated through the text renderer's own code path (into a discarded
    scratch buffer), so a valid-JSON-but-garbage artifact yields the same
    named problem + exit 1 in both modes instead of laundering garbage
    into a clean-looking JSON dump.
    """
    out: dict = {"nano_dir": nano_dir, "problems": [], "telemetry": {}}
    rc = 0
    tele_paths = sorted(glob.glob(os.path.join(nano_dir, "telemetry*.json")))
    tele_paths = [p for p in tele_paths if not p.endswith(".tmp")]
    if not tele_paths:
        out["problems"].append(
            "no telemetry*.json found — the run predates the telemetry "
            "layer, ran with telemetry=off, or died before roll-up")
        rc = 1
    if critical_path:
        out["critical_path"] = {}
    if memory:
        out["memory"] = {}
    for path in tele_paths:
        base = os.path.basename(path)
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (OSError, ValueError) as exc:
            out["problems"].append(f"unreadable {base}: {exc!r}")
            rc = 1
            continue
        if not isinstance(data, dict):
            out["problems"].append(
                f"malformed telemetry artifact {base}: not a JSON object")
            rc = 1
            continue
        try:
            _render_telemetry(data, [])  # schema check, text discarded
        except Exception as exc:
            out["problems"].append(
                f"malformed telemetry artifact {base}: {exc!r}")
            rc = 1
            continue
        out["telemetry"][base] = data
        trace_rel = data.get("trace_json")
        trace_payload = None
        if isinstance(trace_rel, str) and trace_rel:
            try:
                with open(os.path.join(nano_dir, trace_rel)) as fh:
                    trace_payload = json.load(fh)
                if not isinstance(trace_payload, dict):
                    trace_payload = None
            except (OSError, ValueError) as exc:
                out["problems"].append(f"trace {trace_rel} unreadable "
                                       f"({exc!r})")
                rc = 1
        if critical_path:
            out["critical_path"][base] = critical_path_mod.analyze(
                data, trace_payload)
        if memory:
            out["memory"][base] = transfers_mod.analyze_memory(data)
    robustness: dict = {}
    for rpath in sorted(glob.glob(
        os.path.join(nano_dir, "robustness_report*.json")
    )):
        base = os.path.basename(rpath)
        try:
            with open(rpath) as fh:
                rep = json.load(fh)
            robustness[base] = {"events": len(rep.get("events") or []),
                                "chaos": bool(rep.get("chaos"))}
        except (OSError, ValueError, AttributeError, TypeError):
            robustness[base] = {"problem": "unreadable"}
    out["robustness_reports"] = robustness
    flights: dict = {}
    for fpath in sorted(glob.glob(
        os.path.join(nano_dir, "logs", "flight_recorder*.json")
    )):
        base = os.path.basename(fpath)
        try:
            with open(fpath) as fh:
                rec = json.load(fh)
            if not isinstance(rec, dict):
                raise ValueError("not a JSON object")
            _render_flight_recorder(base, rec, [])  # schema check only
        except (OSError, ValueError) as exc:
            out["problems"].append(f"unreadable flight recorder {base}: "
                                   f"{exc!r}")
            rc = 1
            continue
        except Exception as exc:
            out["problems"].append(f"malformed flight recorder {base}: "
                                   f"{exc!r}")
            rc = 1
            continue
        flights[base] = rec
    out["flight_recorders"] = flights
    out["stage_timing_tsvs"] = len(glob.glob(
        os.path.join(nano_dir, "*", "logs", "stage_timing.tsv")))
    hist: dict = {}
    for hpath in sorted(glob.glob(os.path.join(nano_dir, "history*.jsonl"))):
        entries, problems = history_mod.read_entries(hpath)
        hist[os.path.basename(hpath)] = {
            "entries": len(entries), "problems": problems,
            "last": entries[-1] if entries else None,
        }
    out["history"] = hist
    return out, rc


def report_main(target: str, as_json: bool = False,
                critical_path: bool = False, memory: bool = False) -> int:
    """CLI body for ``python -m ont_tcrconsensus_tpu_torch --report <workdir>``."""
    import sys

    nano = resolve_nano_dir(target)
    if nano is None:
        msg = (f"--report: no run directory found at {target!r} (expected a "
               "run-config JSON, a fastq_pass dir, or its nano_tcr subdir)")
        print(msg, file=sys.stderr)
        if as_json:
            json.dump({"problems": [msg]}, sys.stdout)
            sys.stdout.write("\n")
        return 2
    if as_json:
        data, rc = collect_report(nano, critical_path=critical_path,
                                  memory=memory)
        json.dump(data, sys.stdout, indent=1)
        sys.stdout.write("\n")
        return rc
    text, rc = render_report(nano, critical_path=critical_path, memory=memory)
    sys.stdout.write(text)
    return rc
