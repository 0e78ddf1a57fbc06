"""Critical-path analysis over the executed-graph telemetry section.

A copy of the JAX package's ``obs/critical_path.py``. The telemetry
``graph`` section records what each node cost (``critical_s`` /
``overlapped_s``), each node's declared ``inputs``/``outputs`` edges,
``units``, and the overlap pool's busy/idle split: enough to rebuild the
executed DAG afterwards and answer *which node to attack next*. The
port's runs have no ``graph`` section until its graph executor lands;
their artifacts then render as named problems.

:func:`analyze` computes, from a telemetry.json dict (plus optionally the
Chrome-trace dict for observed wall windows):

- the **critical path** (longest chain of node critical seconds through
  the dependency DAG) and its length;
- per-node **slack** (how much a node could grow before extending the
  run) and an on-critical-path flag;
- **what-if** estimates: how much the critical path shrinks if a given
  node were free — the honest version of "node X takes Y seconds",
  because shortening an overlapped or slack-rich node saves nothing;
- the per-node **dispatch-tax rollup** (host-gap vs blocked-on-device
  seconds from the ``dispatch_by_stage`` table, worker ``_bg`` spans
  folded into their node);
- **overlap-pool efficiency** (worker busy vs idle seconds).

Never-crash contract (cf. the --report renderer and manifest readers):
valid-JSON-but-garbage input degrades to named strings in the returned
``problems`` list — this module raises nothing and imports neither torch
nor anything that does, so it works on a host whose card is wedged.
"""

from __future__ import annotations


def _num(value, default: float = 0.0) -> float | None:
    """float(value) when it is a usable non-negative number, else None."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return float(value) if value >= 0 else None


def _toposort(preds: dict[str, list[str]]) -> list[str] | None:
    """Kahn with name tie-break (stable output); None on a cycle."""
    indeg = {n: len(preds[n]) for n in preds}
    consumers: dict[str, list[str]] = {n: [] for n in preds}
    for n, ps in preds.items():
        for p in ps:
            consumers[p].append(n)
    ready = sorted(n for n, d in indeg.items() if d == 0)
    order: list[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for c in consumers[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
        ready.sort()
    return order if len(order) == len(preds) else None


def _merge_dispatch(*rows) -> dict | None:
    out = {"dispatches": 0, "gets": 0, "host_s": 0.0, "block_s": 0.0}
    seen = False
    for row in rows:
        if not isinstance(row, dict):
            continue
        seen = True
        for key in out:
            v = _num(row.get(key, 0))
            if v is not None:
                out[key] += v
    if not seen:
        return None
    return {"dispatches": int(out["dispatches"]), "gets": int(out["gets"]),
            "host_s": round(out["host_s"], 3),
            "block_s": round(out["block_s"], 3)}


def _trace_windows(trace: dict, node_names: set[str],
                   problems: list[str]) -> dict | None:
    """Observed per-node wall windows from Chrome-trace X events (node
    spans plus their ``_bg`` worker spans), in seconds from the earliest
    matching span — the realized schedule the DAG math predicts."""
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        problems.append("trace has no traceEvents list — skipping the "
                        "span join")
        return None
    windows: dict[str, list[float]] = {}
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        name = ev.get("name")
        if not isinstance(name, str):
            continue
        base = name[:-3] if name.endswith("_bg") else name
        if base not in node_names:
            continue
        ts, dur = _num(ev.get("ts")), _num(ev.get("dur"))
        if ts is None or dur is None:
            continue
        w = windows.setdefault(base, [ts, ts + dur])
        w[0] = min(w[0], ts)
        w[1] = max(w[1], ts + dur)
    if not windows:
        return None
    t0 = min(w[0] for w in windows.values())
    t1 = max(w[1] for w in windows.values())
    return {
        # trace timestamps are microseconds (Chrome trace-event format)
        "makespan_s": round((t1 - t0) / 1e6, 3),
        "node_windows_s": {
            k: [round((w[0] - t0) / 1e6, 3), round((w[1] - t0) / 1e6, 3)]
            for k, w in sorted(windows.items())
        },
    }


def analyze(telemetry: dict, trace: dict | None = None) -> dict:
    """Critical-path report dict from a telemetry.json payload.

    Always returns a dict with a ``problems`` list; the DAG keys
    (``critical_path``, ``nodes``, ...) appear only when the artifact
    carries enough structure to compute them.
    """
    out: dict = {"problems": []}
    problems: list[str] = out["problems"]
    graph = telemetry.get("graph") if isinstance(telemetry, dict) else None
    if not isinstance(graph, dict):
        problems.append(
            "no executed-graph section in telemetry (imperative run, "
            "telemetry=off, or an artifact predating the graph executor)")
        return out
    raw_nodes = graph.get("nodes")
    if not isinstance(raw_nodes, dict) or not raw_nodes:
        problems.append("graph section has no nodes object")
        return out

    nodes: dict[str, dict] = {}
    producer: dict[str, str] = {}
    have_deps = False
    for name, g in raw_nodes.items():
        if not isinstance(g, dict):
            problems.append(f"node {name!r}: entry is not an object (dropped)")
            continue
        crit = _num(g.get("critical_s", 0.0))
        if crit is None:
            problems.append(f"node {name!r}: bad critical_s "
                            f"{g.get('critical_s')!r} (treated as 0)")
            crit = 0.0
        over = _num(g.get("overlapped_s", 0.0)) or 0.0
        ins, outs = g.get("inputs"), g.get("outputs")
        if ins is not None or outs is not None:
            have_deps = True
        nodes[name] = {
            "critical_s": crit,
            "overlapped_s": over,
            "units": g.get("units"),
            "inputs": [e for e in ins if isinstance(e, str)]
            if isinstance(ins, list) else [],
            "outputs": [e for e in outs if isinstance(e, str)]
            if isinstance(outs, list) else [],
        }
        for e in nodes[name]["outputs"]:
            producer[e] = name
    if not nodes:
        problems.append("no usable node entries in the graph section")
        return out

    out["duration_s"] = _num(telemetry.get("duration_s"))
    out["nodes_total_s"] = round(
        sum(n["critical_s"] for n in nodes.values()), 3)

    pool = graph.get("pool")
    if not isinstance(pool, dict):
        pool = telemetry.get("overlap_pool")
    if isinstance(pool, dict):
        busy = _num(pool.get("busy_s")) or 0.0
        idle = _num(pool.get("idle_s")) or 0.0
        eff = busy / (busy + idle) if busy + idle > 0 else None
        out["pool"] = {
            "busy_s": round(busy, 3), "idle_s": round(idle, 3),
            "window_s": _num(pool.get("window_s")),
            "slots": pool.get("slots"),
            "efficiency": round(eff, 4) if eff is not None else None,
        }

    if not have_deps:
        problems.append(
            "graph nodes carry no inputs/outputs metadata (artifact "
            "predates critical-path recording) — per-node slack is not "
            "computable")
        return out

    preds = {
        name: sorted({producer[e] for e in n["inputs"]
                      if e in producer and producer[e] != name})
        for name, n in nodes.items()
    }
    order = _toposort(preds)
    if order is None:
        problems.append("node dependency metadata forms a cycle — "
                        "critical path is not computable")
        return out

    # forward pass: earliest start/finish under the recorded durations
    start: dict[str, float] = {}
    finish: dict[str, float] = {}
    for name in order:
        s = max((finish[p] for p in preds[name]), default=0.0)
        start[name] = s
        finish[name] = s + nodes[name]["critical_s"]
    cp_len = max(finish.values())

    # backward pass: latest finish without extending the makespan
    consumers: dict[str, list[str]] = {n: [] for n in nodes}
    for name, ps in preds.items():
        for p in ps:
            consumers[p].append(name)
    latest_finish: dict[str, float] = {}
    for name in reversed(order):
        latest_finish[name] = min(
            (latest_finish[c] - nodes[c]["critical_s"]
             for c in consumers[name]),
            default=cp_len,
        )
    slack = {n: max(latest_finish[n] - finish[n], 0.0) for n in nodes}

    # the critical chain: walk predecessors whose finish meets our start
    # (one always exists — start IS the max predecessor finish)
    cur = max(finish, key=lambda n: (finish[n], n))
    chain = [cur]
    tol = max(1e-9, 1e-6 * cp_len)
    while preds[cur]:
        cur = next(p for p in preds[cur]
                   if finish[p] >= start[cur] - tol)
        chain.append(cur)
    chain.reverse()

    def longest_with_free(zeroed: str) -> float:
        f: dict[str, float] = {}
        for name in order:
            dur = 0.0 if name == zeroed else nodes[name]["critical_s"]
            f[name] = max((f[p] for p in preds[name]), default=0.0) + dur
        return max(f.values())

    by_stage = telemetry.get("dispatch_by_stage")
    if not isinstance(by_stage, dict):
        by_stage = {}

    out["critical_path_s"] = round(cp_len, 3)
    out["critical_path"] = chain
    chain_set = set(chain)
    out["nodes"] = {
        name: {
            "critical_s": round(n["critical_s"], 3),
            "overlapped_s": round(n["overlapped_s"], 3),
            "slack_s": round(slack[name], 3),
            "on_critical_path": name in chain_set,
            "what_if_saved_s": (
                round(cp_len - longest_with_free(name), 3)
                if n["critical_s"] > 0 else 0.0
            ),
            "units": n["units"],
            "dispatch": _merge_dispatch(by_stage.get(name),
                                        by_stage.get(f"{name}_bg")),
        }
        for name, n in sorted(nodes.items())
    }
    if isinstance(trace, dict):
        tr = _trace_windows(trace, set(nodes), problems)
        if tr is not None:
            out["trace"] = tr
    return out


def render(analysis: dict, lines: list[str]) -> None:
    """Append the human rendering of one :func:`analyze` result."""
    for p in analysis.get("problems", []):
        lines.append(f"  critical-path: {p}")
    chain = analysis.get("critical_path")
    if not chain:
        return
    dur = analysis.get("duration_s")
    lines.append(
        f"critical path: {analysis['critical_path_s']:.3f}s over "
        f"{len(chain)} node(s); all-node critical sum "
        f"{analysis['nodes_total_s']:.3f}s"
        + (f", run duration {dur:.3f}s" if dur is not None else "")
    )
    nodes = analysis.get("nodes", {})
    for name in chain:
        info = nodes.get(name, {})
        extra = ""
        disp = info.get("dispatch")
        if disp:
            extra = (f"  dispatch host {disp['host_s']:.3f}s "
                     f"block {disp['block_s']:.3f}s")
        lines.append(f"  {name:28s} {info.get('critical_s', 0.0):8.3f}s"
                     f"{extra}")
    ranked = sorted(
        ((name, info) for name, info in nodes.items()),
        key=lambda kv: -kv[1].get("what_if_saved_s", 0.0),
    )
    lines.append("what-if (run shrinks by, were the node free) and slack:")
    for name, info in ranked[:8]:
        tag = " [overlapped]" if info.get("overlapped_s", 0.0) > 0 else ""
        lines.append(
            f"  {name:28s} saves {info.get('what_if_saved_s', 0.0):8.3f}s  "
            f"slack {info.get('slack_s', 0.0):8.3f}s{tag}"
        )
    pool = analysis.get("pool")
    if pool:
        eff = pool.get("efficiency")
        lines.append(
            f"overlap pool: busy {pool['busy_s']:.3f}s idle "
            f"{pool['idle_s']:.3f}s across {pool.get('slots')} slot(s)"
            + (f" ({eff:.0%} busy)" if eff is not None else "")
        )
    tr = analysis.get("trace")
    if tr:
        lines.append(f"trace join: observed node-span makespan "
                     f"{tr['makespan_s']:.3f}s")
