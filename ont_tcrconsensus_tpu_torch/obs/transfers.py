"""Device data-plane ledger: measured transfers, donation verdicts, and
the static-vs-measured device-memory reconciler.

A copy of the JAX package's ``obs/transfers.py``, on tensors. The JAX
package's static analyzer (graph/check.py) predicts the data plane from
the declared graph; this module measures what moved. Three planes, all
riding the armed :mod:`.metrics` registry (one module-attribute check
when telemetry is off):

- **transfer ledger**: :func:`h2d` / :func:`d2h` record per-site bytes
  and counts (``obs/device.timed_get`` feeds :func:`d2h`);
  :func:`edge_materialized` attributes bytes to graph edges and charges
  round-trip edges to ``host_round_trip_bytes``.
- **donation auditor**: :func:`buffer_probe` reads each tensor's storage
  pointer (``untyped_storage().data_ptr()``) and :func:`audit_donation`
  turns probes around a node into a ``donated|copied|unknown`` verdict;
  CPU tensors give ``unknown`` by design.
- **reconciler**: :func:`node_hbm_boundary` samples the allocator's
  allocated bytes at graph-node boundaries; :func:`analyze_memory` /
  :func:`render_memory` (torch-free, behind ``--report --memory``) join
  them against the static per-node estimate.

Only the graph executor (a later slice of the port) calls the edge,
donation and node-boundary probes. Every probe only reads values and
never raises into the pipeline.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Iterator

from ont_tcrconsensus_tpu_torch.obs import metrics

# divergence beyond this fraction of the static estimate is a named
# problem in --report --memory (the static model is a deliberate
# envelope, so the band is wide; a reintroduced per-node copy blows
# through it anyway)
DIVERGENCE_THRESHOLD = 0.5


# --- byte accounting --------------------------------------------------------


def nbytes_of(value: Any, _depth: int = 0) -> int:
    """Conservative byte size of a pytree-ish value.

    Sizes a tensor leaf as ``numel * element_size``, trusts a leaf
    ``.nbytes`` (numpy arrays), measures
    bytes/str, and recurses ONLY into dict/list/tuple/set/dataclass
    containers — never arbitrary iterables, because consuming a
    generator edge value here would corrupt the pipeline the ledger is
    auditing. Unknown leaves count 0: the ledger under-reports rather
    than guesses.
    """
    if value is None or _depth > 6:
        return 0
    try:
        if callable(getattr(value, "element_size", None)) and callable(
                getattr(value, "numel", None)):
            return int(value.numel()) * int(value.element_size())
        nb = getattr(value, "nbytes", None)
    except Exception:  # exotic lazy proxy: count 0, never raise
        return 0
    if isinstance(nb, (int, float)) and not isinstance(nb, bool):
        return int(nb)
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, str):
        return len(value.encode("utf-8", "replace"))
    if isinstance(value, bool):
        return 1
    if isinstance(value, (int, float)):
        return 8
    if isinstance(value, dict):
        return sum(nbytes_of(v, _depth + 1) for v in value.values())
    if isinstance(value, (list, tuple, set, frozenset)):
        return sum(nbytes_of(v, _depth + 1) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return sum(nbytes_of(getattr(value, f.name, None), _depth + 1)
                   for f in dataclasses.fields(value))
    return 0


def _safe_nbytes(value: Any) -> int:
    try:
        return nbytes_of(value)
    except Exception:  # measurement must never fail the transfer it measures
        return 0


# --- transfer ledger plants -------------------------------------------------


def h2d(site: str, value: Any, nbytes: int | None = None) -> None:
    """Record a host->device transfer at ``site``; free no-op when
    telemetry is off. ``value`` is only sized, never mutated."""
    reg = metrics._ARMED
    if reg is not None:
        nb = _safe_nbytes(value) if nbytes is None else int(nbytes)
        reg.counter_add("transfer.h2d", nb)
        reg.transfer_add(site, "h2d", nb)


def d2h(site: str, value: Any, nbytes: int | None = None) -> None:
    """Record a device->host transfer at ``site``; free no-op when
    telemetry is off. ``value`` is only sized, never mutated."""
    reg = metrics._ARMED
    if reg is not None:
        nb = _safe_nbytes(value) if nbytes is None else int(nbytes)
        reg.counter_add("transfer.d2h", nb)
        reg.transfer_add(site, "d2h", nb)


def edge_materialized(edge: str, placement: str, value: Any, *,
                      round_trip: bool = False) -> None:
    """Record one graph-edge materialization (executor's _absorb).

    Attributes the edge's bytes to its declared placement direction
    ("hbm" edges land on-device -> h2d; "host"/"disk" edges leave the
    producer toward the host -> d2h) and charges edges on the graph
    check's placement-round-trip paths to the run-level
    ``host_round_trip_bytes``, which a byte gate holds at its budget.
    """
    reg = metrics._ARMED
    if reg is not None:
        nb = _safe_nbytes(value)
        direction = "h2d" if placement == "hbm" else "d2h"
        reg.edge_transfer_add(edge, direction, nb, placement)
        if round_trip:
            reg.round_trip_add(nb)


# --- donation auditor -------------------------------------------------------


def _leaves(value: Any, _depth: int = 0) -> Iterator[Any]:
    """Yield array-ish leaves of a container value; same safe recursion
    set as :func:`nbytes_of` (never consumes iterators)."""
    if value is None or _depth > 6:
        return
    if isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v, _depth + 1)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v, _depth + 1)
    else:
        yield value


def buffer_probe(value: Any) -> tuple[set[int], bool, int] | None:
    """Probe the storage identity of every tensor inside ``value``.

    Returns ``(pointer set, saw_non_cpu_device, n_deleted)`` or None when
    no leaf is a tensor (the caller degrades that to an ``unknown``
    verdict rather than guessing). A tensor's storage is never deleted
    under the caller, so ``n_deleted`` is 0; the slot keeps the JAX
    package's probe shape.
    """
    ptrs: set[int] = set()
    non_cpu = False
    probed = False
    for leaf in _leaves(value):
        storage = getattr(leaf, "untyped_storage", None)
        if storage is None:
            continue
        probed = True
        try:
            ptr = int(storage().data_ptr())
        except Exception:  # an exotic tensor refusing the call: skip the leaf
            continue
        if ptr:
            ptrs.add(ptr)
        try:
            if leaf.device.type != "cpu":
                non_cpu = True
        except Exception:  # device introspection is advisory only
            pass
    if not probed:
        return None
    return (ptrs, non_cpu, 0) if ptrs else None


def _deleted_count(probe: tuple | None) -> int:
    """Deleted-leaf count from a probe tuple; legacy 2-tuples carry 0."""
    if probe is None or len(probe) < 3:
        return 0
    n = probe[2]
    return int(n) if isinstance(n, int) and not isinstance(n, bool) else 0


def donation_verdict(in_probe: tuple | None,
                     out_probe: tuple | None,
                     post_probe: tuple | None = None) -> str:
    """Pure verdict logic: did a donation-eligible input buffer get
    reused by the node's outputs?

    Probe tuples are ``(pointer set, saw_non_cpu_device[, n_deleted])``;
    the two-element legacy shape is accepted (deleted count 0).
    ``post_probe`` is an optional re-probe of the *input* value after
    the call returned.

    - no readable input pointers -> ``unknown`` (can't testify);
    - CPU-only buffers -> ``unknown`` (a CPU run must not report a
      fake ``copied`` regression);
    - input pointer reappears among outputs -> ``donated``;
    - input buffer reads *deleted* after the call (post_probe) ->
      ``donated``;
    - readable on-device input, disjoint live outputs -> ``copied``
      (the named finding: the buffer lived on after its drop point).
    """
    if in_probe is None:
        return "unknown"
    in_ptrs, non_cpu = in_probe[0], in_probe[1]
    if not non_cpu:
        return "unknown"
    if out_probe is not None and in_ptrs & out_probe[0]:
        return "donated"
    if _deleted_count(post_probe) > 0:
        return "donated"
    return "copied"


def audit_donation(edge: str, node: str,
                   in_probe: tuple | None,
                   out_probe: tuple | None,
                   post_probe: tuple | None = None) -> None:
    """Record the donation verdict for ``edge`` dropped at ``node``;
    free no-op when telemetry is off."""
    reg = metrics._ARMED
    if reg is not None:
        reg.counter_add("donation.audit")
        reg.donation_set(
            edge, donation_verdict(in_probe, out_probe, post_probe), node)


# --- measured per-node HBM --------------------------------------------------


def node_hbm_boundary(node: str) -> None:
    """Sample the allocator's allocated bytes at a graph-node boundary.

    Free no-op when telemetry is off or torch was never imported; without
    CUDA (a CPU run) there is no sample, and --report --memory names that
    instead of inventing numbers.
    """
    reg = metrics._ARMED
    if reg is None:
        return
    if sys.modules.get("torch") is None:
        return
    try:
        from ont_tcrconsensus_tpu_torch.obs import device as obs_device

        end = obs_device._device_bytes_in_use(obs_device.run_devices(),
                                              obs_device.ALLOCATED_CURRENT)
    except Exception:  # sampling is best-effort
        return
    if end is None:
        return
    reg.counter_add("memory.reconcile")
    reg.node_hbm_add(node, end)


def static_hbm(node: str, bytes_est: int) -> None:
    """Record the static live-memory estimate while ``node`` runs (fed
    from the graph check at run start, so --report needs no config to
    reconcile); free no-op when off."""
    reg = metrics._ARMED
    if reg is not None:
        reg.static_hbm_set(node, bytes_est)


# --- static-vs-measured reconciler (torch-free; --report --memory) ----------


def _num(value: Any) -> int | None:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return int(value)


def analyze_memory(data: Any, *,
                   divergence_threshold: float = DIVERGENCE_THRESHOLD) -> dict:
    """Reconcile a telemetry.json payload's measured data plane against
    graftcheck's static model.

    Pure dict-in/dict-out on the committed artifact (no torch, no config):
    the ``--report --memory`` backend. Follows the --critical-path
    degradation contract — any garbage shape becomes a named problem in
    the result, never an exception.
    """
    out: dict[str, Any] = {"nodes": {}, "problems": []}
    problems: list[str] = out["problems"]
    if not isinstance(data, dict):
        problems.append("telemetry payload is not an object")
        return out
    tr = data.get("transfers")
    if tr is None:
        problems.append(
            "no transfers section — artifact predates the data-plane "
            "ledger or the run had telemetry off")
        return out
    if not isinstance(tr, dict):
        problems.append(
            f"transfers section is not an object ({type(tr).__name__})")
        return out

    hrt = _num(tr.get("host_round_trip_bytes"))
    if hrt is not None:
        out["host_round_trip_bytes"] = hrt
    elif "host_round_trip_bytes" in tr:
        problems.append("host_round_trip_bytes is not a number")

    donation = tr.get("donation")
    if donation is not None and not isinstance(donation, dict):
        problems.append("donation table is not an object")
        donation = None
    if donation:
        counts: dict[str, int] = {}
        for edge, entry in donation.items():
            verdict = entry.get("verdict") if isinstance(entry, dict) else None
            if not isinstance(verdict, str):
                problems.append(f"garbage donation entry {edge!r} dropped")
                continue
            counts[verdict] = counts.get(verdict, 0) + 1
            if verdict == "copied":
                node = entry.get("node")
                problems.append(
                    f"donation regression: edge {edge!r} was COPIED at its "
                    f"drop point ({node}) — the donation-eligible buffer "
                    "lived on in HBM")
        out["donation"] = counts

    static = tr.get("static_hbm_by_node")
    if static is not None and not isinstance(static, dict):
        problems.append("static_hbm_by_node is not an object")
        static = None
    measured = tr.get("node_hbm")
    if measured is not None and not isinstance(measured, dict):
        problems.append("node_hbm table is not an object")
        measured = None
    static = static or {}
    measured = measured or {}

    for node in sorted(set(static) | set(measured)):
        row: dict[str, Any] = {}
        s = _num(static.get(node))
        if node in static and s is None:
            problems.append(f"garbage static HBM entry {node!r} dropped")
        if s is not None:
            row["static_bytes"] = s
        m = measured.get(node)
        end = delta = None
        if node in measured:
            if isinstance(m, dict):
                end = _num(m.get("end_bytes"))
                delta = _num(m.get("delta_bytes"))
            if end is None and delta is None:
                problems.append(f"garbage node_hbm entry {node!r} dropped")
        if end is not None:
            row["measured_end_bytes"] = end
        if delta is not None:
            row["measured_delta_bytes"] = delta
        if s and end is not None:
            div = (end - s) / s
            row["divergence"] = round(div, 3)
            if abs(div) > divergence_threshold:
                problems.append(
                    f"hbm divergence at node {node}: static {s} B vs "
                    f"measured {end} B ({div:+.0%}, threshold "
                    f"±{divergence_threshold:.0%}) — the static model "
                    "and the device disagree about what this node keeps "
                    "live")
        if row:
            out["nodes"][node] = row

    if static and not any("measured_end_bytes" in r
                          for r in out["nodes"].values()):
        problems.append(
            "no measured per-node HBM samples — backend reports no "
            "memory stats (CPU) or the run predates the boundary "
            "sampler; static liveness only")
    if not static and not measured:
        problems.append(
            "no static/measured per-node HBM tables — imperative "
            "executor run or pre-upgrade artifact")
    return out


def _fmt_bytes(n: Any) -> str:
    if not isinstance(n, (int, float)) or isinstance(n, bool):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def render_memory(analysis: dict, lines: list[str]) -> None:
    """Append the human rendering of :func:`analyze_memory` to ``lines``
    (the --report --memory section body)."""
    nodes = analysis.get("nodes") or {}
    if nodes:
        lines.append("static graftcheck estimate vs measured device "
                     "bytes-in-use, per graph node:")
        for name, row in nodes.items():
            parts = [f"  {name:<26s}"]
            parts.append(f"static {_fmt_bytes(row.get('static_bytes')):>11s}"
                         if "static_bytes" in row else
                         f"static {'-':>11s}")
            parts.append(
                f"measured {_fmt_bytes(row.get('measured_end_bytes')):>11s}"
                if "measured_end_bytes" in row else f"measured {'-':>11s}")
            if "measured_delta_bytes" in row:
                parts.append(
                    f"delta {_fmt_bytes(row['measured_delta_bytes']):>11s}")
            if "divergence" in row:
                parts.append(f"divergence {row['divergence']:+.0%}")
            lines.append(" ".join(parts))
    if "host_round_trip_bytes" in analysis:
        lines.append("measured host round-trip: "
                     f"{_fmt_bytes(analysis['host_round_trip_bytes'])}")
    donation = analysis.get("donation")
    if donation:
        lines.append("donation verdicts: " + ", ".join(
            f"{k}={donation[k]}" for k in sorted(donation)))
    for p in analysis.get("problems", ()):
        lines.append(f"memory problem: {p}")
    if not nodes and not analysis.get("problems"):
        lines.append("nothing to reconcile")
