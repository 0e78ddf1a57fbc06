"""graftcheck: semantic analysis of a built :class:`GraphSpec`.

A copy of the JAX package's ``graph/check.py``. It checks the
*constructed* graph — the same object the executor schedules — by
abstract-interpreting the topological schedule with the executor's exact
residency rule (a value lives from its producer to its last consumer and
is dropped immediately after, unless it is a graph result).  Everything
here is torch-free, so it can prove properties of the production graph
on a host with no device, before a single kernel is built.

Four analyses:

- **liveness** — the per-step live-hbm-edge set and a static HBM
  high-water model.  Per-edge byte estimates come from a ``byte_model``
  mapping (see :func:`production_byte_model`); the serial schedule is the
  lower bound — overlapped side sinks can only extend lifetimes.
- **donation safety** — the proof that buffer donation at each drop
  point is sound: every hbm edge has at least one consumer and is not a
  graph result, so no reference to its value can exist after the last
  consumer runs.  Each node's donation-eligible inputs (hbm edges whose
  last consumer it is) are reported; violations are ``donation-hazard``
  findings (an hbm edge the executor would never drop pins device memory
  until process exit).
- **placement flow** — every implicit device→host round-trip: a device
  node (one touching any hbm edge) produces a host edge whose value,
  possibly flowing through further host-only nodes, a later device node
  consumes.  Each such path is a ``placement-round-trip`` advisory, the
  regression guard of the device-resident round1→round2 hand-offs.
- **sharding pairing** — a node whose hbm inputs
  and hbm outputs declare different :attr:`Edge.sharding` specs is a
  ``reshard-site`` violation (an implicit cross-device shuffle nothing
  asked for).

Severity is two-valued: ``violation`` (graph breaks a contract; callers
exit non-zero) and ``advisory`` (true, useful, not fatal — the
round-trip worklist).  :meth:`Report.summary` is the compact verdict
recorded in ``telemetry.json`` and the run-history ledger.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ont_tcrconsensus_tpu_torch.graph.ir import GraphSpec

SEVERITIES = ("violation", "advisory")

# Coarse planning constants for the production byte model: one padded
# read row is `2 * max_read_length` bytes (int8 codes + quals planes).
_PLANES = 2


@dataclasses.dataclass(frozen=True)
class Finding:
    """One semantic finding against the analyzed graph.

    ``path`` is the node/edge chain for flow findings (alternating node,
    edge, node, ...); for point findings it holds just the subject.
    """

    kind: str
    severity: str
    subject: str
    message: str
    path: tuple[str, ...] = ()

    def format(self) -> str:
        return f"[{self.severity}] {self.kind} at {self.subject}: {self.message}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["path"] = list(self.path)
        return d

    def key(self) -> tuple:
        return (self.kind, self.subject, self.path)


@dataclasses.dataclass
class Report:
    """Everything :func:`analyze` proved about one graph."""

    graph: str
    findings: list[Finding]
    # [{"step", "node", "live_hbm", "hbm_bytes_est"}] per schedule step
    liveness: list[dict]
    hbm_high_water_bytes: int
    hbm_high_water_node: str | None
    # node -> hbm input edges whose buffers may be donated into the node
    donation_eligible: dict[str, list[str]]

    @property
    def violations(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "violation"]

    @property
    def advisories(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "advisory"]

    @property
    def verdict(self) -> str:
        if self.violations:
            return "violations"
        return "advisories" if self.advisories else "clean"

    def summary(self) -> dict:
        """Compact verdict for telemetry.json / the history ledger."""
        kinds: dict[str, int] = {}
        for f in self.findings:
            kinds[f.kind] = kinds.get(f.kind, 0) + 1
        return {
            "graph": self.graph,
            "verdict": self.verdict,
            "violations": len(self.violations),
            "advisories": len(self.advisories),
            "kinds": {k: kinds[k] for k in sorted(kinds)},
            "hbm_high_water_bytes_est": self.hbm_high_water_bytes,
            "hbm_high_water_node": self.hbm_high_water_node,
            "donation_safe": "donation-hazard" not in kinds,
        }

    def to_dict(self) -> dict:
        return {
            "summary": self.summary(),
            "findings": [f.to_dict() for f in self.findings],
            "liveness": self.liveness,
            "donation_eligible": {
                k: list(v) for k, v in sorted(self.donation_eligible.items())
            },
        }


def _is_device_node(spec: GraphSpec, name: str) -> bool:
    node = spec.nodes[name]
    return any(
        e in spec.edges and spec.edges[e].placement == "hbm"
        for e in node.inputs + node.outputs
    )


def _liveness(spec: GraphSpec, byte_model: dict[str, int],
              ) -> tuple[list[dict], int, str | None, dict[str, list[str]]]:
    """Walk the schedule with the executor's drop rule; returns the
    per-step table, the high-water, its node, and the donation table."""
    order = {n.name: i for i, n in enumerate(spec.schedule)}
    last_consumer: dict[str, int] = {}
    for e, users in spec.consumers.items():
        last_consumer[e] = max(order[u] for u in users)

    live: set[str] = set(spec.inputs)
    steps: list[dict] = []
    high_water, high_node = 0, None
    donation: dict[str, list[str]] = {}
    for i, node in enumerate(spec.schedule):
        live |= set(e for e in node.outputs if e in spec.edges)
        live_hbm = sorted(
            e for e in live
            if e in spec.edges and spec.edges[e].placement == "hbm"
        )
        hbm_bytes = sum(byte_model.get(e, 0) for e in live_hbm)
        steps.append({
            "step": i, "node": node.name, "live_hbm": live_hbm,
            "hbm_bytes_est": hbm_bytes,
        })
        if hbm_bytes > high_water or high_node is None:
            high_water, high_node = hbm_bytes, node.name
        eligible = []
        for e in node.inputs:
            if e not in spec.edges or e in spec.results:
                continue
            if last_consumer.get(e) == i:
                live.discard(e)
                if spec.edges[e].placement == "hbm":
                    eligible.append(e)
        if eligible:
            donation[node.name] = sorted(eligible)
    return steps, high_water, high_node, donation


def _donation_hazards(spec: GraphSpec) -> list[Finding]:
    out: list[Finding] = []
    for e, edge in sorted(spec.edges.items()):
        if edge.placement != "hbm":
            continue
        if e in spec.results:
            out.append(Finding(
                "donation-hazard", "violation", e,
                f"hbm edge {e!r} is a graph result — the executor never "
                "drops it, so its buffer cannot be donated and pins device "
                "memory through the whole remaining schedule",
                (e,),
            ))
        elif not spec.consumers.get(e) and e in spec.producer:
            out.append(Finding(
                "donation-hazard", "violation", e,
                f"hbm edge {e!r} (produced by "
                f"{spec.producer[e]!r}) has no consumer — the executor "
                "drops values at their last consumer, so this one is "
                "never dropped",
                (e,),
            ))
    return out


def _round_trips(spec: GraphSpec, max_hops: int = 8) -> list[Finding]:
    """DFS host-edge flows from each device node to the first device
    node downstream; each simple path is one round-trip finding."""
    device = {n.name for n in spec.schedule if _is_device_node(spec, n.name)}
    findings: list[Finding] = []

    def host_outputs(name: str) -> list[str]:
        # meta host edges (Edge.meta) carry orchestration metadata — stats,
        # groupings, selections — not device-derived bulk payload, so they
        # are not round-trip carriers; the transfer ledger still measures
        # their bytes per edge, keeping the declaration falsifiable
        return [e for e in spec.nodes[name].outputs
                if e in spec.edges and spec.edges[e].placement == "host"
                and not getattr(spec.edges[e], "meta", False)]

    def walk(path: tuple[str, ...], node: str) -> None:
        # path alternates node, edge, node, ... and starts at a device node
        if len(path) > 2 * max_hops:
            return
        for e in host_outputs(node):
            for consumer in spec.consumers.get(e, ()):
                if consumer in path:
                    continue
                nxt = path + (e, consumer)
                if consumer in device:
                    findings.append(Finding(
                        "placement-round-trip", "advisory", path[0],
                        "device value leaves hbm at "
                        + " -> ".join(
                            (f"[{p}]" if i % 2 else p)
                            for i, p in enumerate(nxt)
                        )
                        + f" — {consumer!r} pays an implicit host "
                        "round-trip re-upload",
                        nxt,
                    ))
                else:
                    walk(nxt, consumer)

    for name in sorted(device):
        walk((name,), name)
    findings.sort(key=lambda f: f.path)
    return findings


def round_trip_edges(spec: GraphSpec) -> set[str]:
    """Host-placed edges that sit on any placement-round-trip path.

    The measured twin of :func:`_round_trips`: the graph executor charges
    these edges' materialized bytes to the run-level
    ``host_round_trip_bytes`` ledger (obs/transfers.py), so the static
    advisory and the runtime number name the same flows. Finding paths
    alternate node, edge, node, ... — the edges sit at odd indices.
    """
    out: set[str] = set()
    for f in _round_trips(spec):
        out.update(p for i, p in enumerate(f.path) if i % 2)
    return out


def donation_plan(spec: GraphSpec) -> dict[str, frozenset[str]]:
    """node name -> hbm input edges whose buffers it may consume in place.

    The executor-facing face of the liveness donation proof: an hbm edge
    whose last consumer is ``node`` (and which is not a graph result) is
    dropped by the executor immediately after ``node`` runs, so no live
    reference to its value can exist afterwards and the node may consume
    the buffer in place.  Byte estimates are
    irrelevant to the proof, so no byte model is consulted.
    """
    donation = _liveness(spec, {})[3]
    return {node: frozenset(edges) for node, edges in donation.items()}


def _reshard_sites(spec: GraphSpec) -> list[Finding]:
    out: list[Finding] = []
    for node in spec.schedule:
        in_specs = sorted({
            spec.edges[e].sharding for e in node.inputs
            if e in spec.edges and spec.edges[e].placement == "hbm"
            and spec.edges[e].sharding is not None
        })
        out_specs = sorted({
            spec.edges[e].sharding for e in node.outputs
            if e in spec.edges and spec.edges[e].placement == "hbm"
            and spec.edges[e].sharding is not None
        })
        if in_specs and out_specs and in_specs != out_specs:
            out.append(Finding(
                "reshard-site", "violation", node.name,
                f"node {node.name!r} consumes hbm sharding "
                f"{in_specs} but produces {out_specs} — an implicit "
                "cross-device reshard nothing declared",
                (node.name,),
            ))
    return out


def reshard_sites(spec: GraphSpec) -> list[Finding]:
    """Public face of the reshard-pairing proof, for the executor.

    The sharded execution layer refuses to run a graph with reshard-site
    violations: the executor derives each node's paired in/out shardings
    from the declared edges (``node_sharding_plan`` of a mesh), and
    that pairing is only a *plan* — not a proof — if some node's declared
    inputs and outputs disagree. Same findings ``analyze`` reports; this
    entry point skips the liveness walk so the runtime gate stays cheap.
    """
    return _reshard_sites(spec)


def analyze(spec: GraphSpec, byte_model: dict[str, int] | None = None,
            ) -> Report:
    """Run every semantic analysis over one built graph."""
    model = byte_model or {}
    steps, high_water, high_node, donation = _liveness(spec, model)
    findings = (
        _donation_hazards(spec) + _reshard_sites(spec) + _round_trips(spec)
    )
    findings.sort(key=lambda f: (f.severity, f.kind, f.subject, f.path))
    return Report(
        graph=spec.name, findings=findings, liveness=steps,
        hbm_high_water_bytes=high_water, hbm_high_water_node=high_node,
        donation_eligible=donation,
    )


def production_byte_model(cfg: Any, n_reads: int = 10_000) -> dict[str, int]:
    """Coarse per-edge HBM byte estimates for the production graph.

    A planning model, not an accountant: one padded read row costs
    ``_PLANES * cfg.max_read_length`` bytes (int8 code + qual planes) and
    round-2 holds one consensus row per round-1 cluster at the configured
    minimum depth.  Good for the *shape* of the liveness curve and for
    cross-run regression ratios; the runtime HBM high-water sampler
    (obs/transfers.py ``node_hbm_boundary``) remains the ground truth.
    The estimate is the JAX package's, unchanged for the card: ``--report
    --memory`` names where the two part.
    """
    row = _PLANES * int(getattr(cfg, "max_read_length", 4096))
    depth = max(1, int(getattr(cfg, "min_reads_per_cluster", 4)))
    n_cons = max(1, int(n_reads) // depth)
    return {
        "read_store": int(n_reads) * row,
        "cons_store": n_cons * row,
    }
