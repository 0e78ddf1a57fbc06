"""Node/edge IR and the validating graph builder.

An :class:`Edge` is a named artifact with a placement declaring where its
value lives between producer and consumer:

- ``hbm``  — device-resident (arrays stay on the accelerator; the
  executor keeps the value alive only from producer to last consumer and
  drops it immediately after, which is what makes buffer donation safe);
- ``host`` — host RAM (plain Python values);
- ``disk`` — a filesystem artifact (paths; the only placement that can
  survive a process restart, hence the resume-boundary rules below).

A :class:`Node` is a stage: a callable ``fn(ctx, inputs) -> outputs``
plus declared input/output edge names, workload ``units`` (int or
``callable(ctx, inputs)``) feeding the watchdog's scaled deadlines, an
optional ``commit`` hook that must run on the main thread (log writes
for overlapped stages), a ``checkpoint`` flag (all pending off-critical-
path work is committed before the node body runs, so its manifest mark
covers a consistent state), and optional resume fields: ``resume_key``
names the manifest-v2 stage entry, ``resume_probe(ctx)`` returns the
disk artifact to sha256-verify (or None when absent), ``resume_reload``
rebuilds the values of ``resume_provides`` edges from disk.

:class:`GraphBuilder.build` validates the whole declaration and raises
:class:`GraphValidationError` carrying every named problem at once —
cycles (with member names), undeclared/dangling edges, duplicate
producers, unknown placements, and resume boundaries: an ``hbm`` edge
may not cross a disk-resume boundary (device memory cannot survive a
restart), and every crossing edge must be covered by the resume node's
``resume_provides``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

PLACEMENTS = ("hbm", "host", "disk")


@dataclasses.dataclass(frozen=True)
class Edge:
    """A named, placement-typed artifact flowing between nodes.

    ``sharding`` is an optional device-layout spec name: a label like
    ``"data"`` naming how an ``hbm`` value is laid out across a mesh
    (which the port's mesh slice brings).  The executor only gates on it;
    graftcheck
    pairs producer-side and consumer-side specs and reports any node whose
    hbm inputs and outputs disagree as a reshard site.  Only ``hbm`` edges
    may carry one — host/disk values have no device layout.

    ``meta`` marks a ``host`` edge as orchestration metadata: stats,
    groupings, index selections — small coordination values whose bytes
    are negligible next to the bulk stores and whose host residency is by
    design, not an accident of the data plane.  graftcheck's round-trip
    analysis skips meta edges (they are not re-uploaded payload), while
    the transfer ledger still measures their bytes per edge, so the
    declaration is auditable rather than a blind waiver.  Only ``host``
    edges may carry it — an hbm/disk value cannot be "metadata at rest".
    """

    name: str
    placement: str
    sharding: str | None = None
    meta: bool = False


@dataclasses.dataclass
class Node:
    """One stage of the graph; see module docstring for field semantics."""

    name: str
    fn: Callable[..., dict] | None
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    units: int | Callable[..., int] = 0
    commit: Callable[..., None] | None = None
    checkpoint: bool = False
    resume_key: str | None = None
    resume_probe: Callable[[Any], str | None] | None = None
    resume_reload: Callable[[Any], dict] | None = None
    resume_provides: tuple[str, ...] = ()

    def eval_units(self, ctx: Any, inputs: dict) -> int:
        u = self.units
        return int(u(ctx, inputs)) if callable(u) else int(u)


class GraphValidationError(ValueError):
    """Raised by :meth:`GraphBuilder.build`; ``problems`` is the full list
    of human-readable validation failures (``--validate`` prints each)."""

    def __init__(self, problems: Iterable[str]):
        self.problems = list(problems)
        super().__init__(
            "invalid stage graph:\n"
            + "\n".join(f"  - {p}" for p in self.problems)
        )


class GraphSpec:
    """A validated, schedulable graph (only :class:`GraphBuilder` builds
    these)."""

    def __init__(self, name: str, nodes: list[Node], edges: dict[str, Edge],
                 inputs: frozenset[str], results: tuple[str, ...],
                 schedule: list[Node]):
        self.name = name
        self.nodes = {n.name: n for n in nodes}
        self.edges = edges
        self.inputs = inputs
        self.results = results
        self.schedule = schedule
        self.producer: dict[str, str] = {}
        self.consumers: dict[str, list[str]] = {}
        for n in nodes:
            for e in n.outputs:
                self.producer[e] = n.name
            for e in n.inputs:
                self.consumers.setdefault(e, []).append(n.name)

    def is_side_sink(self, node: Node) -> bool:
        """True when the node is off the critical path purely by edge
        declaration: nothing consumes its outputs, none of them are graph
        results, and it carries no checkpoint/resume responsibility."""
        if node.checkpoint or node.resume_key is not None:
            return False
        return all(
            not self.consumers.get(e) and e not in self.results
            for e in node.outputs
        )

    def side_sinks(self) -> list[str]:
        return [n.name for n in self.schedule if self.is_side_sink(n)]

    def ancestors(self, name: str) -> set[str]:
        """Transitive producers of ``name``'s inputs (node names)."""
        out: set[str] = set()
        frontier = [name]
        while frontier:
            node = self.nodes[frontier.pop()]
            for e in node.inputs:
                p = self.producer.get(e)
                if p is not None and p not in out:
                    out.add(p)
                    frontier.append(p)
        return out

    def skip_closure(self, name: str) -> set[str]:
        """Node names skippable when ``name`` resumes from disk: its
        ancestors plus itself, then — iteratively — every node whose
        inputs are all produced inside the set (side sinks hanging off
        skipped producers, which the imperative resume path never ran
        either)."""
        closure = self.ancestors(name) | {name}
        grew = True
        while grew:
            grew = False
            for n in self.schedule:
                if n.name in closure or not self.is_side_sink(n):
                    # only side sinks are absorbable: any other node's
                    # outputs feed nodes OUTSIDE the closure, and a reload
                    # only reconstructs the resume node's own provides
                    continue
                if n.inputs and all(
                    self.producer.get(e) in closure for e in n.inputs
                ):
                    closure.add(n.name)
                    grew = True
        return closure

    def crossing_edges(self, name: str) -> list[str]:
        """Edges produced inside ``skip_closure(name)`` but consumed
        outside it — the values a resume reload must reconstruct."""
        closure = self.skip_closure(name)
        crossing = []
        for e, producer in self.producer.items():
            if producer not in closure:
                continue
            if any(c not in closure for c in self.consumers.get(e, ())):
                crossing.append(e)
        return sorted(crossing)

    def describe(self) -> dict:
        """Summary for telemetry/reporting (JSON-safe)."""
        return {
            "name": self.name,
            "nodes": [n.name for n in self.schedule],
            "edges": {e.name: e.placement for e in self.edges.values()},
            "shardings": {e.name: e.sharding for e in self.edges.values()
                          if e.sharding is not None},
            "side_sinks": self.side_sinks(),
            "results": list(self.results),
        }


class GraphBuilder:
    """Accumulates edge/node declarations, then :meth:`build` validates
    everything at once and returns a :class:`GraphSpec`."""

    def __init__(self, name: str = "pipeline"):
        self.name = name
        self._nodes: list[Node] = []
        self._edges: dict[str, Edge] = {}
        self._inputs: set[str] = set()
        self._results: list[str] = []
        self._problems: list[str] = []

    def edge(self, name: str, placement: str,
             sharding: str | None = None, meta: bool = False) -> None:
        if name in self._edges:
            self._problems.append(f"edge {name!r} declared twice")
            return
        if placement not in PLACEMENTS:
            self._problems.append(
                f"edge {name!r}: unknown placement {placement!r} "
                f"(expected one of {'|'.join(PLACEMENTS)})"
            )
        if sharding is not None:
            if not isinstance(sharding, str) or not sharding:
                self._problems.append(
                    f"edge {name!r}: sharding spec must be a non-empty "
                    f"string, got {sharding!r}"
                )
                sharding = None
            elif placement != "hbm":
                self._problems.append(
                    f"edge {name!r}: sharding {sharding!r} declared on a "
                    f"{placement!r} edge (only hbm values have a device "
                    "layout)"
                )
                sharding = None
        if meta and placement != "host":
            self._problems.append(
                f"edge {name!r}: meta declared on a {placement!r} edge "
                "(only host-placed orchestration values can be metadata)"
            )
            meta = False
        self._edges[name] = Edge(name, placement, sharding, meta)

    def input(self, name: str, placement: str = "disk") -> None:
        self.edge(name, placement)
        self._inputs.add(name)

    def add_node(self, name: str, fn: Callable[..., dict] | None = None, *,
                 inputs: Iterable[str] = (), outputs: Iterable[str] = (),
                 units: int | Callable[..., int] = 0,
                 commit: Callable[..., None] | None = None,
                 checkpoint: bool = False,
                 resume_key: str | None = None,
                 resume_probe: Callable[[Any], str | None] | None = None,
                 resume_reload: Callable[[Any], dict] | None = None,
                 resume_provides: Iterable[str] = ()) -> None:
        if any(n.name == name for n in self._nodes):
            self._problems.append(f"node {name!r} declared twice")
            return
        self._nodes.append(Node(
            name=name, fn=fn, inputs=tuple(inputs), outputs=tuple(outputs),
            units=units, commit=commit,
            # a resume node is always a checkpoint barrier: pending
            # off-critical-path work must land before its manifest mark
            checkpoint=checkpoint or resume_key is not None,
            resume_key=resume_key, resume_probe=resume_probe,
            resume_reload=resume_reload,
            resume_provides=tuple(resume_provides),
        ))

    def result(self, *names: str) -> None:
        self._results.extend(names)

    def build(self) -> GraphSpec:
        problems = list(self._problems)
        producer: dict[str, str] = {}
        consumed: dict[str, list[str]] = {}
        node_names = {n.name for n in self._nodes}
        for e in self._edges:
            if e in node_names:
                problems.append(
                    f"edge {e!r} collides with a node of the same name — "
                    "schedules, telemetry and resume keys could not tell "
                    "them apart"
                )
        for n in self._nodes:
            for e in n.inputs:
                if e not in self._edges:
                    problems.append(f"node {n.name!r}: undeclared input edge {e!r}")
                consumed.setdefault(e, []).append(n.name)
            for e in n.outputs:
                if e not in self._edges:
                    problems.append(f"node {n.name!r}: undeclared output edge {e!r}")
                if e in self._inputs:
                    problems.append(
                        f"edge {e!r} is a graph input but node {n.name!r} "
                        "also produces it"
                    )
                elif e in producer:
                    problems.append(
                        f"edge {e!r} produced by both {producer[e]!r} "
                        f"and {n.name!r}"
                    )
                producer.setdefault(e, n.name)
            for e in n.resume_provides:
                if e not in self._edges:
                    problems.append(
                        f"node {n.name!r}: resume_provides names "
                        f"undeclared edge {e!r}"
                    )
        for e, users in consumed.items():
            if e not in producer and e not in self._inputs and e in self._edges:
                problems.append(
                    f"edge {e!r} consumed by {users[0]!r} has no producer "
                    "and is not a graph input"
                )
        for e in self._edges:
            if e not in producer and e not in consumed and e not in self._inputs:
                problems.append(
                    f"edge {e!r} is dangling (declared but never produced "
                    "or consumed)"
                )
        for e in self._inputs:
            if e not in consumed:
                problems.append(f"graph input {e!r} is never consumed")
        for e in self._results:
            if e not in self._edges:
                problems.append(f"result edge {e!r} is not declared")
            elif e not in producer:
                problems.append(f"result edge {e!r} is never produced")

        schedule, cycle = _toposort(self._nodes, producer)
        if cycle:
            problems.append(
                "dependency cycle among nodes: " + " -> ".join(cycle)
            )

        spec = GraphSpec(
            self.name, self._nodes, dict(self._edges),
            frozenset(self._inputs), tuple(self._results), schedule,
        )
        if not cycle:
            problems.extend(_check_resume_boundaries(spec))
        if problems:
            raise GraphValidationError(problems)
        return spec


def _toposort(nodes: list[Node], producer: dict[str, str],
              ) -> tuple[list[Node], list[str]]:
    """Kahn's algorithm with declaration-order tie-break, so the schedule
    is deterministic and mirrors the imperative stage order.  Returns
    (schedule, cycle_member_names); on a cycle the schedule is partial."""
    index = {n.name: i for i, n in enumerate(nodes)}
    deps: dict[str, set[str]] = {}
    for n in nodes:
        deps[n.name] = {
            producer[e] for e in n.inputs
            if e in producer and producer[e] != n.name
        }
    done: set[str] = set()
    order: list[Node] = []
    remaining = list(nodes)
    while remaining:
        ready = [n for n in remaining if deps[n.name] <= done]
        if not ready:
            cycle = sorted((n.name for n in remaining), key=index.get)
            return order, cycle
        nxt = min(ready, key=lambda n: index[n.name])
        order.append(nxt)
        done.add(nxt.name)
        remaining.remove(nxt)
    return order, []


def _check_resume_boundaries(spec: GraphSpec) -> list[str]:
    """Resume-boundary rules for every node carrying a ``resume_key``."""
    problems: list[str] = []
    for node in spec.schedule:
        if node.resume_key is None:
            continue
        if not any(
            spec.edges[e].placement == "disk" for e in node.outputs
            if e in spec.edges
        ):
            problems.append(
                f"resume node {node.name!r} produces no disk-placed edge "
                "to checkpoint"
            )
        if node.resume_reload is None and node.resume_provides:
            problems.append(
                f"resume node {node.name!r} declares resume_provides but "
                "no resume_reload to rebuild them"
            )
        for e in spec.crossing_edges(node.name):
            placement = spec.edges[e].placement if e in spec.edges else "?"
            if placement == "hbm" and e not in node.resume_provides:
                # an hbm crossing edge IS allowed when the reload rebuilds
                # it (re-encode + re-upload from the disk artifact) — that
                # is how the device-resident round1→round2 hand-off
                # coexists with the round-1 checkpoint. Uncovered device
                # memory still cannot survive a restart.
                problems.append(
                    f"hbm edge {e!r} crosses the disk-resume boundary of "
                    f"node {node.name!r} but its reload does not provide "
                    "it (device memory cannot survive a restart)"
                )
            elif e not in node.resume_provides:
                problems.append(
                    f"edge {e!r} crosses the resume boundary of node "
                    f"{node.name!r} but its reload does not provide it"
                )
    return problems
