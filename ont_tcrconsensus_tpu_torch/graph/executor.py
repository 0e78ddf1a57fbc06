"""Topological executor for a validated :class:`~.ir.GraphSpec`.

A copy of the JAX package's ``graph/executor.py``, the port's default
per-library scheduler (``executor: "graph"``). The executor walks the
schedule and attaches every cross-cutting layer per node instead of per
call site:

- **obs / timing** — each critical node body runs inside
  ``timer.stage(node.name)`` (one clock read feeds the trace span, the
  metrics stage table, and the stage-timing TSV) and per-node
  critical-vs-overlapped seconds land in the telemetry ``graph`` section;
- **watchdog** — ``watchdog.guard(node.name, units=...)`` with units
  evaluated from the node's declaration, so deadlines scale with the
  declared workload;
- **chaos** — ``faults.inject("graph.node")`` fires at every critical
  node body (the per-node generalization of the hand-placed sites);
- **overlap** — any node the spec derives as a *side sink* (nothing
  consumes its outputs; see :meth:`GraphSpec.is_side_sink`) is submitted
  to the shared :class:`~..pipeline.overlap.StageExecutor` worker pool
  and committed at the next checkpoint barrier, with the imperative
  path's transient-recovery semantics (classify → rerun on the main
  thread → record recovered);
- **resume** — the deepest completed resume node is verified against the
  manifest (sha256, honoring ``verify_resume``), its skip closure is
  recorded as skipped, and its reload reconstructs every crossing edge
  from disk;
- **residency** — edge values are dropped from the executor's table the
  moment their last consumer finishes, so ``hbm``-placed edges live
  exactly from producer to last consumer and become donation-safe
  immediately after.  With telemetry armed, the inputs at their drop
  point are probed around the node (:func:`..obs.transfers.audit_donation`)
  and every node boundary samples the allocator
  (:func:`..obs.transfers.node_hbm_boundary`).
"""

from __future__ import annotations

import sys
import time
from typing import Any

from ont_tcrconsensus_tpu_torch.graph import check as graph_check
from ont_tcrconsensus_tpu_torch.graph.ir import GraphSpec, Node
from ont_tcrconsensus_tpu_torch.obs import live as obs_live
from ont_tcrconsensus_tpu_torch.obs import metrics as obs_metrics
from ont_tcrconsensus_tpu_torch.obs import transfers as obs_transfers
from ont_tcrconsensus_tpu_torch.robustness import faults, retry, watchdog


def _log(*parts: object) -> None:
    print(*parts, file=sys.stderr)


def verify_resume_stage(lay, stage: str, cfg) -> bool:
    """Manifest-v2 verification gate shared by both executors: returns
    True when the stage's recorded artifacts check out under
    ``cfg.verify_resume``; on failure records an integrity event and
    tells the caller to re-run instead of trusting the artifact."""
    ok, why = lay.verify_stage(stage, cfg.verify_resume)
    if ok:
        return True
    retry.recorder().record(
        "resume.verify", classification="integrity", outcome="rerun",
        error=why or "",
        detail={"library": lay.library, "stage": stage,
                "mode": cfg.verify_resume},
    )
    _log(f"WARNING: resume verification failed for {lay.library} stage "
         f"{stage!r} ({why}); re-running instead of trusting the artifact")
    return False


class GraphExecutor:
    """Runs one :class:`GraphSpec` over a context object.

    ``ctx`` must expose ``cfg`` (the run config), ``timer`` (a
    :class:`~..qc.timing.StageTimer`) and ``lay`` (a library layout, or
    None outside a library run); node bodies may require more.
    ``side_exec`` is an optional :class:`StageExecutor` — without one,
    side sinks run synchronously at their schedule position, which is
    exactly the imperative ``overlap_qc: false`` behavior.
    """

    def __init__(self, spec: GraphSpec, ctx: Any, side_exec=None):
        self.spec = spec
        self.ctx = ctx
        self.side_exec = side_exec
        self._pending: list[tuple[Node, Any]] = []
        # host-placed edges on graftcheck's round-trip paths; filled per
        # run() when telemetry is armed (obs/transfers.py data plane)
        self._rt_edges: set[str] = set()

    def run(self, inputs: dict) -> dict:
        spec, ctx = self.spec, self.ctx
        missing = sorted(e for e in spec.inputs if e not in inputs)
        if missing:
            raise ValueError(f"graph {spec.name!r}: missing inputs {missing}")
        for name in sorted(spec.edges):
            obs_metrics.graph_edge_set(name, spec.edges[name].placement)
        for node in spec.schedule:
            # declared structure into telemetry: obs/critical_path.py
            # rebuilds the executed DAG (slack, what-if) from the artifact
            obs_metrics.graph_node_declare(
                node.name, inputs=node.inputs, outputs=node.outputs)

        # live /progress denominator: every scheduled node, before any
        # skip accounting, so done/total is stable across resume paths
        obs_live.progress_plan([n.name for n in spec.schedule])

        # data-plane tap: edges whose values leave the device and come
        # back (graftcheck's static round-trip paths) charge the
        # run-level host_round_trip_bytes ledger as they materialize
        self._rt_edges = (graph_check.round_trip_edges(spec)
                          if obs_metrics.armed() else set())

        # sharded execution: when the context's engine carries a device
        # mesh, the declared Edge.sharding specs become the plan, paired
        # in/out axes per node, derived once here and published per node
        # as ``ctx.node_shardings``.  The reshard-pairing proof is a hard
        # gate: a graph whose declared shardings disagree across any node
        # is refused outright instead of being resharded behind its back.
        self._shard_plan = self._mesh_setup()

        skip, resume_node = self._resume_scan()
        values = dict(inputs)
        refs: dict[str, int] = {}
        for node in spec.schedule:
            if node.name in skip:
                continue
            for e in node.inputs:
                refs[e] = refs.get(e, 0) + 1

        for node in spec.schedule:
            if node.name in skip:
                obs_metrics.graph_node_skip(node.name)
                obs_live.progress_node_skip(node.name)
                continue
            if node is resume_node:
                # reload crossing edges from disk instead of running
                values.update(node.resume_reload(ctx) if node.resume_reload
                              else {})
                obs_metrics.graph_node_skip(node.name)
                obs_live.progress_node_skip(node.name)
                continue
            node_inputs = {e: values[e] for e in node.inputs}
            units = node.eval_units(ctx, node_inputs)
            obs_metrics.graph_node_declare(node.name, units=units)
            if self.side_exec is not None and spec.is_side_sink(node):
                deferred = self.side_exec.submit(
                    node.name, node.fn, ctx, node_inputs, units=units,
                )
                self._pending.append((node, deferred))
                continue
            if node.checkpoint:
                self._commit_pending(values, refs)
            audit = self._donation_probe(node, values, refs)
            self._set_node_shardings(node)
            outputs = self._run_node_degradable(node, node_inputs, units)
            if audit:
                out_probe = obs_transfers.buffer_probe(outputs)
                for e, probe in audit.items():
                    # re-probe the input AFTER the call: a buffer that
                    # now reads deleted was taken (donated) even when the
                    # output landed at a different address
                    post = obs_transfers.buffer_probe(values.get(e))
                    obs_transfers.audit_donation(e, node.name, probe,
                                                 out_probe, post)
            self._absorb(node, outputs, values, refs)
        self._commit_pending(values, refs)
        return {e: values[e] for e in spec.results}

    # -- internals ---------------------------------------------------------

    def _resume_scan(self) -> tuple[set[str], Node | None]:
        """Deepest completed+verified resume node → (skip closure, node);
        the resume node itself stays in the closure set but is handled
        specially in :meth:`run` (reload instead of skip)."""
        ctx = self.ctx
        cfg, lay = ctx.cfg, ctx.lay
        if lay is None or not getattr(cfg, "resume", False):
            return set(), None
        for node in reversed(self.spec.schedule):
            if node.resume_key is None or not lay.stage_done(node.resume_key):
                continue
            probe = node.resume_probe(ctx) if node.resume_probe else None
            if node.resume_probe is not None and probe is None:
                continue  # recorded done but artifact is gone: re-run
            if probe:
                faults.corrupt_artifact("resume.verify", probe)
            if verify_resume_stage(lay, node.resume_key, cfg):
                closure = self.spec.skip_closure(node.name)
                closure.discard(node.name)
                return closure, node
        return set(), None

    def _donation_probe(self, node: Node, values: dict,
                        refs: dict[str, int]) -> dict:
        """Buffer-identity probes for this node's hbm inputs at their
        drop point (live ref count 1: this node is the last consumer —
        the same eligibility rule graftcheck derives statically), taken
        BEFORE the node runs so a donated-then-reused pointer is still
        readable. Empty when telemetry is off."""
        if not obs_metrics.armed():
            return {}
        spec = self.spec
        return {
            e: obs_transfers.buffer_probe(values.get(e))
            for e in node.inputs
            if (refs.get(e, 0) == 1 and e in spec.edges
                and spec.edges[e].placement == "hbm"
                and e not in spec.results)
        }

    def _mesh_setup(self):
        """The per-node sharding plan when the run is mesh-armed, else
        ``None``."""
        mesh = getattr(getattr(self.ctx, "engine", None), "mesh", None)
        if mesh is None:
            return None
        bad = graph_check.reshard_sites(self.spec)
        if bad:
            raise RuntimeError(
                f"graph {self.spec.name!r} cannot run sharded: "
                + "; ".join(f.format() for f in bad)
            )
        from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

        return mesh_mod.node_sharding_plan(self.spec, mesh)

    def _set_node_shardings(self, node: Node) -> None:
        """Publish the node's paired in/out sharding axes on the context
        (``ctx.node_shardings``) before its body runs: producers place
        outputs with exactly the consumer's declared in-spec, so stage
        boundaries never reshard. Best effort: a context that rejects
        attribute assignment runs without it."""
        if self._shard_plan is None:
            return
        try:
            self.ctx.node_shardings = self._shard_plan.get(node.name)
        except Exception:
            pass

    def _run_node_degradable(self, node: Node, inputs: dict, units: int) -> dict:
        """:meth:`_run_node` plus the degraded-mesh survival loop.

        A ``device_lost`` escaping a node body means a mesh slice died
        mid-dispatch: no same-mesh retry can succeed.  When the context
        offers a ``remesh`` hook (pipeline/run.py installs one on sharded
        runs), the hook moves the engines onto the survivors, rescales the
        memory budget and the read batch, and this loop re-runs the WHOLE
        node on the degraded mesh (node bodies are pure up to their
        ``commit``, which only runs on success).  Each degradation is a
        ``mesh.degraded`` event in the robustness report and a telemetry
        count; when the data axis cannot shrink further, the fault
        propagates and the run dies honestly.
        """
        while True:
            try:
                return self._run_node(node, inputs, units)
            except Exception as exc:
                if retry.classify(exc) != "device_lost":
                    raise
                remesh = getattr(self.ctx, "remesh", None)
                detail = remesh(node.name, exc) if remesh is not None else None
                if detail is None:
                    raise
                retry.recorder().record(
                    "mesh.degraded", classification="device_lost", outcome="degraded",
                    error=repr(exc), detail={"node": node.name, **detail})
                obs_metrics.counter_add("mesh.degraded")
                obs_metrics.mesh_degraded_add("mesh.device_lost")
                self._set_node_shardings(node)
                _log(f"WARNING: mesh slice lost in node {node.name!r} ({exc!r}); "
                     f"re-dispatching on degraded mesh "
                     f"data={detail.get('data_from')}→{detail.get('data_to')}")

    def _run_node(self, node: Node, inputs: dict, units: int) -> dict:
        ctx = self.ctx
        t0 = time.monotonic()
        obs_live.progress_node_start(node.name, units=units)
        try:
            with ctx.timer.stage(node.name), \
                    watchdog.guard(node.name, units=units):
                faults.inject("graph.node")
                outputs = node.fn(ctx, inputs)
                if node.commit is not None:
                    node.commit(ctx, outputs)
        finally:
            dt = time.monotonic() - t0
            obs_metrics.graph_node_add(node.name, critical_s=dt)
            obs_live.progress_node_finish(node.name, dt, units=units)
            # node-boundary HBM sample for the --report --memory
            # reconciler (no-op off-telemetry / without memory stats)
            obs_transfers.node_hbm_boundary(node.name)
        return outputs

    def _commit_pending(self, values: dict, refs: dict[str, int]) -> None:
        if not self._pending:
            return
        ctx = self.ctx
        pending, self._pending = self._pending, []
        for node, deferred in pending:
            t0 = time.monotonic()
            try:
                outputs = self.side_exec.commit(deferred, ctx.timer)
            except Exception as exc:
                classification = retry.classify(exc)
                rec = retry.recorder()
                if classification == "fatal":
                    rec.record("overlap.worker", classification=classification,
                               outcome="fatal", error=repr(exc))
                    raise
                rec.record("overlap.worker", classification=classification,
                           outcome="retried", error=repr(exc))
                _log(f"WARNING: overlapped node {node.name} hit a "
                     f"{classification} fault ({exc!r}); recomputing on the "
                     "main thread")
                with ctx.timer.stage(node.name):
                    outputs = deferred.rerun_sync()
                rec.record("overlap.worker", classification=classification,
                           outcome="recovered", attempt=2)
            if node.commit is not None:
                node.commit(ctx, outputs)
            obs_metrics.graph_node_add(
                node.name, critical_s=time.monotonic() - t0,
                overlapped_s=deferred.worker_seconds)
            obs_live.progress_node_finish(node.name, deferred.worker_seconds)
            _log(f"graph: {node.name} computed off the critical path "
                 f"({deferred.worker_seconds:.1f}s overlapped)")
            self._absorb(node, outputs, values, refs)

    def _absorb(self, node: Node, outputs: dict, values: dict,
                refs: dict[str, int]) -> None:
        if outputs is None:
            outputs = {}
        got, want = set(outputs), set(node.outputs)
        if got != want:
            raise RuntimeError(
                f"node {node.name!r} returned edges {sorted(got)}, "
                f"declared {sorted(want)}"
            )
        values.update(outputs)
        if obs_metrics.armed():
            for e, v in outputs.items():
                if e in self.spec.edges:
                    obs_transfers.edge_materialized(
                        e, self.spec.edges[e].placement, v,
                        round_trip=e in self._rt_edges)
        for e in node.inputs:
            refs[e] = refs.get(e, 1) - 1
            if refs[e] <= 0 and e not in self.spec.results:
                # last consumer done: drop the value so hbm edges free
                # device memory (donation-safe) as early as possible
                values.pop(e, None)
