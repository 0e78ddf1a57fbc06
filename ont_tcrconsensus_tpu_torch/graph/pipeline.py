"""The production library graph: round1→round2 declared as nodes/edges.

A copy of the JAX package's ``graph/pipeline.py``: the same nodes, edges
and placements, so graftcheck's verdict and the telemetry's graph section
are the JAX run's.  :func:`build_library_graph` is the single place the
pipeline's dataflow shape lives.  Placements are the JAX package's memory
story: the two read stores and the consensus hand-offs are ``hbm`` (the
executor drops them right after their last consumer, which is what makes
donation safe), orchestration values are ``host``, and the two checkpoint
artifacts (merged consensus fasta, counts CSV) are ``disk`` — the only
placement a resume can reload.  In the port the read stores are numpy
columnar blocks that each device pass uploads, so an ``hbm`` edge here
names the value's role, not where its bytes are.

Which nodes run off the critical path is *derived*, not configured: the
error-profile passes and the intermediate region fastas produce edges
nothing consumes, so :meth:`GraphSpec.side_sinks` routes them through the
shared worker pool automatically.  ``overlap_qc`` only decides whether a
worker pool exists at all.

Conditional stages (error profiling, intermediate fastas) are included
or excluded at build time from the config, so the built graph never
contains dangling edges.  Module scope is torch-free: the graph builds
and validates without a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ont_tcrconsensus_tpu_torch.graph import nodes as N
from ont_tcrconsensus_tpu_torch.graph.ir import GraphBuilder, GraphSpec
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig


@dataclasses.dataclass
class LibraryContext:
    """Per-library invariants shared by every node (the values the
    imperative path threaded positionally; ``device`` is the run's torch
    device), plus the degradation lists the graceful-skip paths append
    to."""

    cfg: Any
    lay: Any
    timer: Any
    device: Any = None
    panel: Any = None
    engine: Any = None
    engine_notrim: Any = None
    blast_id_threshold: float = 0.0
    overlap_consensus: int = 0
    polisher: Any = None
    read_batch: int = 0
    budget: Any = None
    failed_groups: list = dataclasses.field(default_factory=list)
    failed_regions: list = dataclasses.field(default_factory=list)
    # sharded-execution hooks (filled by pipeline/run.py on mesh-armed
    # runs): the executor publishes each node's paired in/out sharding
    # axes here before the body runs, and calls ``remesh(node, exc)`` when
    # a device_lost escapes a node; the hook moves both engines onto the
    # surviving slices, rescales the budget and the read batch, and
    # returns the degradation detail (None when the data axis is 1)
    node_shardings: Any = None
    remesh: Any = None


def build_library_graph(cfg: RunConfig) -> GraphSpec:
    b = GraphBuilder("library")
    b.input("library_fastq", "disk")
    # Both device stores are batch-sharded over a mesh's data axis:
    # producer out specs equal consumer in specs by construction, so
    # stage boundaries never reshard; graftcheck's reshard-site lint is
    # the hard gate (the executor refuses a graph whose declared
    # shardings disagree across any node).
    b.edge("read_store", "hbm", sharding="data")
    # meta host edges carry orchestration values (stats, groupings,
    # selections) whose host residency is by design: graftcheck's
    # round-trip analysis skips them, the transfer ledger still measures
    # their bytes per edge — an auditable declaration, not a waiver
    b.edge("align_stats", "host", meta=True)
    b.edge("region_groups", "host", meta=True)
    b.edge("records_by_group", "host", meta=True)
    b.edge("selected_by_group", "host", meta=True)
    # the round1→round2 data plane stays device-resident: polished
    # consensus codes flow as hbm edges (r1_polished -> cons_codes ->
    # round2's fused assign) and only the merged-fasta artifact boundary
    # decodes to strings
    b.edge("r1_polished", "hbm", sharding="data")
    b.edge("merged_consensus", "host")
    b.edge("merged_fasta", "disk")
    b.edge("cons_codes", "hbm", sharding="data")
    b.edge("cons_store", "hbm", sharding="data")
    b.edge("region_records", "host", meta=True)
    b.edge("selected_by_region", "host", meta=True)
    b.edge("region_counts", "host")
    b.edge("counts_csv", "disk")
    if cfg.error_profile_sample:
        b.edge("r1_qc_profile", "host")
        b.edge("r2_qc_profile", "host")
    if cfg.write_intermediate_fastas:
        b.edge("region_cluster_fastas", "disk")

    b.add_node(
        "round1_fused_assign", N.round1_fused_assign,
        inputs=("library_fastq",), outputs=("read_store", "align_stats"),
    )
    if cfg.error_profile_sample:
        b.add_node(
            "round1_error_profile", N.round1_error_profile,
            inputs=("read_store",), outputs=("r1_qc_profile",),
            commit=N.commit_round1_error_profile,
            units=lambda ctx, inputs: ctx.cfg.error_profile_sample,
        )
    b.add_node(
        "round1_region_split", N.round1_region_split,
        inputs=("read_store", "align_stats"), outputs=("region_groups",),
    )
    if cfg.write_intermediate_fastas:
        b.add_node(
            "write_region_fastas", N.write_region_fastas,
            inputs=("read_store", "region_groups"),
            outputs=("region_cluster_fastas",),
        )
    b.add_node(
        "round1_umi_records", N.round1_umi_records,
        inputs=("read_store", "region_groups"), outputs=("records_by_group",),
    )
    b.add_node(
        "round1_umi_cluster", N.round1_umi_cluster,
        inputs=("records_by_group",), outputs=("selected_by_group",),
        units=lambda ctx, inputs: sum(
            len(u) for _, u in inputs["records_by_group"]
        ),
    )
    b.add_node(
        "round1_polish", N.round1_polish,
        inputs=("read_store", "selected_by_group"), outputs=("r1_polished",),
        units=lambda ctx, inputs: sum(
            len(s) for _, s in inputs["selected_by_group"]
        ),
    )
    b.add_node(
        "round1_consensus", N.round1_consensus,
        inputs=("selected_by_group", "r1_polished"),
        outputs=("merged_consensus", "merged_fasta", "cons_codes"),
        resume_key="round1_consensus",
        resume_probe=N.round1_resume_probe,
        resume_reload=N.round1_resume_reload,
        # the hbm hand-off may cross the resume boundary BECAUSE the
        # reload re-encodes it from the checkpointed fasta (ir.py's
        # resume relaxation); merged_consensus rides along for the
        # artifact writers
        resume_provides=("merged_consensus", "cons_codes"),
    )
    b.add_node(
        "round2_fused_assign", N.round2_fused_assign,
        inputs=("cons_codes",), outputs=("cons_store",),
        units=lambda ctx, inputs: len(inputs["cons_codes"]),
    )
    if cfg.error_profile_sample:
        b.add_node(
            "round2_error_profile", N.round2_error_profile,
            inputs=("cons_store",), outputs=("r2_qc_profile",),
            commit=N.commit_round2_error_profile,
            units=lambda ctx, inputs: ctx.cfg.error_profile_sample,
        )
    b.add_node(
        "round2_umi_records", N.round2_umi_records,
        inputs=("cons_store",), outputs=("region_records",),
    )
    b.add_node(
        "round2_umi_cluster", N.round2_umi_cluster,
        inputs=("region_records",), outputs=("selected_by_region",),
        units=lambda ctx, inputs: sum(
            len(u) for _, u in inputs["region_records"]
        ),
    )
    b.add_node(
        "round2_counts", N.round2_counts,
        inputs=("cons_store", "selected_by_region"),
        outputs=("region_counts", "counts_csv"),
        checkpoint=True,
    )
    b.result("region_counts")
    return b.build()
