"""Declarative stage dataflow graph: the port's default executor.

A copy of the JAX package's ``graph/`` package. The pipeline's round1→round2 stage chain is declared as a graph of nodes
(stages with typed inputs/outputs, workload units, resume keys) connected
by edges (named artifacts with a placement of ``hbm`` / ``host`` /
``disk``).  :mod:`.ir` holds the IR and the validating builder,
:mod:`.nodes` the stage bodies, :mod:`.pipeline` the production graph
declaration, and :mod:`.executor` the topological scheduler that runs it
— attaching watchdog guards, chaos injection, obs spans/metrics, and
manifest-v2 resume per node instead of per call site, and deriving which
nodes run off the critical path from edge consumption alone (subsuming
overlap.py's hand-wired QC special case).

Everything here except the node *bodies* is torch-free, so graphs build
and check on a host without a device.

``GRAPH_NODES`` is the closed vocabulary of production node names, the
JAX package's.
"""

GRAPH_NODES = frozenset({
    # round 1
    "round1_fused_assign",
    "round1_error_profile",
    "round1_region_split",
    "write_region_fastas",
    "round1_umi_records",
    "round1_umi_cluster",
    "round1_polish",
    "round1_consensus",
    # round 2
    "round2_fused_assign",
    "round2_error_profile",
    "round2_umi_records",
    "round2_umi_cluster",
    "round2_counts",
})

KNOWN_NODES = GRAPH_NODES  # public alias; see module docstring
