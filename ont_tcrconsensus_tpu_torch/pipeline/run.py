"""The end-to-end two-round UMI consensus pipeline, on one device.

The counterpart of the JAX package's ``pipeline/run.py`` one-shot run, in
its imperative stage order (which the JAX package pins byte-identical to
its graph executor, so ``executor`` "graph" and "imperative" both run it):

  PHASE A (once):  reference self-homology -> region clusters + precision bar
  PHASE B (per library): fused read pass (primer trim -> EE filter ->
                   align -> UMI locate) -> split by region cluster
  round 1:         UMI cluster @0.93 -> subread select -> batched consensus
                   -> bi-GRU polish (``polish_method: "rnn"``, the default)
  round 2:         consensus align + blast-id filter -> split by region ->
                   UMI cluster @0.97 -> select(min=1) -> counts CSV

Every device pass runs on ``device``: CUDA unless the caller asks for the
CPU, and a CUDA request without a card raises.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import shutil
import sys
import time

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.cluster import regions as regions_mod
from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.io import bucketing, fastx, layout
from ont_tcrconsensus_tpu_torch.parallel import budget as budget_mod
from ont_tcrconsensus_tpu_torch.pipeline import stages
from ont_tcrconsensus_tpu_torch.pipeline.assign import AssignEngine, ReferencePanel, run_assign
from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

# fallback precision bar when no reference pair survives the homology filter
DEFAULT_BLAST_ID_BAR = 0.99

# knobs that change results and that later slices of the port implement
_NOT_YET = (
    ("mesh_shape", bool, "mesh_shape needs the multi-GPU mesh slice of the port"),
    ("distributed", bool, "distributed needs the multi-GPU mesh slice of the port"),
    ("resume", bool, "resume needs the robustness slice of the port"),
    ("chaos", bool, "chaos needs the robustness slice of the port"),
    ("on_bad_record", lambda v: v != "fail",
     "on_bad_record quarantine/drop needs the robustness slice of the port"),
)
# knobs that only add observation artifacts, with their "off" values:
# accepted, not written yet
_OBSERVATION_ONLY = (
    ("telemetry", "off"), ("live_port", None), ("profile_trace_dir", None),
    ("history_ledger", None), ("error_profile_sample", 0),
    ("compare_umi_overlap_between_regions", False),
)


def _log(*parts):
    print(*parts, file=sys.stderr)


class StageClock:
    """Adds each stage's wall seconds to ``timings`` when one is given.

    The device is synchronized at a stage's end, so work it queued counts
    to that stage; with ``timings`` None the clock does nothing.
    """

    def __init__(self, timings: dict[str, float] | None, device: torch.device):
        self.timings = timings
        self.device = device

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if self.timings is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[stage] = self.timings.get(stage, 0.0) + time.perf_counter() - t0


def check_supported(cfg: RunConfig) -> None:
    """Raise NotImplementedError for knobs this slice does not implement."""
    for name, active, why in _NOT_YET:
        if active(getattr(cfg, name)):
            raise NotImplementedError(why)


def run_pipeline(config_path: str, device: str | torch.device | None = None):
    """Run the pipeline from a JSON config; {library: {region: count}}."""
    return run_with_config(RunConfig.from_json(config_path), device=device)


def run_with_config(cfg: RunConfig, device: str | torch.device | None = None,
                    timings: dict[str, float] | None = None,
                    ) -> dict[str, dict[str, int]]:
    """Run the full pipeline; returns {library: {region: count}}.

    ``timings``, when given, receives each stage's wall seconds
    (:class:`StageClock`).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    clock = StageClock(timings, dev)
    polisher = _rnn_polisher(cfg, dev) if cfg.polish_method == "rnn" else None
    observed = [k for k, off in _OBSERVATION_ONLY if getattr(cfg, k) != off]
    if observed:
        _log(f"note: {observed} accepted; the port does not write their artifacts yet")
    reference = fastx.read_fasta_dict(cfg.reference_file)
    nano_dir = os.path.join(cfg.fastq_pass_dir, "nano_tcr")
    if os.path.exists(nano_dir):
        raise FileExistsError(f"{nano_dir} exists; remove it to rerun")
    os.makedirs(nano_dir)

    # PHASE A: reference self-homology
    _log("Mapping reference self homology")
    with clock("self_homology"):
        homology = regions_mod.self_homology_map(reference, cfg.cluster_identity, device=dev)
    with open(os.path.join(nano_dir, "region_cluster_dict.json"), "w") as fh:
        json.dump(homology.region_cluster, fh, indent=4)
    with open(os.path.join(nano_dir, "self_homology_stats.json"), "w") as fh:
        json.dump(homology.stats, fh, indent=4)
    blast_id_threshold = cfg.blast_id_threshold
    overlap_consensus = cfg.minimal_region_overlap_consensus
    if blast_id_threshold is None:
        blast_id_threshold = (homology.max_blast_id if homology.max_blast_id is not None
                              else DEFAULT_BLAST_ID_BAR)
    if overlap_consensus is None:
        overlap_consensus = (homology.max_blast_id if homology.max_blast_id is not None
                             else cfg.minimal_region_overlap)
    if cfg.only_run_reference_self_homology:
        return {}

    panel = ReferencePanel.build(reference, homology.region_cluster, device=dev)
    budget = budget_mod.BudgetModel(
        cfg.hbm_budget_gb if cfg.hbm_budget_gb is not None
        else budget_mod.detect_hbm_gb(dev)
    )
    read_batch = cfg.read_batch_size or budget.read_batch(
        cfg.max_read_length, num_refs=max(len(panel.names), 1),
        band_width=cfg.sw_band_width,
    )
    _log(f"Device batching: read_batch={read_batch}, budget={budget.hbm_gb:.1f} GB on {dev}")
    engine = AssignEngine(
        panel, cfg.umi_fwd, cfg.umi_rev, primers=cfg.primer_sequences(),
        primer_max_dist_frac=cfg.primer_max_dist_frac,
        a5=cfg.max_softclip_5_end, a3=cfg.max_softclip_3_end,
        trim_window=cfg.trim_window, band_width=cfg.sw_band_width,
        fast_denom=4 if cfg.round1_fast_assign else 0, device=dev,
    )
    # round 2 aligns already-trimmed consensus sequences: no primer search
    engine_notrim = AssignEngine(
        panel, cfg.umi_fwd, cfg.umi_rev, primers=[],
        a5=cfg.max_softclip_5_end, a3=cfg.max_softclip_3_end,
        band_width=cfg.sw_band_width, device=dev,
    )

    fastq_list = sorted(glob.glob(os.path.join(cfg.fastq_pass_dir, "barcode*", "*fastq*")))
    if not fastq_list:
        fastq_list = sorted(glob.glob(os.path.join(cfg.fastq_pass_dir, "*.fastq*")))
    if not fastq_list:
        raise FileNotFoundError(f"no fastq files under {cfg.fastq_pass_dir}")
    results: dict[str, dict[str, int]] = {}
    for fastq in fastq_list:
        lay = layout.init_library_dir(fastq, nano_dir)
        results[lay.library] = _run_library(
            fastq, lay, cfg, panel, engine, engine_notrim, blast_id_threshold,
            overlap_consensus, read_batch, budget, clock, polisher,
        )
    _log("Done running all barcodes!")
    return results


def _rnn_polisher(cfg: RunConfig, dev: torch.device):
    """The bi-GRU polisher of ``polish_method: "rnn"``, or None (vote
    consensus only) when no weights are bundled."""
    from ont_tcrconsensus_tpu_torch.models import polisher as polisher_mod

    params = polisher_mod.load_default_params()
    if params is None:
        _log("polish_method=rnn but no bundled weights; using vote consensus only")
        return None
    # the depth-2 pass only where selection can emit 2-member clusters
    low_params = (
        polisher_mod.load_low_depth_params()
        if cfg.low_depth_polish and cfg.min_reads_per_cluster <= 2 else None
    )
    if cfg.polish_bf16:
        _log("polisher: serving float32 (bf16 serving needs an exactness A/B "
             "certificate for this card, which the port does not have yet)")
    return polisher_mod.make_pipeline_polisher(
        params, min_polish_depth=cfg.min_polish_depth,
        low_depth_params=low_params, device=dev,
    )


def _run_library(fastq, lay, cfg, panel, engine, engine_notrim, blast_id_threshold,
                 overlap_consensus, read_batch, budget, clock, polisher) -> dict[str, int]:
    library = lay.library
    dev = clock.device
    merged_path = os.path.join(lay.fasta, "merged_consensus.fasta")

    # PHASE B + round-1 assignment: one fused pass per batch
    _log("Preprocessing, aligning and UMI-tagging nanopore reads:", library)
    with clock("assign_round1"):
        store, astats = run_assign(
            fastq, engine,
            max_ee_rate=cfg.max_ee_rate_base,
            min_len=cfg.minimal_length,
            minimal_region_overlap=cfg.minimal_region_overlap,
            max_softclip_5_end=cfg.max_softclip_5_end,
            max_softclip_3_end=cfg.max_softclip_3_end,
            batch_size=read_batch,
            max_read_length=cfg.max_read_length,
            subsample=cfg.dorado_trim_subsample_fastq,
        )
    with open(os.path.join(lay.logs, "ee_filter.log"), "w") as fh:
        fh.write(f"reads passing EE/length filter: {astats.n_total - astats.n_ee_fail}\n")
        fh.write(f"reads with primer trim: {astats.n_trimmed}\n")
    _write_align_log(astats, os.path.join(lay.logs, f"{library}_region_cluster_split.log"))

    groups = stages.group_by_region_cluster(store, panel)
    if cfg.write_intermediate_fastas:
        stages.write_region_fastas(groups, store, lay.region_cluster_fasta, "region_cluster")

    # round 1: UMI records per region cluster, ONE batched clustering pass,
    # then ONE library-wide batched consensus polish
    records_by_group: list[tuple[str, list]] = []
    for cluster_key in sorted(groups):
        group_name = f"region_cluster{cluster_key}"
        umis = stages.build_umi_records(store, groups[cluster_key], cfg.max_pattern_dist)
        if not umis:
            continue
        if cfg.write_intermediate_fastas:
            stages.write_umi_fasta(
                umis, store, os.path.join(lay.umi_fasta, f"{group_name}_detected_umis.fasta")
            )
        records_by_group.append((group_name, umis))
    with clock("umi_cluster_round1"):
        grouped = stages.cluster_and_select_grouped(
            records_by_group,
            identity=cfg.vsearch_identity,
            min_umi_length=cfg.min_umi_length,
            max_umi_length=cfg.max_umi_length,
            min_reads_per_cluster=cfg.min_reads_per_cluster,
            max_reads_per_cluster=cfg.max_reads_per_cluster,
            balance_strands=cfg.balance_strands,
            device=dev,
        )
    selected_by_group: list[tuple[str, list[stages.SelectedCluster]]] = []
    for group_name, _ in records_by_group:
        selected, stat_rows = grouped[group_name]
        cdir = os.path.join(lay.clustering, group_name)
        os.makedirs(cdir, exist_ok=True)
        stages.write_cluster_stats_tsv(stat_rows, os.path.join(cdir, "vsearch_cluster_stats.tsv"))
        if selected:
            selected_by_group.append((group_name, selected))
    n_clusters = sum(len(s) for _, s in selected_by_group)
    _log(f"Polishing clusters: {library} "
         f"({n_clusters} clusters over {len(selected_by_group)} region clusters)")
    with clock("polish"):
        by_group = stages.polish_clusters_all(
            selected_by_group, store, max_read_length=cfg.max_read_length,
            polisher=polisher, budget=budget, cluster_batch=cfg.cluster_batch_size,
            device=dev,
        )
    merged_consensus: list[tuple[str, str]] = []
    for group_name, _ in selected_by_group:
        merged_consensus.extend(by_group[group_name])
    fastx.write_fasta(merged_path, merged_consensus)
    lay.mark_stage_done("round1_consensus", artifacts=[merged_path])
    return _run_round2(lay, cfg, panel, engine_notrim, blast_id_threshold,
                       overlap_consensus, merged_consensus, read_batch, clock)


_R2_HEADER = re.compile(r"^region_cluster(\d+)_cluster\d+_\d+$")


def _targeted_round2_dispatch(panel, engine, headers):
    """The round-2 targeted dispatcher: each consensus header carries its
    round-1 region cluster, so round 2 aligns it only against that
    cluster's references. ``(dispatch, None)``, or ``(None, reason)`` when
    the targeted pass is unavailable (then the full fused pass runs)."""
    cluster_refs: dict[int, np.ndarray] = {}
    for k in np.unique(panel.cluster_of_region):
        cluster_refs[int(k)] = np.where(panel.cluster_of_region == k)[0].astype(np.int32)

    def cluster_of(name: str) -> int | None:
        m = _R2_HEADER.match(name.partition(" ")[0])
        if m is None:
            return None
        k = int(m.group(1))
        return k if k in cluster_refs else None

    seen: set[int] = set()
    for h in headers:
        k = cluster_of(h)
        if k is None:
            return None, f"header {h.partition(' ')[0]!r} lacks cluster provenance"
        seen.add(k)
    if not seen:
        return None, "no consensus sequences"
    max_c = bucketing.pow2_ceil(max(len(cluster_refs[k]) for k in seen))
    if max_c > 8:
        return None, f"largest region cluster has >8 refs (max_c={max_c})"

    def dispatch(batch, max_ee_rate, min_len):
        cand = np.full((len(batch.ids), max_c), -1, np.int32)
        for row, (nm, v) in enumerate(zip(batch.ids, batch.valid)):
            if v:
                refs = cluster_refs[cluster_of(nm)]
                cand[row, : len(refs)] = refs
        return engine.run_batch_targeted(batch, cand, min_len=min_len)

    return dispatch, None


def _run_round2(lay, cfg, panel, engine_notrim, blast_id_threshold, overlap_consensus,
                merged_consensus, read_batch, clock) -> dict[str, int]:
    library = lay.library
    _log("Aligning unique molecule consensus TCR sequences:", library)
    cons_records = [fastx.FastxRecord(h, "", s) for h, s in merged_consensus]
    dispatch = None
    if cfg.round2_targeted_assign:
        dispatch, why_not = _targeted_round2_dispatch(
            panel, engine_notrim, (h for h, _ in merged_consensus)
        )
        if dispatch is None:
            _log(f"round 2: targeted assign unavailable ({why_not}); "
                 "falling back to the full fused assign")
    with clock("assign_round2"):
        cons_store, _ = run_assign(
            cons_records, engine_notrim,
            max_ee_rate=1.0,  # no quality data on consensus sequences
            min_len=1,
            minimal_region_overlap=overlap_consensus,
            max_softclip_5_end=cfg.max_softclip_5_end,
            max_softclip_3_end=cfg.max_softclip_3_end,
            batch_size=read_batch,
            max_read_length=cfg.max_read_length,
            blast_id_threshold=blast_id_threshold,
            dispatch=dispatch,
        )
    region_groups = stages.group_by_region(cons_store, panel)
    if cfg.write_intermediate_fastas:
        stages.write_region_fastas(region_groups, cons_store, lay.region_fasta, "region_")

    # round 2: UMI dedup at consensus identity, one batched pass
    region_records: list[tuple[str, list]] = []
    for region, parts in sorted(region_groups.items()):
        umis = stages.build_umi_records(cons_store, parts, cfg.max_pattern_dist)
        if not umis:
            continue
        if cfg.write_intermediate_fastas:
            stages.write_umi_fasta(
                umis, cons_store,
                os.path.join(lay.consensus_umi_fasta, f"region_{region}_detected_umis.fasta"),
            )
        region_records.append((region, umis))
    with clock("umi_cluster_round2"):
        grouped2 = stages.cluster_and_select_grouped(
            region_records,
            identity=cfg.vsearch_identity_consensus,
            min_umi_length=cfg.min_umi_length,
            max_umi_length=cfg.max_umi_length,
            min_reads_per_cluster=1,
            max_reads_per_cluster=cfg.max_reads_per_cluster,
            balance_strands=False,
            device=clock.device,
        )
    region_counts: dict[str, int] = {}
    for region, _ in region_records:
        selected, stat_rows = grouped2[region]
        rdir = os.path.join(lay.clustering_consensus, f"region_{region}")
        os.makedirs(rdir, exist_ok=True)
        stages.write_cluster_stats_tsv(stat_rows, os.path.join(rdir, "vsearch_cluster_stats.tsv"))
        if cfg.write_intermediate_fastas:
            fastx.write_fasta(os.path.join(rdir, "smolecule_clusters.fa"), [
                (str(cl.cluster_id), cons_store.blocks[m.block].decode_one(m.row))
                for cl in selected for m in cl.members
            ])
        # count = round-2 clusters (unique molecules)
        region_counts[region] = len(selected)

    counts_csv = stages.write_counts_csv(region_counts, lay.counts)
    lay.mark_stage_done("counts", artifacts=[counts_csv])
    if cfg.delete_tmp_files:
        for d in (lay.region_cluster_fasta, lay.clustering, lay.umi_fasta,
                  lay.fasta, lay.clustering_consensus, lay.region_fasta,
                  lay.consensus_umi_fasta):
            shutil.rmtree(d, ignore_errors=True)
    return region_counts


def _write_align_log(stats, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(f"Total # primary alignments: {stats.n_aligned}\n")
        fh.write(f"n_total: {stats.n_total}\n")
        fh.write(f"n_ee_fail: {stats.n_ee_fail}\n")
        fh.write(f"n_trimmed: {stats.n_trimmed}\n")
        fh.write(f"n_short: {stats.n_short}\n")
        fh.write(f"n_long: {stats.n_long}\n")
        fh.write(f"n_pass: {stats.n_pass}\n")
