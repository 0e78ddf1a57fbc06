"""Stage bodies for the production library graph.

The JAX package's ``graph/nodes.py`` on the port's stage functions. Each
node function is a transcription of the corresponding segment of the
imperative path (``pipeline/run.py``) — same calls, same artifacts, same
chaos plants, same degradation semantics — minus the scheduling concerns
(timing, watchdog guards, overlap submission, checkpoint barriers), which
the graph executor attaches from the node declarations instead.

Module scope is torch-free (the graph builds and validates without a
device); the pipeline modules are imported inside the bodies. Pipeline
functions are called as ``stages.<fn>`` module attributes, not
from-imports, so a test's monkeypatch on :mod:`..pipeline.stages` hits
both executors.

The context object (``graph.pipeline.LibraryContext``) carries the
per-library invariants the imperative path passed positionally: config,
layout, device, reference panel, engines, thresholds, polisher, batching
and the shared ``failed_groups`` / ``failed_regions`` degradation lists.

One difference from the JAX package: its ``round1_polish`` forwards the
executor's donation plan (``ctx.donate_edges``) to ``donate_argnums`` of
the per-round uploads. A chunk's tensors in the port are private to its
dispatch and freed when it returns, so there is nothing to donate; the
executor's donation audit still probes the node.
"""

from __future__ import annotations

import os
import sys


def _log(*parts: object) -> None:
    print(*parts, file=sys.stderr)


# -- round 1 ---------------------------------------------------------------


def round1_fused_assign(ctx, inputs: dict) -> dict:
    """One fused pass per batch (trim -> EE -> align -> UMI locate),
    transient-retried, with ingest quarantine when configured."""
    from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod
    from ont_tcrconsensus_tpu_torch.pipeline import stages
    from ont_tcrconsensus_tpu_torch.robustness import faults, retry

    cfg, lay = ctx.cfg, ctx.lay
    library = lay.library
    _log("Preprocessing, aligning and UMI-tagging nanopore reads:", library)
    fastq = faults.mutate_input("ingest.library_fastq", inputs["library_fastq"])
    guard = run_mod.ingest_guard(cfg, lay, fastq)
    try:
        store, astats = retry.call_with_retry(
            "assign.round1",
            lambda: stages.run_assign(
                fastq, ctx.engine,
                max_ee_rate=cfg.max_ee_rate_base,
                min_len=cfg.minimal_length,
                minimal_region_overlap=cfg.minimal_region_overlap,
                max_softclip_5_end=cfg.max_softclip_5_end,
                max_softclip_3_end=cfg.max_softclip_3_end,
                batch_size=ctx.read_batch,
                max_read_length=cfg.max_read_length,
                subsample=cfg.dorado_trim_subsample_fastq,
                guard=guard,
            ),
            reset=guard.reset if guard is not None else None,
        )
    finally:
        # finalize even when the library fails: the quarantine gzip must
        # gain its trailer and the ingest events must reach the report
        run_mod.finalize_ingest_guard(guard, library)
    run_mod._write_assign_logs(astats, lay)
    return {"read_store": store, "align_stats": astats}


def round1_error_profile(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    counters = error_profile.profile_store(
        inputs["read_store"], ctx.panel,
        sample_size=ctx.cfg.error_profile_sample, device=ctx.device,
    )
    return {"r1_qc_profile": counters}


def commit_round1_error_profile(ctx, outputs: dict) -> None:
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    error_profile.write_error_profile_log(
        *outputs["r1_qc_profile"],
        os.path.join(ctx.lay.logs, f"{ctx.lay.library}_align_error_profile.log"),
    )


def round1_region_split(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.cluster import regions as regions_mod
    from ont_tcrconsensus_tpu_torch.pipeline import stages
    from ont_tcrconsensus_tpu_torch.qc import artifacts

    store, astats = inputs["read_store"], inputs["align_stats"]
    groups = stages.group_by_region_cluster(store, ctx.panel)
    artifacts.write_region_split_log(
        astats, groups, store, ctx.panel.names,
        {n: len(s) for n, s in ctx.panel.seqs.items()},
        regions_mod.NEGATIVE_CONTROL_SUFFIXES,
        os.path.join(
            ctx.lay.logs,
            f"{ctx.lay.library}_filter_and_split_reads_by_region_cluster.err",
        ),
    )
    return {"region_groups": groups}


def write_region_fastas(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.pipeline import stages

    stages.write_region_fastas(
        inputs["region_groups"], inputs["read_store"],
        ctx.lay.region_cluster_fasta, "region_cluster",
    )
    return {"region_cluster_fastas": ctx.lay.region_cluster_fasta}


def round1_umi_records(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.pipeline import stages

    store, groups = inputs["read_store"], inputs["region_groups"]
    cfg = ctx.cfg
    records_by_group: list[tuple[str, list]] = []
    for cluster_key in sorted(groups):
        group_name = f"region_cluster{cluster_key}"
        try:
            umis = stages.build_umi_records(
                store, groups[cluster_key], cfg.max_pattern_dist
            )
            if not umis:
                continue
            if cfg.write_intermediate_fastas:
                stages.write_umi_fasta(
                    umis, store,
                    os.path.join(
                        ctx.lay.umi_fasta, f"{group_name}_detected_umis.fasta"
                    ),
                )
            records_by_group.append((group_name, umis))
        except Exception as exc:
            ctx.failed_groups.append((group_name, repr(exc)))
            _log(f"WARNING: {group_name} failed and is skipped: {exc!r}")
    return {"records_by_group": records_by_group}


def round1_umi_cluster(ctx, inputs: dict) -> dict:
    """One library-wide batched clustering pass; a batched failure after
    its retries degrades to per-group passes so one bad group cannot
    poison its peers."""
    from ont_tcrconsensus_tpu_torch.pipeline import stages

    records_by_group = inputs["records_by_group"]
    select = stages.umi_cluster_selector(ctx.cfg, records_by_group, 1, ctx.device,
                                         mesh=ctx.engine.mesh)
    selected_by_group: list[tuple[str, list]] = []
    for group_name, umis in records_by_group:
        try:
            selected, stat_rows = select(group_name, umis)
            cdir = os.path.join(ctx.lay.clustering, group_name)
            os.makedirs(cdir, exist_ok=True)
            stages.write_cluster_stats_tsv(
                stat_rows, os.path.join(cdir, "vsearch_cluster_stats.tsv")
            )
            if selected:
                selected_by_group.append((group_name, selected))
        except Exception as exc:
            ctx.failed_groups.append((group_name, repr(exc)))
            _log(f"WARNING: {group_name} failed and is skipped: {exc!r}")
    return {"selected_by_group": selected_by_group}


def round1_polish(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.pipeline import stages

    selected_by_group = inputs["selected_by_group"]
    n_clusters = sum(len(s) for _, s in selected_by_group)
    _log(f"Polishing clusters: {ctx.lay.library} "
         f"({n_clusters} clusters over {len(selected_by_group)} region clusters)")
    by_group, polish_failed = stages.polish_clusters_all(
        selected_by_group, inputs["read_store"],
        max_read_length=ctx.cfg.max_read_length,
        polisher=ctx.polisher,
        budget=ctx.budget,
        cluster_batch=ctx.cfg.cluster_batch_size,
        keep_codes=True,
        device=ctx.device,
        mesh=ctx.engine.mesh,
    )
    return {"r1_polished": (by_group, polish_failed)}


def round1_consensus(ctx, inputs: dict) -> dict:
    """Merged consensus assembly + the round-1 resume checkpoint: an
    incomplete round 1 is not checkpointed, so resume retries the failed
    groups instead of reusing a consensus missing them."""
    from ont_tcrconsensus_tpu_torch.io import bucketing, fastx
    from ont_tcrconsensus_tpu_torch.ops import encode
    from ont_tcrconsensus_tpu_torch.robustness import contracts, faults, shutdown

    lay = ctx.lay
    by_group, polish_failed = inputs["r1_polished"]
    # r1_polished carries (header, uint8 code vector) pairs; strings
    # materialize only at the fasta artifact below (decode∘encode is a
    # bijection on codes 0..4, so the artifact is the string path's)
    merged: list[tuple[str, object]] = []
    for group_name, selected in inputs["selected_by_group"]:
        if group_name in polish_failed:
            ctx.failed_groups.append((group_name, polish_failed[group_name]))
            _log(f"WARNING: {group_name} polish failed and is skipped: "
                 f"{polish_failed[group_name]}")
        else:
            # every selected cluster of a non-failed group produced exactly
            # one consensus record
            contracts.check_equal(
                "consensus", f"{group_name} consensus records",
                len(by_group[group_name]), "selected clusters", len(selected),
                detail={"library": lay.library, "group": group_name},
            )
            merged.extend(by_group[group_name])
    cons_codes = bucketing.EncodedRecords(
        headers=[h for h, _ in merged],
        codes=[c for _, c in merged],
    )
    merged_consensus = [
        (h, encode.decode_seq(c, int(c.size)))
        for h, c in zip(cons_codes.headers, cons_codes.codes)
    ]
    if ctx.failed_groups:
        _log(
            "Not all umi cluster region fastas were successfully polished! "
            f"Incomplete: {[g for g, _ in ctx.failed_groups]}"
        )
        with open(os.path.join(lay.logs, "incomplete_region_clusters.log"), "w") as fh:
            for group_name, err in ctx.failed_groups:
                fh.write(f"{group_name}\t{err}\n")
    merged_path = os.path.join(lay.fasta, "merged_consensus.fasta")
    n_written = fastx.write_fasta(merged_path, merged_consensus)
    contracts.check_equal(
        "consensus", "merged_consensus.fasta records written", n_written,
        "in-memory consensus entries", len(merged_consensus),
        detail={"library": lay.library},
    )
    if not ctx.failed_groups:
        lay.mark_stage_done("round1_consensus", artifacts=[merged_path])
    # chaos site + preemption checkpoint at the round-1 commit: the
    # manifest just committed, so a kill here resumes into round 2 only
    faults.inject("run.round1_checkpoint")
    shutdown.checkpoint("run.round1_checkpoint")
    return {"merged_consensus": merged_consensus, "merged_fasta": merged_path,
            "cons_codes": cons_codes}


def round1_resume_probe(ctx):
    path = os.path.join(ctx.lay.fasta, "merged_consensus.fasta")
    return path if os.path.exists(path) else None


def round1_resume_reload(ctx) -> dict:
    from ont_tcrconsensus_tpu_torch.io import bucketing, fastx
    from ont_tcrconsensus_tpu_torch.ops import encode

    merged_path = os.path.join(ctx.lay.fasta, "merged_consensus.fasta")
    _log("Resuming from round-1 consensus:", ctx.lay.library)
    merged_consensus = [
        (rec.header, rec.sequence) for rec in fastx.read_fastx(merged_path)
    ]
    # re-encode the checkpointed fasta into the hand-off the resume
    # boundary promises (resume_provides): a resumed round 2 sees the
    # un-resumed run's batches byte for byte
    cons_codes = bucketing.EncodedRecords(
        headers=[h for h, _ in merged_consensus],
        codes=[encode.encode_seq(s) for _, s in merged_consensus],
    )
    return {"merged_consensus": merged_consensus, "cons_codes": cons_codes}


# -- round 2 ---------------------------------------------------------------


def round2_fused_assign(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod
    from ont_tcrconsensus_tpu_torch.pipeline import stages
    from ont_tcrconsensus_tpu_torch.robustness import retry

    cfg, lay = ctx.cfg, ctx.lay
    # round 1's polished codes arrive pre-encoded (EncodedRecords), so
    # batching skips the decode -> re-encode round trip
    cons_codes = inputs["cons_codes"]
    _log("Aligning unique molecule consensus TCR sequences:", lay.library)
    qc_rows: list[dict] = []
    dispatch = None
    if cfg.round2_targeted_assign:
        dispatch, why_not = run_mod._targeted_round2_dispatch(
            ctx.panel, ctx.engine_notrim, iter(cons_codes.headers)
        )
        if dispatch is None:
            _log(f"round 2: targeted assign unavailable ({why_not}); "
                 "falling back to the full fused assign")
    cons_store, cstats = retry.call_with_retry(
        "assign.round2",
        lambda: stages.run_assign(
            cons_codes, ctx.engine_notrim,
            max_ee_rate=1.0,  # no quality data on consensus sequences
            min_len=1,
            minimal_region_overlap=ctx.overlap_consensus,
            max_softclip_5_end=cfg.max_softclip_5_end,
            max_softclip_3_end=cfg.max_softclip_3_end,
            batch_size=ctx.read_batch,
            max_read_length=cfg.max_read_length,
            blast_id_threshold=ctx.blast_id_threshold,
            collect_qc=qc_rows,
            dispatch=dispatch,
        ),
        reset=qc_rows.clear,
    )
    run_mod._write_round2_assign_logs(qc_rows, cstats, lay, ctx.panel,
                                      ctx.blast_id_threshold, ctx.overlap_consensus)
    return {"cons_store": cons_store}


def round2_error_profile(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    counters = error_profile.profile_store(
        inputs["cons_store"], ctx.panel,
        sample_size=ctx.cfg.error_profile_sample, device=ctx.device,
    )
    return {"r2_qc_profile": counters}


def commit_round2_error_profile(ctx, outputs: dict) -> None:
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    error_profile.write_error_profile_log(
        *outputs["r2_qc_profile"],
        os.path.join(ctx.lay.logs, "merged_consensus_align_error_profile.log"),
    )


def round2_umi_records(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.pipeline import stages

    cfg = ctx.cfg
    cons_store = inputs["cons_store"]
    region_groups = stages.group_by_region(cons_store, ctx.panel)
    if cfg.write_intermediate_fastas:
        stages.write_region_fastas(
            region_groups, cons_store, ctx.lay.region_fasta, "region_"
        )
    region_records: list[tuple[str, list]] = []
    for region, parts in sorted(region_groups.items()):
        try:
            umis = stages.build_umi_records(
                cons_store, parts, cfg.max_pattern_dist
            )
            if not umis:
                continue
            if cfg.write_intermediate_fastas:
                stages.write_umi_fasta(
                    umis, cons_store,
                    os.path.join(
                        ctx.lay.consensus_umi_fasta,
                        f"region_{region}_detected_umis.fasta",
                    ),
                )
            region_records.append((region, umis))
        except Exception as exc:
            ctx.failed_regions.append((region, repr(exc)))
            _log(f"WARNING: round-2 region {region} failed and is skipped: {exc!r}")
    return {"region_records": region_records}


def round2_umi_cluster(ctx, inputs: dict) -> dict:
    from ont_tcrconsensus_tpu_torch.pipeline import stages

    region_records = inputs["region_records"]
    select = stages.umi_cluster_selector(ctx.cfg, region_records, 2, ctx.device,
                                         mesh=ctx.engine_notrim.mesh)
    selected_by_region: list[tuple[str, list, list]] = []
    for region, umis in region_records:
        try:
            selected, stat_rows = select(region, umis)
            selected_by_region.append((region, selected, stat_rows))
        except Exception as exc:
            ctx.failed_regions.append((region, repr(exc)))
            _log(f"WARNING: round-2 region {region} failed and is skipped: {exc!r}")
    return {"selected_by_region": selected_by_region}


def round2_counts(ctx, inputs: dict) -> dict:
    """Per-region artifacts + counts CSV + the counts manifest mark;
    incomplete counts are not checkpointed so resume retries."""
    from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod

    cons_store = inputs["cons_store"]
    region_counts: dict[str, int] = {}
    region_cluster_umis: dict[str, list[str]] = {}
    for region, selected, stat_rows in inputs["selected_by_region"]:
        try:
            run_mod._finish_round2_region(
                region, selected, stat_rows, cons_store, ctx.lay, ctx.cfg,
                region_counts, region_cluster_umis,
            )
        except Exception as exc:
            ctx.failed_regions.append((region, repr(exc)))
            _log(f"WARNING: round-2 region {region} failed and is skipped: {exc!r}")
    counts_csv = run_mod._write_counts(
        ctx.lay, ctx.cfg, region_counts, region_cluster_umis, ctx.failed_regions,
        ctx.timer, complete=not ctx.failed_groups and not ctx.failed_regions,
    )
    return {"region_counts": region_counts, "counts_csv": counts_csv}
