"""QC artifact emitters: the reference pipeline's in-run empirical QC.

A copy of the JAX package's ``qc/artifacts.py``: the consensus-filter
artifact set (seven CSVs and a filter log, the reference's file names and
column layouts, so its analysis notebook parsers read this output), the
round-1 split log, the read-stats and flagstat analogues and the
self-homology log, byte for byte the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np


def _write_csv(path: str, header: list[str], rows: list[tuple]) -> None:
    with open(path, "w") as fh:
        fh.write(",".join(header) + "\n")
        for row in rows:
            fh.write(",".join(str(x) for x in row) + "\n")


def write_consensus_filter_artifacts(
    qc_rows: list[dict],
    region_lengths: dict[str, int],
    logs_dir: str,
    prefix: str,
    blast_id_threshold: float,
    minimal_region_overlap: float,
) -> dict[str, str]:
    """Emit the 7 QC CSVs + the bam-filter log.

    ``qc_rows`` come from ``assign.run_assign(collect_qc=...)`` on the
    merged-consensus pass. ``prefix`` mirrors the reference's
    ``<bam basename>`` (e.g. ``merged_consensus``).
    """
    paths = {
        "nt_too_short": os.path.join(logs_dir, f"{prefix}_nt_too_short.csv"),
        "region_nt_too_short": os.path.join(logs_dir, f"{prefix}_region_nt_too_short.csv"),
        "nt_too_long": os.path.join(logs_dir, f"{prefix}_nt_too_long.csv"),
        "region_nt_too_long": os.path.join(logs_dir, f"{prefix}_region_nt_too_long.csv"),
        "blast_id": os.path.join(logs_dir, f"{prefix}_blast_id.csv"),
        "region_blast_id": os.path.join(logs_dir, f"{prefix}_region_blast_id.csv"),
        "num_subreads_blast_id": os.path.join(logs_dir, f"{prefix}_number_of_subreads_blast_id.csv"),
        "log": os.path.join(logs_dir, f"{prefix}_bam_filter.log"),
    }

    short_rows, long_rows, blast_rows, subread_rows = [], [], [], []
    n_primary = n_short = n_long = n_correct_len = n_written = 0
    for row in qc_rows:
        n_primary += 1
        status = row["status"]
        if status == "short":
            n_short += 1
            short_rows.append((row["region"], row["nt_short"]))
            continue
        if status == "long":
            n_long += 1
            long_rows.append((row["region"], row["nt_long"]))
            continue
        n_correct_len += 1
        blast_rows.append((row["region"], row["blast_id"]))
        # consensus names end in _<n_subreads>
        num_subreads = row["name"].rsplit("_", 1)[-1]
        subread_rows.append((num_subreads, row["blast_id"]))
        if status == "pass":
            n_written += 1

    _write_csv(paths["region_nt_too_short"], ["region", "number_of_nt"], short_rows)
    _write_csv(paths["nt_too_short"], ["number_of_nt"], [(nt,) for _, nt in short_rows])
    _write_csv(paths["region_nt_too_long"], ["region", "number_of_nt"], long_rows)
    _write_csv(paths["nt_too_long"], ["number_of_nt"], [(nt,) for _, nt in long_rows])
    _write_csv(paths["region_blast_id"], ["region", "blast_id"], blast_rows)
    _write_csv(paths["blast_id"], ["blast_id"], [(b,) for _, b in blast_rows])
    _write_csv(paths["num_subreads_blast_id"], ["number_of_subreads", "blast_id"], subread_rows)

    region_lens = list(region_lengths.values())
    allowed_short = [rl - rl * minimal_region_overlap for rl in region_lens]
    allowed_long = [rl * (2 - minimal_region_overlap) - rl for rl in region_lens]
    allowed_diff = [rl - rl * blast_id_threshold for rl in region_lens]
    with open(paths["log"], "w") as log:
        log.write("Consensus alignment filtering performed with the following parameters:\n")
        log.write(f"- minimal region overlap: {minimal_region_overlap}\n")
        log.write(f"- minimal blast identity with reference: {blast_id_threshold}\n")
        log.write("From these parameters follows:\n")
        log.write(f"- Minimal Phred Q = {round(-10 * np.log10(max(1 - blast_id_threshold, 1e-12)), 2)}\n")
        log.write(f"- Median region nucleotide length: {np.median(region_lens)}\n")
        log.write(f"- Median allowed too few nucleotides/region: {round(np.median(allowed_short), 2)}\n")
        log.write(f"- Median allowed too many nucleotides/region: {round(np.median(allowed_long), 2)}\n")
        log.write(f"- Median allowed nucleotide difference/region: {round(np.median(allowed_diff), 2)}\n")
        log.write(f"Total # primary alignments: {n_primary}\n")
        log.write(f"# primary alignments with allowed length: {n_correct_len}\n")
        log.write(f"# alignments too short: {n_short}\n")
        log.write(f"# alignments too long: {n_long}\n")
        log.write(f"# written alignments passing blast id filter: {n_written}\n")
        if n_primary:
            log.write(f"% written of primary: {round(100 * n_written / n_primary, 2)}\n")
    return paths


def write_region_split_log(
    stats,
    groups: dict,
    store,
    panel_names: list[str],
    region_lengths: dict[str, int],
    negative_suffixes: tuple[str, ...],
    log_path: str,
) -> None:
    """Detection-fraction log of the round-1 split
    (the reference's region split). ``groups`` maps key -> [(block, rows)] into
    the columnar ``store``."""
    per_group_counts = [
        sum(len(rows) for _, rows in parts) for parts in groups.values()
    ]
    detected = set()
    for parts in groups.values():
        for bi, rows in parts:
            detected.update(
                int(i) for i in np.unique(store.blocks[bi].region_idx[rows])
            )
    detected_names = {
        panel_names[i] for i in detected
        if not panel_names[i].endswith(negative_suffixes)
    }
    countable = {n for n in region_lengths if not n.endswith(negative_suffixes)}
    frac = len(countable & detected_names) / len(countable) if countable else 0.0
    missing = sorted(countable - detected_names)
    with open(log_path, "w") as fh:
        fh.write(f"Total # primary alignments in bam file: {stats.n_aligned}\n")
        med = np.median(per_group_counts) if per_group_counts else 0
        fh.write(
            "median # of primary alignments in region clusters that have "
            f"minimal region overlap and are not too long: {round(float(med), 3)}\n"
        )
        if stats.n_aligned:
            fh.write(
                "% of primary alignments that have shorter overlap than minimal region overlap: "
                f"{round(100 * stats.n_short / stats.n_aligned, 2)}\n"
            )
            fh.write(
                "% of primary alignments that have too long reads: "
                f"{round(100 * stats.n_long / stats.n_aligned, 2)}\n"
            )
        fh.write(
            "fraction detected regions of total regions in reference in initial "
            f"non-polished read alignments: {round(frac, 4)}\n"
        )
        fh.write(
            "# of missing regions from reference in initial non-polished read "
            f"alignments: {len(missing)}\n"
        )
        fh.write(
            "missing/non-detected regions from reference in initial non-polished "
            f"read alignments: {set(missing) if missing else 'set()'}\n"
        )


def write_fastq_stats_log(stats, log_path: str) -> None:
    """Before/after filter read stats — the seqkit-stat QC boundary artifact
    (the reference runs ``seqkit stat -a`` on the trimmed and the filtered
    fastq; here both aggregates come from the fused pass)."""
    with open(log_path, "w") as fh:
        fh.write("stage\tnum_seqs\tsum_len\tmin_len\tavg_len\tmax_len\tavg_qual\n")
        for name, ls in (("post_trim_pre_filter", stats.pre_filter),
                         ("post_filter_pass", stats.post_filter)):
            fh.write(
                f"{name}\t{ls.n}\t{ls.sum_len}\t{ls.min_len}\t"
                f"{ls.avg_len:.1f}\t{ls.max_len}\t{ls.avg_qual:.2f}\n"
            )


def write_flagstat_log(stats, log_path: str) -> None:
    """Alignment summary — the ``samtools flagstat`` analogue
    (the reference's alignment step). No BAM exists in this framework, so the
    equivalent categories come from the fused pass counters."""
    with open(log_path, "w") as fh:
        fh.write(f"{stats.n_total} in total (reads entering alignment)\n")
        fh.write(f"{stats.n_aligned} primary mapped "
                 f"({_pct(stats.n_aligned, stats.n_total)} : score gate)\n")
        n_unmapped = stats.n_total - stats.n_ee_fail - stats.n_aligned
        fh.write(f"{stats.n_ee_fail} failed EE/length filter "
                 f"({_pct(stats.n_ee_fail, stats.n_total)})\n")
        fh.write(f"{max(n_unmapped, 0)} unmapped "
                 f"({_pct(max(n_unmapped, 0), stats.n_total)})\n")
        fh.write(f"{stats.n_short} mapped too short\n")
        fh.write(f"{stats.n_long} read too long\n")
        fh.write(f"{stats.n_low_blast} below blast-id threshold\n")
        fh.write(f"{stats.n_pass} passing all filters "
                 f"({_pct(stats.n_pass, stats.n_total)})\n")


def _pct(a: int, b: int) -> str:
    return f"{100.0 * a / b:.2f}%" if b else "N/A"


def write_self_homology_log(stats: dict, log_path: str) -> None:
    """Self-homology quantile log (the reference's format)."""
    with open(log_path, "w") as fh:
        fh.write(
            "Homology pairs after prefiltering: "
            f"{stats.get('num_pairs_prefilter', 0)}\n"
        )
        if "median_blast_id" in stats:
            fh.write(f"Median blast identity of most similar regions: {stats['median_blast_id']}\n")
            fh.write(f"0.925 quantile blast identity of most similar regions: {stats['q925_blast_id']}\n")
            fh.write(f"0.950 quantile blast identity of most similar regions: {stats['q950_blast_id']}\n")
            fh.write(f"0.975 quantile blast identity of most similar regions: {stats['q975_blast_id']}\n")
            fh.write(f"0.990 quantile blast identity of most similar regions: {stats['q990_blast_id']}\n")
            fh.write(f"Maximal blast identity of most similar regions: {stats['max_blast_id']}\n")
