"""Post-hoc QC analysis and reporting.

A copy of the JAX package's ``qc/analysis.py`` (the port imports nothing of
that package), itself a rebuild of the original tool's analysis layer
(``ont_tcr_consensus/analysis.py``) and the notebook that runs it
(``notebooks/analysis.ipynb``): log parsers, count transforms, distribution
fits, sensitivity summaries and the plot set, writing per-library PDFs
under ``outs/``. Parsers target the pipeline's artifact formats (which keep
the original tool's filenames); each function cites its analogue there.
A host module: it imports no torch, and matplotlib and scipy only inside
the functions that use them. Its PDFs are byte-identical to the JAX
package's under ``SOURCE_DATE_EPOCH`` (matplotlib stamps the time
otherwise).
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

# matplotlib is imported lazily inside plot functions so headless/quick runs
# never pay for it


# ---------------------------------------------------------------------------
# parsers (analysis.py:76-114 analogues, reading our log formats)


def parse_merged_consensus_bam_filter_log(log_path: str) -> dict[str, float]:
    """Key/value parse of merged_consensus_bam_filter.log
    (analysis.py:84-105 parses the reference log by line index; ours parses
    by label so reordering cannot silently break it)."""
    out: dict[str, float] = {}
    labels = {
        "Total # primary alignments": "n_primary",
        "# primary alignments with allowed length": "n_correct_len",
        "# alignments too short": "n_short",
        "# alignments too long": "n_long",
        "# written alignments passing blast id filter": "n_written",
        "- minimal region overlap": "minimal_region_overlap",
        "- minimal blast identity with reference": "blast_id_threshold",
    }
    with open(log_path) as fh:
        for line in fh:
            for label, key in labels.items():
                if line.startswith(label):
                    out[key] = float(line.rstrip().rsplit(":", 1)[1])
    return out


def parse_quantile_95_blast_id_from_self_homology_log(log_path: str) -> float | None:
    """analysis.py:108-114 analogue."""
    with open(log_path) as fh:
        for line in fh:
            if line.startswith("0.950 quantile blast identity"):
                return float(line.rstrip().rsplit(":", 1)[1])
    return None


def parse_raw_nanopore_qual_from_fastq_stats(log_path: str) -> float | None:
    """Mean raw-read quality from the fastq-stats artifact
    (analysis.py:76-81 parses seqkit's AvgQual column; ours reads the
    pre-filter row of logs/<library>_fastq_stats.log)."""
    with open(log_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        try:
            qcol = header.index("avg_qual")
        except ValueError:
            return None
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if parts and parts[0] == "post_trim_pre_filter":
                return float(parts[qcol])
    return None


def read_counts_csv(path: str) -> dict[str, int]:
    out: dict[str, int] = {}
    with open(path) as fh:
        next(fh, None)
        for line in fh:
            region, _, count = line.rstrip("\n").rpartition(",")
            if region:
                out[region] = int(count)
    return out


def read_two_column_csv(path: str) -> list[tuple[str, float]]:
    rows = []
    with open(path) as fh:
        next(fh, None)
        for line in fh:
            a, _, b = line.rstrip("\n").rpartition(",")
            if a:
                rows.append((a, float(b)))
    return rows


# ---------------------------------------------------------------------------
# count transforms (analysis.py:560-574)


def filter_counts_on_log_umi_count_threshold(
    counts: dict[str, int], log10_threshold: float
) -> dict[str, int]:
    """Keep regions with log10(count) >= threshold (analysis.py:573)."""
    return {
        region: c for region, c in counts.items()
        if c > 0 and np.log10(c) >= log10_threshold
    }


def filter_counts_on_umi_quantile_threshold(
    counts: dict[str, int], quantile_umi_threshold: float = 0.05
) -> dict[str, int]:
    """Keep regions whose count exceeds the q-quantile of all counts
    (analysis.py:565-570: strict >, quantile over the full Count column)."""
    if not counts:
        return {}
    bar = float(np.quantile(np.asarray(list(counts.values()), np.float64),
                            quantile_umi_threshold))
    return {region: c for region, c in counts.items() if c > bar}


def negative_control_counts(
    counts: dict[str, int],
    suffixes: tuple[str, ...] = ("_v_n", "cdr3j_n", "full_n"),
) -> dict[str, int]:
    """Spiked-negative-control subset (analysis.py:53-73)."""
    return {r: c for r, c in counts.items() if r.endswith(suffixes)}


def fit_count_distributions(counts: list[int]) -> dict[str, float]:
    """Negative-binomial + normal fits with KS tests (analysis.py:577-811).

    The NB is moment-fit (r from mean/variance); KS p-values quantify how
    well each family explains the per-region UMI count spread.
    """
    from scipy import stats as sps

    x = np.asarray([c for c in counts if c > 0], dtype=np.float64)
    out: dict[str, float] = {"n": float(x.size)}
    if x.size < 3:
        return out
    mean, var = float(x.mean()), float(x.var(ddof=1))
    out["mean"] = mean
    out["var"] = var
    # normal fit
    ks_norm = sps.kstest(x, "norm", args=(mean, max(np.sqrt(var), 1e-9)))
    out["ks_normal_p"] = float(ks_norm.pvalue)
    # negative binomial via moments (var > mean required)
    if var > mean:
        r = mean**2 / (var - mean)
        p = r / (r + mean)
        out["nb_r"] = float(r)
        out["nb_p"] = float(p)
        nb = sps.nbinom(r, p)
        ks_nb = sps.kstest(x, nb.cdf)
        out["ks_nbinom_p"] = float(ks_nb.pvalue)
    return out


def estimate_precision_at_num_subreads(
    subread_blast_rows: list[tuple[str, float]],
    perfect_id: float = 1.0,
) -> dict[int, dict[str, float]]:
    """Consensus precision as a function of UMI cluster depth
    (minimap2_align.py:362-435, offline tool).

    For each subread count: how many consensus sequences exist, and what
    fraction align to the reference with blast identity >= ``perfect_id``.
    """
    per_depth: dict[int, list[float]] = defaultdict(list)
    for n, blast_id in subread_blast_rows:
        if str(n).isdigit():
            per_depth[int(n)].append(blast_id)
    return {
        n: {
            "n_consensus": len(ids),
            "n_perfect": sum(1 for b in ids if b >= perfect_id),
            "precision": sum(1 for b in ids if b >= perfect_id) / len(ids),
        }
        for n, ids in sorted(per_depth.items())
    }


# ---------------------------------------------------------------------------
# summary / sensitivity (analysis.py:814-911)


def write_results_summary(
    counts: dict[str, int],
    reference_regions: set[str],
    out_path: str,
    log10_threshold: float | None = None,
    negative_suffixes: tuple[str, ...] = ("_v_n", "cdr3j_n", "full_n"),
) -> dict[str, float]:
    """Sensitivity vs reference + negative-control leakage report."""
    countable = {r for r in reference_regions if not r.endswith(negative_suffixes)}
    detected = {r for r, c in counts.items() if c > 0 and not r.endswith(negative_suffixes)}
    filtered = (
        filter_counts_on_log_umi_count_threshold(counts, log10_threshold)
        if log10_threshold is not None else counts
    )
    detected_filtered = {
        r for r in filtered if not r.endswith(negative_suffixes)
    }
    ncs = negative_control_counts(counts, negative_suffixes)
    summary = {
        "num_reference_regions": len(countable),
        "num_detected": len(countable & detected),
        "sensitivity": (len(countable & detected) / len(countable)) if countable else 0.0,
        "num_detected_after_threshold": len(countable & detected_filtered),
        "num_negative_controls_with_counts": sum(1 for c in ncs.values() if c > 0),
        "total_negative_control_counts": sum(ncs.values()),
        "total_umi_counts": sum(counts.values()),
    }
    missing = sorted(countable - detected)
    with open(out_path, "w") as fh:
        for k, v in summary.items():
            fh.write(f"{k}: {v}\n")
        fh.write(f"missing_regions ({len(missing)}): {missing}\n")
    return summary


# ---------------------------------------------------------------------------
# plots (analysis.py:117-557, 577-811, 914-1232) — matplotlib PDFs


def _savefig(fig, out_path):
    fig.tight_layout()
    fig.savefig(out_path)
    import matplotlib.pyplot as plt

    plt.close(fig)


def plot_blast_id_hist(region_blast_rows: list[tuple[str, float]], out_path: str,
                       threshold: float | None = None):
    """Consensus blast-id distribution (analysis.py:117-228)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vals = [b for _, b in region_blast_rows]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(vals, bins=60)
    if threshold is not None:
        ax.axvline(threshold, color="red", linestyle="--", label=f"threshold {threshold:.4f}")
        ax.legend()
    ax.set_xlabel("blast identity vs reference")
    ax.set_ylabel("# consensus sequences")
    _savefig(fig, out_path)


def plot_nt_length_deviation_hists(short_rows, long_rows, out_path: str):
    """Too-short / too-long alignment histograms (analysis.py:231-325)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist([v for _, v in short_rows], bins=40)
    axes[0].set_xlabel("nt short of minimal overlap")
    axes[1].hist([v for _, v in long_rows], bins=40)
    axes[1].set_xlabel("nt past maximal length")
    for ax in axes:
        ax.set_ylabel("# alignments")
    _savefig(fig, out_path)


def plot_subreads_per_umi_hist(subread_rows: list[tuple[str, float]], out_path: str):
    """Subreads-per-UMI histogram (analysis.py:393-434)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ns = [int(n) for n, _ in subread_rows if str(n).isdigit()]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(ns, bins=np.arange(0.5, (max(ns) if ns else 1) + 1.5))
    ax.set_xlabel("# subreads per UMI cluster")
    ax.set_ylabel("# clusters")
    _savefig(fig, out_path)


def plot_blast_id_vs_subreads_box(subread_rows: list[tuple[str, float]], out_path: str):
    """Blast-id-vs-subreads boxplots (analysis.py:437-557)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups: dict[int, list[float]] = defaultdict(list)
    for n, b in subread_rows:
        if str(n).isdigit():
            groups[int(n)].append(b)
    keys = sorted(groups)
    fig, ax = plt.subplots(figsize=(8, 4))
    if keys:
        ax.boxplot([groups[k] for k in keys], tick_labels=[str(k) for k in keys])
    ax.set_xlabel("# subreads")
    ax.set_ylabel("blast identity")
    _savefig(fig, out_path)


def plot_umi_count_hist(counts: dict[str, int], out_path: str,
                        log10_threshold: float | None = None,
                        negative_suffixes=("_v_n", "cdr3j_n", "full_n")):
    """UMI count histogram with negative-control overlay + fit annotations
    (analysis.py:577-811)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos = [c for r, c in counts.items() if c > 0 and not r.endswith(negative_suffixes)]
    neg = [c for r, c in counts.items() if c > 0 and r.endswith(negative_suffixes)]
    fig, ax = plt.subplots(figsize=(7, 4))
    bins = np.logspace(0, np.log10(max(pos + neg + [10])), 40)
    ax.hist(pos, bins=bins, alpha=0.7, label="TCR regions")
    if neg:
        ax.hist(neg, bins=bins, alpha=0.7, color="red", label="negative controls")
    if log10_threshold is not None:
        ax.axvline(10**log10_threshold, color="black", linestyle="--",
                   label=f"log10 threshold {log10_threshold}")
    ax.set_xscale("log")
    ax.set_xlabel("UMI count")
    ax.set_ylabel("# regions")
    fits = fit_count_distributions(pos)
    if "ks_nbinom_p" in fits:
        ax.set_title(
            f"NB fit r={fits['nb_r']:.2f} (KS p={fits['ks_nbinom_p']:.3f}); "
            f"normal KS p={fits['ks_normal_p']:.3f}", fontsize=9,
        )
    ax.legend()
    _savefig(fig, out_path)


def plot_percent_alignments_above_blast_id(
    region_blast_rows: list[tuple[str, float]],
    out_path: str,
    minimal_blast_id: float | None = None,
    quantile_95_blast_id: float | None = None,
    percent_correct_overlap_length: float | None = None,
):
    """Percent-of-alignments blast-id histogram in the precision band
    (analysis.py:328-390: 0.0001-wide bins over [0.995, 1.0], bar heights
    as % of all alignments, red/blue threshold lines for the all-TCR and
    95%-of-TCR precision bars)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vals = np.asarray([b for _, b in region_blast_rows], np.float64)
    bins = np.arange(0.995, 1.0002, 0.0001)
    hist, edges = np.histogram(vals, bins=bins)
    pct = (hist / max(len(vals), 1)) * 100.0
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar(edges[:-1], pct, width=np.diff(edges), color="black", alpha=0.25,
           edgecolor="none", align="edge")
    if minimal_blast_id is not None:
        ax.axvline(minimal_blast_id, color="red", linewidth=0.75,
                   label="Required minimal blast identity\nto distinguish all TCRs")
    if quantile_95_blast_id is not None:
        ax.axvline(quantile_95_blast_id, color="blue", linewidth=0.75,
                   label="Required minimal blast identity\nto distinguish 95% of all TCRs")
    ax.set_xlim(0.995, 1.001)
    ax.set_xlabel("Blast identity with reference", fontsize=8)
    ax.set_ylabel("% of all TCR alignments\nwith correct overlap length", fontsize=8)
    if percent_correct_overlap_length is not None:
        ax.set_title(
            f"{round(percent_correct_overlap_length, 2)}% of all TCR alignments"
            "\nhave correct overlap length", fontsize=8,
        )
    if minimal_blast_id is not None or quantile_95_blast_id is not None:
        ax.legend(fontsize=8, loc="center left", bbox_to_anchor=(1, 0.5))
    _savefig(fig, out_path)


def plot_log_transformed_umi_counts_hist(
    counts: dict[str, int],
    out_path: str,
    most_similar_regions: set[str] | None = None,
    log_umi_counts_filter_threshold: float | None = None,
    plot_normal_dist_fit: bool = True,
    plot_percentiles: bool = True,
    title: str | None = None,
) -> dict[str, float]:
    """Log-transformed UMI-count histogram with normal fit + percentile
    lines (analysis.py:660-811). ``most_similar_regions`` overlays the
    near-homolog subset (the reference filters its most-similar-region dict
    at blast id > 0.99925); the title carries the log10 95th/5th percentile
    spread like the reference. Returns the fit stats."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy import stats as sps

    pos = {r: c for r, c in counts.items() if c > 0}
    logs = np.log(np.asarray(list(pos.values()), np.float64))
    out: dict[str, float] = {"n": float(logs.size)}
    fig, ax = plt.subplots(figsize=(7, 4))
    if logs.size:
        xmax = float(logs.max()) * 1.1 + 0.5
        bins = np.arange(0, xmax, max(xmax / 40, 0.05))
        ax.hist(logs, bins=bins, density=True, alpha=0.25, color="black",
                edgecolor="none", zorder=4, label="All TCRs")
        if most_similar_regions:
            sim = np.log(np.asarray(
                [c for r, c in pos.items() if r in most_similar_regions],
                np.float64,
            ))
            if sim.size:
                ax.hist(sim, bins=bins, density=True, alpha=0.25, color="red",
                        edgecolor="none", zorder=4, label="Most similar TCRs")
        if log_umi_counts_filter_threshold is not None:
            ax.axvline(log_umi_counts_filter_threshold, color="orange",
                       zorder=6, label="Filter threshold")
        if plot_percentiles:
            ax.axvline(np.quantile(logs, 0.05), color="yellow", zorder=6,
                       label="5th percentile")
            ax.axvline(np.median(logs), color="blue", zorder=6, label="median")
            ax.axvline(np.quantile(logs, 0.95), color="black", zorder=6,
                       label="95th percentile")
        spread = float(
            np.log10(np.quantile(list(pos.values()), 0.95))
            - np.log10(np.quantile(list(pos.values()), 0.05))
        )
        out["log10_diff_95th_5th"] = round(spread, 2)
        ax.set_title(
            f"{title or ''}\nlog10 diff. 95th vs 5th percentile = "
            f"{round(spread, 2)}", fontsize=8,
        )
        if plot_normal_dist_fit and logs.size >= 3:
            mean, std = float(logs.mean()), float(logs.std())
            ks = sps.kstest(logs, "norm", args=(mean, max(std, 1e-9)))
            out["ks_normal_stat"] = float(ks.statistic)
            out["ks_normal_p"] = float(ks.pvalue)
            x = np.linspace(logs.min(), logs.max(), 100)
            ax.plot(x, sps.norm.pdf(x, mean, std), "r-",
                    label="Fitted\nNormal Distribution")
    ax.set_xlabel("log(TCR UMI counts)", fontsize=8)
    ax.set_ylabel("Density", fontsize=8)
    ax.legend(fontsize=7, loc="center left", bbox_to_anchor=(1, 0.5))
    _savefig(fig, out_path)
    return out


_PLATE_ROWS = "ABCDEFGHIJKLMNOP"  # 384-well plate: 16 rows x 24 columns


def parse_plate_well(region_name: str) -> tuple[int, int, int] | None:
    """Region name -> (plate, row, col) for 384-well layouts.

    The reference's TCR names embed plate + well as fields 1 and 2 of the
    underscore-split name, e.g. ``TCR_3_B07_...`` -> plate 3, well B07
    (analysis.py:921-926: ``ref.split("_")[1] + "_" + ref.split("_")[2]``).
    Returns None when the name doesn't carry a parseable plate/well.
    """
    parts = region_name.split("_")
    if len(parts) < 3:
        return None
    try:
        plate = int(parts[1])
    except ValueError:
        return None
    well = parts[2]
    if not well or well[0].upper() not in _PLATE_ROWS:
        return None
    try:
        col = int(well[1:])
    except ValueError:
        return None
    if not (1 <= col <= 24):
        return None
    return plate, _PLATE_ROWS.index(well[0].upper()), col - 1


def plot_plate_heatmap(counts: dict[str, int], out_path: str,
                       reference_regions: set[str] | None = None,
                       rows: int = 16, cols: int = 24):
    """384-well plate heatmaps (analysis.py:914-993).

    Region names carrying plate/well ids (:func:`parse_plate_well`) get one
    log-count heatmap per plate — wells absent from the reference are NaN,
    present-but-undetected wells are 0 (the reference's semantics). Names
    without well ids fall back to a single sorted-order grid.
    ``out_path`` is used as-is for the fallback, and with ``_plate<N>``
    inserted before the extension per real plate.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ref_names = reference_regions if reference_regions is not None else set(counts)
    placed = {n: parse_plate_well(n) for n in ref_names}
    parseable = {n: p for n, p in placed.items() if p is not None}

    if not parseable:
        grid = np.full((rows, cols), np.nan)
        for i, region in enumerate(sorted(counts)):
            if i >= rows * cols:
                break
            grid[i // cols, i % cols] = counts[region]
        fig, ax = plt.subplots(figsize=(10, 6))
        im = ax.imshow(grid, aspect="auto", cmap="viridis")
        fig.colorbar(im, ax=ax, label="UMI count")
        ax.set_xlabel("plate column")
        ax.set_ylabel("plate row")
        _savefig(fig, out_path)
        return

    plates = sorted({p[0] for p in parseable.values()})
    root, ext = os.path.splitext(out_path)
    for plate in plates:
        grid = np.full((len(_PLATE_ROWS), 24), np.nan)
        for name, (pl, i, j) in parseable.items():
            if pl != plate:
                continue
            c = counts.get(name, 0)
            grid[i, j] = np.log10(c) if c > 0 else 0.0
        fig, ax = plt.subplots(figsize=(10, 7))
        im = ax.matshow(grid, cmap="viridis")
        ax.set_xticks(np.arange(24), labels=[str(c + 1) for c in range(24)], fontsize=7)
        ax.set_yticks(np.arange(len(_PLATE_ROWS)), labels=list(_PLATE_ROWS), fontsize=7)
        ax.set_title(f"Plate: {plate}", pad=20)
        fig.colorbar(im, ax=ax, fraction=0.02, pad=0.03,
                     label="Log transformed\nUMI count")
        _savefig(fig, f"{root}_plate{plate}{ext}")


# ---------------------------------------------------------------------------
# V-gene composition plots (analysis.py:996-1232)


def load_tcr_refs_csv(path: str,
                      name_col: str = "name",
                      trav_col: str = "TRAV_IMGT_allele_collapsed",
                      trbv_col: str = "TRBV_IMGT_allele_collapsed") -> dict[str, dict[str, str]]:
    """TCR metadata table: name -> {TRAV, TRBV} (the tcr_refs_df input of
    the reference's V-gene plots)."""
    import csv

    out: dict[str, dict[str, str]] = {}
    with open(path) as fh:
        for row in csv.DictReader(fh):
            name = row.get(name_col, "").strip()
            if name:
                out[name] = {
                    "TRAV": row.get(trav_col, "").strip(),
                    "TRBV": row.get(trbv_col, "").strip(),
                }
    return out


def v_gene_fold_change(counts: dict[str, int], tcr_refs: dict[str, dict[str, str]],
                       gene: str) -> dict[str, float]:
    """Per-V-allele fold change of output fraction over input composition
    (analysis.py:1010-1035): detected fraction of counts per allele divided
    by the allele's share of the reference library."""
    input_counts: dict[str, int] = defaultdict(int)
    for meta in tcr_refs.values():
        if meta.get(gene):
            input_counts[meta[gene]] += 1
    total_input = sum(input_counts.values())
    out_frac: dict[str, float] = defaultdict(float)
    total_counts = sum(counts.get(n, 0) for n in tcr_refs)
    for name, meta in tcr_refs.items():
        if meta.get(gene) and total_counts:
            out_frac[meta[gene]] += counts.get(name, 0) / total_counts
    return {
        allele: (out_frac.get(allele, 0.0) / (n / total_input)) if total_input else 0.0
        for allele, n in input_counts.items()
    }


def plot_v_gene_fold_change(counts: dict[str, int],
                            tcr_refs: dict[str, dict[str, str]],
                            out_dir: str, title: str | None = None):
    """TRAV/TRBV fold-change-over-input barplots, median-normalized
    (analysis.py:996-1117; same output filenames)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for gene in ("TRAV", "TRBV"):
        fc = v_gene_fold_change(counts, tcr_refs, gene)
        if not fc:
            continue
        items = sorted(fc.items(), key=lambda kv: -kv[1])
        vals = np.array([v for _, v in items], dtype=float)
        med = np.median(vals[vals > 0]) if (vals > 0).any() else 1.0
        fig, ax = plt.subplots(figsize=(max(6, len(items) / 4), 4))
        ax.bar(np.arange(len(items)), vals / (med or 1.0),
               edgecolor="black", linewidth=0.5, color="lightblue")
        ax.axhline(1, color="red", linewidth=0.75)
        ax.set_xticks(np.arange(len(items)))
        ax.set_xticklabels([a for a, _ in items], rotation=90, fontsize=7)
        ax.set_ylabel("Fold change over input\n(normalized to median)", fontsize=8)
        if title:
            ax.set_title(title, fontsize=8)
        _savefig(fig, os.path.join(
            out_dir, f"{gene}_fold_change_over_input_barplot.pdf"
        ))


def plot_v_gene_missing_tcrs(counts: dict[str, int],
                             tcr_refs: dict[str, dict[str, str]],
                             reference_regions: set[str],
                             out_dir: str, title: str | None = None):
    """V-allele distribution of undetected TCRs (analysis.py:1120-1232;
    same output filenames). Returns the missing set."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    detected = {r for r, c in counts.items() if c > 0}
    missing = sorted(set(reference_regions) & set(tcr_refs) - detected)
    if not missing:
        return []
    for gene in ("TRAV", "TRBV"):
        counter: dict[str, int] = defaultdict(int)
        for name in missing:
            allele = tcr_refs[name].get(gene)
            if allele:
                counter[allele] += 1
        if not counter:
            continue
        items = sorted(counter.items(), key=lambda kv: -kv[1])
        total = sum(v for _, v in items)
        fig, ax = plt.subplots(figsize=(max(4, len(items) / 1.5), 4))
        ax.bar(np.arange(len(items)), [v / total for _, v in items],
               edgecolor="black", linewidth=0.5, color="lightblue")
        ax.set_ylim(0, 1)
        ax.set_xticks(np.arange(len(items)))
        ax.set_xticklabels([a for a, _ in items], rotation=90, fontsize=7)
        ax.set_ylabel("Fraction of missing TCRs", fontsize=8)
        ax.set_title(f"{title or ''}, # missing TCRs = {total}", fontsize=8)
        _savefig(fig, os.path.join(out_dir, f"{gene}_counter_missing_tcr_barplot.pdf"))
    return missing


# ---------------------------------------------------------------------------
# per-library loop (notebook cell 3 analogue)


def run_library_analysis(
    library_dir: str,
    reference_regions: set[str],
    out_dir: str | None = None,
    log10_threshold: float | None = None,
    tcr_refs: dict[str, dict[str, str]] | None = None,
) -> dict[str, float]:
    """Produce the per-library outs/ PDFs + results_summary.txt."""
    out_dir = out_dir or os.path.join(library_dir, "outs")
    os.makedirs(out_dir, exist_ok=True)
    logs = os.path.join(library_dir, "logs")
    counts = read_counts_csv(os.path.join(library_dir, "counts", "umi_consensus_counts.csv"))

    blast_csv = os.path.join(logs, "merged_consensus_region_blast_id.csv")
    if os.path.exists(blast_csv):
        rows = read_two_column_csv(blast_csv)
        plot_blast_id_hist(rows, os.path.join(out_dir, "blast_id_hist.pdf"))
        # precision-band percent hist (analysis.py:328-390): thresholds from
        # the filter log + the run-level self-homology log
        flog = os.path.join(logs, "merged_consensus_bam_filter.log")
        fstats = (
            parse_merged_consensus_bam_filter_log(flog)
            if os.path.exists(flog) else {}
        )
        pct = None
        if fstats.get("n_primary"):
            pct = 100.0 * fstats.get("n_correct_len", 0) / fstats["n_primary"]
        hlog = os.path.join(
            os.path.dirname(library_dir),
            "ref_homology_out_generate_region_split_dict.log",
        )
        q95 = (
            parse_quantile_95_blast_id_from_self_homology_log(hlog)
            if os.path.exists(hlog) else None
        )
        plot_percent_alignments_above_blast_id(
            rows, os.path.join(out_dir, "precision_blast_id_hist.pdf"),
            minimal_blast_id=fstats.get("blast_id_threshold"),
            quantile_95_blast_id=q95,
            percent_correct_overlap_length=pct,
        )
    short_csv = os.path.join(logs, "merged_consensus_region_nt_too_short.csv")
    long_csv = os.path.join(logs, "merged_consensus_region_nt_too_long.csv")
    if os.path.exists(short_csv) and os.path.exists(long_csv):
        plot_nt_length_deviation_hists(
            read_two_column_csv(short_csv), read_two_column_csv(long_csv),
            os.path.join(out_dir, "nt_length_deviation.pdf"),
        )
    sub_csv = os.path.join(logs, "merged_consensus_number_of_subreads_blast_id.csv")
    if os.path.exists(sub_csv):
        rows = read_two_column_csv(sub_csv)
        plot_subreads_per_umi_hist(rows, os.path.join(out_dir, "subreads_per_umi.pdf"))
        plot_blast_id_vs_subreads_box(rows, os.path.join(out_dir, "blast_id_vs_subreads.pdf"))
        # precision-vs-depth report (minimap2_align.py:362-435 analogue, fed
        # by the pipeline's own subreads/blast-id artifact)
        per_depth = estimate_precision_at_num_subreads(rows)
        with open(os.path.join(out_dir, "precision_at_num_subreads.tsv"), "w") as fh:
            fh.write("num_subreads\tn_consensus\tn_perfect\tprecision\n")
            for n, st in per_depth.items():
                fh.write(
                    f"{n}\t{st['n_consensus']:.0f}\t{st['n_perfect']:.0f}"
                    f"\t{st['precision']:.6f}\n"
                )
    plot_umi_count_hist(counts, os.path.join(out_dir, "umi_count_hist.pdf"),
                        log10_threshold=log10_threshold)
    # log-transformed hist with the most-similar overlay (analysis.py:660-811)
    most_similar_json = os.path.join(
        os.path.dirname(library_dir),
        "ref_homology_out_most_similar_region_dict.json",
    )
    most_similar: set[str] | None = None
    if os.path.exists(most_similar_json):
        import json as _json

        with open(most_similar_json) as fh:
            sim_map = _json.load(fh)
        most_similar = {
            region for region, bids in sim_map.items()
            if bids and max(bids) > 0.99925
        }
    plot_log_transformed_umi_counts_hist(
        counts, os.path.join(out_dir, "log_transformed_umi_counts_hist.pdf"),
        most_similar_regions=most_similar,
        log_umi_counts_filter_threshold=log10_threshold,
    )
    plot_plate_heatmap(counts, os.path.join(out_dir, "plate_heatmap.pdf"),
                       reference_regions=reference_regions)
    if tcr_refs:
        plot_v_gene_fold_change(counts, tcr_refs, out_dir)
        plot_v_gene_missing_tcrs(counts, tcr_refs, reference_regions, out_dir)
    return write_results_summary(
        counts, reference_regions,
        os.path.join(out_dir, "results_summary.txt"),
        log10_threshold=log10_threshold,
    )


def read_libraries_csv(path: str) -> dict[str, dict]:
    """libraries.csv (ref README.md:62-82): barcode -> {library_name,
    ref_library_name, log_umi_counts_filter_threshold}."""
    out: dict[str, dict] = {}
    with open(path) as fh:
        next(fh, None)
        for line in fh:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 4 or not parts[0]:
                continue
            try:
                thr = float(parts[3])
            except ValueError:
                thr = None
            out[parts[0]] = {
                "library_name": parts[1],
                "ref_library_name": parts[2],
                "log_umi_counts_filter_threshold": thr,
            }
    return out


def run_all_libraries(nano_dir: str, reference_regions,
                      libraries_csv: str | None = None,
                      tcr_refs_csv: str | None = None) -> dict[str, dict]:
    """Loop all per-library dirs (notebook cells 1+3).

    ``reference_regions`` is either one region-name set applied everywhere
    or a dict keyed by ``ref_library_name`` — the per-library reference
    mapping of ``libraries.csv`` (ref README.md:62-82: barcode,
    library_name, ref_library_name, log_umi_counts_filter_threshold).
    Output summaries are keyed ``<barcode>_<library_name>`` like the
    notebook's outs/ directories. ``tcr_refs_csv`` enables the V-gene
    composition plots."""
    meta = read_libraries_csv(libraries_csv) if libraries_csv and os.path.exists(
        libraries_csv
    ) else {}
    tcr_refs = load_tcr_refs_csv(tcr_refs_csv) if tcr_refs_csv and os.path.exists(
        tcr_refs_csv
    ) else None
    out = {}
    for name in sorted(os.listdir(nano_dir)):
        lib_dir = os.path.join(nano_dir, name)
        if not os.path.isdir(os.path.join(lib_dir, "counts")):
            continue
        m = meta.get(name, {})
        regions = reference_regions
        if isinstance(reference_regions, dict):
            regions = reference_regions.get(
                m.get("ref_library_name", ""), set()
            ) or set().union(*reference_regions.values())
        key = f"{name}_{m['library_name']}" if m.get("library_name") else name
        out[key] = run_library_analysis(
            lib_dir, regions,
            out_dir=os.path.join(lib_dir, "outs") if not m.get("library_name")
            else os.path.join(lib_dir, "outs", key),
            log10_threshold=m.get("log_umi_counts_filter_threshold"),
            tcr_refs=tcr_refs,
        )
    return out
