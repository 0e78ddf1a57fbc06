"""Cross-region UMI collision audit.

A copy of the JAX package's ``qc/umi_overlap.py``: for every pair of
regions, count the round-2 cluster-consensus UMIs found in both, by exact
equality (the reference's shipped comparison), with a hash join, into
``regions_w_overlapping_umis.tsv`` and a stderr-style warning file.
"""

from __future__ import annotations

import itertools
import os
from collections import Counter


def count_overlapping_umis(
    region_umis: dict[str, list[str]],
    logs_dir: str,
    overlapping_umi_edit_threshold: int = 1,
) -> list[bool]:
    """region -> cluster UMIs; writes regions_w_overlapping_umis.tsv.

    Returns per-region-pair booleans in ``itertools.combinations`` order,
    matching the reference's return value.
    """
    tsv_path = os.path.join(logs_dir, "regions_w_overlapping_umis.tsv")
    err_path = os.path.join(logs_dir, "region_region_umi_comparison.stderr")

    counters = {region: Counter(umis) for region, umis in region_umis.items()}
    out: list[bool] = []
    tsv_rows: list[str] = []
    warn_rows: list[str] = []
    for r1, r2 in itertools.combinations(region_umis, 2):
        c1, c2 = counters[r1], counters[r2]
        if len(c1) > len(c2):
            c1, c2 = c2, c1
        # per region-1 UMI, how many region-2 UMIs equal it (the reference's count)
        overlap = sum(n1 * c2.get(umi, 0) for umi, n1 in c1.items())
        multi_warn = any(c2.get(umi, 0) > 1 for umi in c1)
        if multi_warn:
            warn_rows.append(
                f"WARNING: there are UMIs from {r1} that match more than 1 "
                f"UMI within {r2}\n"
            )
        if overlap:
            tsv_rows.append(f"region_{r1}\tregion_{r2}\t{overlap}\n")
        out.append(bool(overlap))

    # one write per call: reruns do not accumulate duplicate headers
    with open(tsv_path, "w") as fh:
        fh.write("region_1\tregion_2\tumi_overlap_count\n")
        fh.writelines(tsv_rows)
    if warn_rows:
        with open(err_path, "w") as ferr:
            ferr.writelines(warn_rows)
    return out
