"""Lane-scale proof run of the PyTorch port: the twin of
``scripts/lane_scale_proof.py``.

Runs the port's full two-round pipeline over a UMI-heavy library: one
region holds at least ``--min-heavy`` unique molecules at depth 3 (past
``cluster/umi._FULL_MATRIX_MAX`` = 256, so the shortlist and merge-repair
clustering runs), the other 23 regions molecules at depth 4, under
``min_reads_per_cluster: 2`` (depth-2 and depth-3 molecules are polished)
and no QC error profile. The dataset is made from the same arguments as
the JAX script's, read for read (seed 47, 24 regions, the IUPAC UMI
patterns, the read order).

Prints and writes (``--out``, JSON) the JAX script's artifact (wall
seconds, reads/s, counts against the truth, the heavy region's count,
precision at depth, stage seconds, peak device and host memory), plus
the card's name and the kernels' launches. Exits 0 only when every count
is exact, as the JAX script does (at depth 3 the heavy region may lose a
few molecules).

Run: python scripts/torch_lane_scale_proof.py [--reads 100000] [--out PATH]
         [--root DIR] [--force-cpu] [--min-heavy N] [--round2-full]
(on the card unless ``--force-cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORK = os.path.join(REPO, "build", "torch_lane_scale")
UMI_FWD = "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT"
UMI_REV = "AAABBBBAABBBBAABBBBAABBBBAABBAAA"


def build_dataset(root: str, target_reads: int, seed: int = 47, min_heavy: int = 20_000):
    """A library whose largest region holds >= ``min_heavy`` unique UMIs at
    depth 3, the rest of ``target_reads`` spread over 23 more regions at
    depth 4; writes ``root/reference.fa`` and
    ``root/fastq_pass/barcode01/barcode01.fastq.gz``. Returns (library,
    heavy region, heavy molecules)."""
    import numpy as np

    from ont_tcrconsensus_tpu_torch.io import fastx, simulator

    heavy_molecules = max(min_heavy, target_reads // 5)
    heavy_reads_per_mol = 3
    rest = max(target_reads - heavy_molecules * heavy_reads_per_mol, 0)

    rng = np.random.default_rng(seed)
    ref = simulator.make_reference(rng, num_regions=24)
    names = list(ref)
    heavy_region = names[0]

    def molecule(region: str, depth: int):
        return simulator.Molecule(
            region=region, umi_fwd=simulator.instantiate_iupac(rng, UMI_FWD),
            umi_rev=simulator.instantiate_iupac(rng, UMI_REV), num_reads=depth)

    molecules = [molecule(heavy_region, heavy_reads_per_mol) for _ in range(heavy_molecules)]
    other = names[1:]
    molecules += [molecule(other[i % len(other)], 4) for i in range(rest // 4)]

    err = simulator.OntErrorModel()
    reads = []
    for mi, mol in enumerate(molecules):
        template = (simulator.LEFT_FLANK + mol.umi_fwd + ref[mol.region] + mol.umi_rev
                    + simulator.RIGHT_FLANK)
        template_rc = simulator.revcomp(template)
        for ri in range(mol.num_reads):
            orient = "-" if rng.random() < 0.5 else "+"
            seq, qual = simulator.mutate_ont(
                rng, template_rc if orient == "-" else template, err)
            reads.append((f"read_m{mi}_r{ri} mol={mi}", seq, qual))
    order = rng.permutation(len(reads))
    reads = [reads[i] for i in order]
    lib = simulator.SimulatedLibrary(reference=ref, molecules=molecules, reads=reads)

    os.makedirs(os.path.join(root, "fastq_pass", "barcode01"), exist_ok=True)
    fastx.write_fasta(os.path.join(root, "reference.fa"), ref.items())
    fastx.write_fastq(os.path.join(root, "fastq_pass", "barcode01", "barcode01.fastq.gz"),
                      reads)
    return lib, heavy_region, heavy_molecules


def _stage_timing(logs_dir: str) -> dict[str, float]:
    timing = {}
    tsv = os.path.join(logs_dir, "stage_timing.tsv")
    if os.path.exists(tsv):
        with open(tsv) as fh:
            next(fh)
            for line in fh:
                stage, sec, _ = line.split("\t")
                timing[stage] = float(sec)
    return timing


def _precision_at_depth(logs_dir: str):
    """Depth -> precision from the run's own round-2 QC rows
    (``qc.analysis.estimate_precision_at_num_subreads``)."""
    sub_csv = os.path.join(logs_dir, "merged_consensus_number_of_subreads_blast_id.csv")
    if not os.path.exists(sub_csv):
        return None
    from ont_tcrconsensus_tpu_torch.qc.analysis import estimate_precision_at_num_subreads

    rows = []
    with open(sub_csv) as fh:
        next(fh)
        for line in fh:
            n, b = line.rstrip("\n").split(",")
            rows.append((n, float(b)))
    return {str(k): v for k, v in estimate_precision_at_num_subreads(rows).items()}


def _launches() -> dict[str, int]:
    from ont_tcrconsensus_tpu_torch.ops import (cs_kernel, dovetail_kernel, fuzzy_kernel,
                                                pileup_kernel, sw_kernel, traceback_kernel)

    return {"B1": sw_kernel.align_banded_cuda.launches,
            "B2": pileup_kernel.forward_planes_cuda.launches,
            "B3": traceback_kernel.traceback_columns_cuda.launches,
            "B4": cs_kernel.error_profile_cs_cuda.launches,
            "B5": fuzzy_kernel.fuzzy_find_multi_cuda.launches,
            "B6": dovetail_kernel.dovetail_cuda.launches}


def _check_out(path: str) -> None:
    """Refuse the JAX package's committed artifacts at the repository root."""
    real = os.path.realpath(path)
    if (os.path.dirname(real) == os.path.realpath(REPO)
            and os.path.basename(real).startswith("LANE_SCALE")):
        raise SystemExit(f"--out {path}: the root LANE_SCALE*.md files are the JAX "
                         "package's records; write under build/ instead")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reads", type=int, default=100_000)
    parser.add_argument("--out", default=os.path.join(WORK, "lane_scale.json"))
    parser.add_argument("--root", default=os.path.join(WORK, "data"))
    parser.add_argument("--force-cpu", action="store_true",
                        help="run on the CPU (the plain versions) instead of the card")
    parser.add_argument("--min-heavy", type=int, default=20_000,
                        help="minimum unique molecules in the heavy region")
    parser.add_argument("--round2-full", action="store_true",
                        help="disable the targeted round-2 assign (A/B comparison "
                             "against the full fused pass)")
    args = parser.parse_args(argv)
    _check_out(args.out)

    import torch

    from ont_tcrconsensus_tpu_torch.device import resolve_device
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import run_with_config

    dev = resolve_device("cpu" if args.force_cpu else "cuda")
    root = args.root
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    lib, heavy_region, heavy_molecules = build_dataset(root, args.reads,
                                                       min_heavy=args.min_heavy)
    n_reads = len(lib.reads)
    print(f"dataset: {n_reads} reads, heavy region {heavy_region} with {heavy_molecules} "
          f"molecules; built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    cfg = RunConfig.from_dict({
        "reference_file": os.path.join(root, "reference.fa"),
        "fastq_pass_dir": os.path.join(root, "fastq_pass"),
        "minimal_length": 1000,
        "min_reads_per_cluster": 2,
        "delete_tmp_files": False,
        "write_intermediate_fastas": False,
        "error_profile_sample": 0,
        "round2_targeted_assign": not args.round2_full,
    })
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    t1 = time.perf_counter()
    results = run_with_config(cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_dt = time.perf_counter() - t1
    after = _launches()

    got = results.get("barcode01", {})
    want = lib.true_counts
    diffs = {k: (got.get(k, 0), want.get(k, 0))
             for k in set(got) | set(want) if got.get(k, 0) != want.get(k, 0)}
    logs_dir = os.path.join(root, "fastq_pass", "nano_tcr", "barcode01", "logs")
    artifact = {
        "n_reads": n_reads,
        "heavy_region_molecules": heavy_molecules,
        "round2_assign": "full" if args.round2_full else "targeted",
        "backend": dev.type,
        "wall_seconds": run_dt,
        "reads_per_sec": n_reads / run_dt,
        "counts_exact": got == want,
        "count_diffs": dict(list(diffs.items())[:20]),
        "heavy_region_count": (got.get(heavy_region, 0), heavy_molecules),
        "precision_at_depth": _precision_at_depth(logs_dir),
        "stage_timing_sec": _stage_timing(logs_dir),
        "peak_device_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None),
        "peak_host_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
    print(json.dumps(artifact, indent=2))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=2)
    return 0 if artifact["counts_exact"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
