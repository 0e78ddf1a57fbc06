#!/usr/bin/env python3
"""Time the PyTorch port's full lane with and without a one-slice data mesh.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/torch_mesh_ab.py [--out PATH]``. It builds the kernels,
writes ``chip_smoke.py``'s full lane (seed 33, 11,332 reads) and runs it
under the default config: one warm-up run unsharded, then in turns
unsharded, ``mesh_shape: {"data": 1}``, ``{"data": 1}``, unsharded, and
last ``{"data": 2}`` over two slices of card 0 (one card twice, not two
cards). Each run's wall seconds (host clock to a synchronized card),
reads/s and ``round1_polish`` seconds are printed, with the card's
``nvidia-smi`` name and power limit; every run's counts must equal the
truth. ``--out`` also writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the numbers to this JSON file")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.ops import _build
    from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

    smi = cs._nvidia_smi()
    _build.build_all()
    lib = simulator.simulate_library(
        seed=33, num_regions=56, molecules_per_region=(8, 14), reads_per_molecule=(12, 22),
        error_model=simulator.OntErrorModel(), with_adapters=True, num_similar_pairs=6,
        similar_divergence=0.01, num_negative_controls=2,
    )
    root = os.path.join(cs.WORK, "mesh_ab")
    cs._write_lane(root, lib)
    arms = [("warm-up, unsharded", None), ("unsharded", None), ("data=1", 1), ("data=1", 1),
            ("unsharded", None), ("data=2 on one card", 2)]
    runs = []
    for label, n in arms:
        knobs = dict(cs.FULL_KNOBS, **({"mesh_shape": {"data": n}} if n else {}))
        mesh_mod.install_slice_devices(["cuda:0"] * 2 if n == 2 else None)
        stage_s: dict[str, float] = {}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = cs._run_lane(root, knobs, "cuda", timings=stage_s)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            mesh_mod.install_slice_devices(None)
        if got.get("barcode01") != lib.true_counts:
            print(f"{label}: counts differ from the truth", file=sys.stderr)
            return 1
        runs.append({"arm": label, "seconds": seconds, "reads_per_s": len(lib.reads) / seconds,
                     "round1_polish_s": stage_s.get("round1_polish")})
        print(f"{label}: {seconds:.2f} s, {len(lib.reads) / seconds:.1f} reads/s, "
              f"round1_polish {stage_s.get('round1_polish'):.2f} s", flush=True)
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"nvidia_smi": smi, "n_reads": len(lib.reads), "runs": runs}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
