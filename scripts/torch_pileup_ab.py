#!/usr/bin/env python3
"""Kernels B2 and B3 of several checkouts of the port, timed in turns on one
card in one call.

For each ``--root`` in the order given (name one twice to run in turns:
``--root A --root B --root B --root A``), a process of its own imports
that checkout's ``chip_smoke.py`` and its ``ont_tcrconsensus_tpu_torch``,
builds its kernels, and runs its phase-3 checks of B2 (``check_pileup``)
and B3 (``check_traceback``) at the main path's three shapes: each kernel
held to its plain version on the same card tensors, its device time behind
a spin (``ms``) and a call as its caller meets it (``call_ms``), CUDA-event
medians of 7. Main-path launches: no band centres. Each root's first run
also gives ptxas's registers and the SASS instruction counts of each
kernel instantiation. Prints one JSON line a root, then the card's
``nvidia-smi`` name and power limit; exit 1 if a root's run fails.

The parent commit goes inside the checkout, in a directory git ignores:

    mkdir -p .scratch/parent && git archive HEAD~1 | tar -x -C .scratch/parent
    python3 scripts/torch_pileup_ab.py --root .scratch/parent --root . \\
        --root . --root .scratch/parent --out chiprun_out/ab.json
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

SHAPES = ((1024, 2048, 64), (1024, 3072, 64), (1024, 3072, 128))  # chip_smoke.py phase 3


def child(root: str) -> dict:
    """One checkout's B2 and B3 rows (run in a process of its own)."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root,
                                                                            "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from ont_tcrconsensus_tpu_torch.ops import _build

    if not os.path.abspath(_build.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not the checkout at {root}")
    dev = torch.device("cuda")
    logs = _build.build_all()
    step_ns = smoke.staged_step_ns(dev)
    keys = ("N", "L", "W", "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    names = ("pileup_forward", "pileup_traceback")
    return {
        "root": root,
        # ptxas's report (empty when the library was already built) and each
        # instantiation's SASS instruction counts
        "ptxas": {k: [line.strip() for line in logs.get(k, "").splitlines()
                      if "registers" in line or "spill" in line] for k in names},
        "sass": {fn: mix for k in names for fn, mix in smoke._sass_mix(k).items()},
        "pileup": [{k: r[k] for k in keys} for r in (
            smoke.check_pileup(dev, 10 + seed, *shape) for seed, shape in enumerate(SHAPES))],
        "traceback": [{k: r[k] for k in keys} for r in (
            smoke.check_traceback(dev, 10 + seed, *shape, step_ns)
            for seed, shape in enumerate(SHAPES))],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout of the repository (repeat; run in the order given)")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    rows, rc = [], 0
    for root in map(os.path.abspath, args.root):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                               "--child", root], capture_output=True, text=True, timeout=900,
                              cwd=root)
        if proc.returncode != 0:
            print(f"{root}: exit {proc.returncode}\n{proc.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "nvidia_smi": smi.stdout.strip()}, fh, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
