#!/usr/bin/env python3
"""bf16 polisher serving exactness A/B for the PyTorch port (the gate
artifact's generator).

The port serves the bi-GRU polisher in bfloat16 only behind an exactness
gate: where, and only where, this A/B showed byte-identical consensus
output on the same kind of device. It runs the pipeline polisher once in
float32 and once in bfloat16 (shared vote consensus and pileup, so a
difference is exactly a decision bf16 flipped) over simulated ONT-error
clusters at depths 2/4/6/10 and writes
``ont_tcrconsensus_tpu_torch/models/weights/polisher_bf16_ab_<backend>.json``,
which ``polisher.bf16_serving_certified`` reads. A retrain, another
depth-2 specialist, another card or another ``min_polish_depth`` voids it.

Run it from the repository root on the card you will serve on:

    python scripts/torch_bf16_ab.py                 # the CUDA card
    python scripts/torch_bf16_ab.py --cpu           # machinery check on the host
    python scripts/torch_bf16_ab.py --n 256         # deeper certification
    python scripts/torch_bf16_ab.py --out /tmp/ab.json

Exit code 0 when the outputs are identical (the artifact certifies bf16),
1 when not (the artifact records the mismatch and serving stays float32).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=96, help="clusters to A/B")
    ap.add_argument("--template-len", type=int, default=1300)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--out", default=None,
                    help="artifact path (default: the backend's gate path)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from ont_tcrconsensus_tpu_torch.models import polisher

    rec = polisher.run_bf16_exactness_ab(
        n_clusters=args.n, template_len=args.template_len, seed=args.seed,
        out_path=args.out, device="cpu" if args.cpu else None,
    )
    print(json.dumps(rec, indent=1))
    if rec["identical"]:
        print(f"bf16_ab: IDENTICAL on {rec['backend']} — bf16 serving "
              "certified", file=sys.stderr)
        return 0
    print(f"bf16_ab: {rec['mismatched_clusters']}/{rec['n_clusters']} "
          f"clusters diverged on {rec['backend']} — serving stays fp32",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
