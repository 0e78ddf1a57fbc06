"""Streaming-ingest proof for the PyTorch port: O(chunk) host memory at
lane scale.

Generates a ~1M-read FASTQ (a 70M-read real lane is ~100+ GB; 1M reads,
~2 GB uncompressed, separate O(file) from O(chunk) by an order of
magnitude), then drives the port's FULL ingest path (native C++ parse ->
bucketed padded batches) twice in fresh subprocesses:

  streamed:   io.native.parse_chunks -> bucketing.batch_parsed_chunks
              (the pipeline's ingest of a path)
  wholefile:  io.native.parse_file   -> bucketing.batch_parsed_reads

and records each mode's peak RSS (ru_maxrss of the child). The proof is
that the streamed peak RSS stays near the chunk size while the whole-file
RSS scales with the file. Prints one JSON line; ``--out`` also writes a
Markdown table. Host-only: no device work.

Run: python scripts/torch_streaming_ingest_proof.py [--reads 1000000] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, resource, sys
sys.path.insert(0, __REPO__)
from ont_tcrconsensus_tpu_torch.io import bucketing, native

mode, path = sys.argv[1], sys.argv[2]
if mode == "streamed":
    batches = bucketing.batch_parsed_chunks(
        native.parse_chunks(path), batch_size=1024
    )
else:
    batches = bucketing.batch_parsed_reads(
        native.parse_file(path), batch_size=1024
    )
n_batches = n_reads = total_bases = 0
for b in batches:
    n_batches += 1
    n_reads += int(b.valid.sum())
    total_bases += int(b.lengths.sum())
print(json.dumps({
    "n_batches": n_batches, "n_reads": n_reads, "total_bases": total_bases,
    "peak_rss_gb": round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 3
    ),
}))
"""


def build_fastq(path: str, n_reads: int, seed: int = 3) -> int:
    """Plain (uncompressed) FASTQ so RSS comparisons are about PARSING,
    not zlib buffers; ~2 kb reads like the assay."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t0 = time.time()
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as fh:
        for i in range(n_reads):
            ln = int(rng.integers(1400, 2300))
            seq = bases[rng.integers(0, 4, ln)].tobytes().decode()
            qual = "I" * ln
            fh.write(f"@read{i} mol={i}\n{seq}\n+\n{qual}\n")
    size = os.path.getsize(path)
    print(f"built {n_reads} reads, {size/1e9:.2f} GB in {time.time()-t0:.0f}s",
          file=sys.stderr)
    return size


def run_mode(mode: str, path: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.replace("__REPO__", repr(REPO)), mode, path],
        capture_output=True, text=True, timeout=3600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} failed: {proc.stderr[-500:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--root", default=os.path.join(REPO, "build", "torch_stream_proof"),
                    help="where the generated FASTQ is written (removed after)")
    ap.add_argument("--out", default=None, help="also write a Markdown table here")
    ap.add_argument("--skip-wholefile", action="store_true")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from ont_tcrconsensus_tpu_torch.io import native

    if not native.available():
        print("native parser unavailable (no g++/zlib?) — nothing to prove",
              file=sys.stderr)
        return 2

    os.makedirs(args.root, exist_ok=True)
    path = os.path.join(args.root, "lane.fastq")
    size = build_fastq(path, args.reads)

    results = {}
    t0 = time.time()
    results["streamed"] = run_mode("streamed", path)
    results["streamed"]["wall_s"] = round(time.time() - t0, 1)
    if not args.skip_wholefile:
        t0 = time.time()
        results["wholefile"] = run_mode("wholefile", path)
        results["wholefile"]["wall_s"] = round(time.time() - t0, 1)

    for mode, r in results.items():
        print(f"{mode}: {r}", file=sys.stderr)
    s = results["streamed"]
    assert s["n_reads"] == args.reads, (s["n_reads"], args.reads)
    if "wholefile" in results:
        w = results["wholefile"]
        assert (s["n_batches"], s["n_reads"], s["total_bases"]) == (
            w["n_batches"], w["n_reads"], w["total_bases"]
        ), "streamed and whole-file ingest disagree"

    print(json.dumps({"reads": args.reads, "file_bytes": size, **results}))
    if args.out is None:
        os.remove(path)
        return 0
    with open(args.out, "w") as fh:
        fh.write("# Streaming ingest proof (PyTorch port)\n\n")
        fh.write(
            f"{args.reads} reads, {size/1e9:.2f} GB plain FASTQ, full ingest "
            "path (native C++ parse -> bucketed padded batches), each mode "
            "in a fresh subprocess; peak RSS = ru_maxrss.\n\n"
        )
        fh.write("| mode | peak RSS (GB) | wall (s) | batches | reads |\n")
        fh.write("|---|---|---|---|---|\n")
        for mode, r in results.items():
            fh.write(
                f"| {mode} | {r['peak_rss_gb']} | {r['wall_s']} | "
                f"{r['n_batches']} | {r['n_reads']} |\n"
            )
        if "wholefile" in results:
            ratio = results["wholefile"]["peak_rss_gb"] / max(
                results["streamed"]["peak_rss_gb"], 1e-9
            )
            fh.write(
                f"\nWhole-file ingest peaks at {ratio:.1f}x the streamed "
                "path's RSS; the streamed path is the pipeline's ingest of "
                "a path (pipeline/assign.py _batches_from_source), so peak "
                "host memory is O(chunk + pending batches), independent of "
                "lane size.\nBatch streams verified identical (count, reads, "
                "bases) between both modes.\n"
            )
    os.remove(path)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
