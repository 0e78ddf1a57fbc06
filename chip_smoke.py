#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, kernels held to their
plain versions.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and imports nothing of the JAX package. Phases, each
of which fails the script (non-zero exit, no result line):

1. device: the card's name and ``nvidia-smi`` name/power-limit line;
2. build: both kernels (``ont_tcrconsensus_tpu_torch/csrc/*.cu``), one
   ``nvcc`` each, started together; ptxas's registers and spills and each
   instantiation's SASS instruction mix (``cuobjdump``) are printed;
3. kernel parity: kernel B1 (banded SW stats) at B=2048, W=128 and kernel
   B2 (pileup forward planes) at N=1024, W=64, each at L=2048 and L=3072
   (the width buckets of 1.4-2.3 kb reads), plus B1 at the self-homology
   band 512 and B2 at the 3072 bucket's band 128, against the plain
   PyTorch version on the same card tensors: every output exactly equal.
   Times are CUDA-event medians of 7 calls after 2 warm-ups; the bound is
   the larger of bytes over the HBM rate and the int32 operations the
   function needs over the int32 issue rate (``_bound_ms``); the design's
   own floor (its second F pass, band-shift moves, carry scan and warp
   shuffles) is reported beside it. The plain versions' times are one
   call each. Then one polish round at a main-path tile, split into the
   B2 forward, the traceback and the vote, and traced once with
   ``torch.profiler`` for the card's busy share;
4. polisher parity: at the same tile, the vote rounds' kept final pileup
   (recomputed against the final drafts if the rounds ran out), then the
   features and the served (v3) bi-GRU on ``cuda`` and on ``cpu``: the
   largest logit difference, and the positions whose gated decisions
   (0.9 confidence, depth gate) differ, which must be none; the card's
   times (CUDA-event medians of 7) of the features and the network;
5. error profile: 512 simulated reads of 1.4-2.3 kb (the systematic ONT
   error model, seed 5) against their reference spans, through the QC
   error profile's device path on ``cuda`` (plain PyTorch: the JAX
   package's XLA scans, no Pallas kernel) and its numpy fill: every cs
   string equal. The device path's seconds (host clock to a synchronized
   card, two calls) and, from one call traced by ``torch.profiler``, its
   device events (kernel launches and copies) and busy time;
6. small e2e: the tests' 4-region lane under ``rnn`` (the default) and
   under ``poa``, each on ``cuda`` and on ``cpu`` (plain versions): every
   file under ``nano_tcr/`` byte-identical (the QC logs and CSVs, both
   error profiles, the reports), but the stage manifest's timestamps and
   the stage table's seconds (its stage names must agree), counts equal to
   the simulator's truth;
7. full-size e2e: the representative lane (about 11k untrimmed reads of
   1.4-2.3 kb, 56 regions + 6 near-duplicate pairs + 2 negative controls,
   the systematic ONT error model, read batch 1024, band 128, seed 33) on
   ``cuda``, unobserved: the default config (``rnn`` polish, the error
   profiles of 512 reads a round on the overlapped QC worker) first, then
   in turns the default config with ``error_profile_sample: 0`` (no QC
   profile), with ``overlap_qc: false`` (the profiles on the main thread)
   and the default config again, ``--lane-runs`` rounds (1 by default),
   then once under ``poa``. Kernel launch counts are zeroed
   just before the first run and read just after it, and again around the
   ``poa`` run; each kernel must have launched in both, and every run's
   counts must equal the truth. Each run's stage seconds are printed under
   the stage table's names, the error profiles' worker seconds
   (``*_bg``) beside the main thread's wait at their commit. The first
   run also records each launch's (batch, L, Lr, W), with a host copy of
   each shape's first inputs (off the card, so the run's peak memory is
   the lane's own; the copies are in that run's wall time); after the
   runs each shape's kernel is timed on those inputs, for the launches x
   (time - bound) the run spent at its real shapes. Peak device memory
   and the polisher's seconds (host clock to its stream synchronized) are
   read per run, and the peak reached inside a polisher call when that
   call raised it.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes every number
to a JSON file.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM rates. HBM3: 3.35 TB/s (the on-chip-measurement guide's table,
# from NVIDIA's data sheet). int32: that table has no int32 rate; its
# float32 rate, 67 TFLOP/s outside the tensor cores, is 132 SMs x 128 lanes
# x 1.98 GHz with an FMA counted as two. An SM issues at most one warp
# instruction (32 lanes) a clock in each of its four sub-partitions, 128
# lane-operations a clock whatever the pipe, and the compiler issues int32
# adds and moves as IMAD on the FMA pipe beside the 64-lane INT32 pipe, so
# the INT32 lanes alone are not the ceiling: 132 x 128 x 1.98e9 =
# 33.5 Tops/s. Warp shuffles: 32 a clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
SHUFFLES_PER_S = 132 * 32 * 1.98e9
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (the same table)

# int32 operations a band cell needs, one per two-input add, compare,
# select or logical op, counted from the plain versions' recurrences
# (ops/sw_align.py, ops/pileup.py); loads and per-row terms are not
# counted. F, the in-row ref-gap max-plus, is counted as the sequential
# recurrence g[b] = max(tmp[b], g[b-1] - ext) with ties kept at b: it picks
# the nearest origin, as the kernels' strictly-greater doubling does.
SW_CELL_OPS = {
    "cell index, validity, match test, substitution": 9,
    "E: open vs extend, four channels, one more column": 9,
    "diagonal: fresh test, score, four channels": 9,
    "tmp: diagonal vs E vs fresh, five values each, band mask": 14,
    "F: sequential max-plus, four channels, gap length": 9,
    "F: open, column count": 3,
    "H: F vs tmp, five values, band mask": 7,
    "E: band mask": 1,
    "best: compare, score, row, four channels": 7,
}
PILEUP_CELL_OPS = {
    "cell index, validity, match test, substitution": 10,
    "E: open vs extend": 4,
    "diagonal: fresh test, score, direction": 4,
    "tmp: diagonal vs E vs fresh with direction, band mask": 7,
    "E-opened bit": 2,
    "F: sequential max-plus, gap length": 5,
    "F: open": 1,
    "H: F vs tmp, band mask": 3,
    "fjump and the packed plane": 5,
    "E: band mask": 1,
    "best: compare, score, row": 3,
}
# Cells past a read's end + 1 in B2: H and E are NEG there, so the plane is
# the fresh-start direction of each cell (csrc/pileup_forward.cu).
PILEUP_PAD_CELL_OPS = {
    "match test, substitution": 4,
    "direction: E fill vs diagonal vs fresh, E-opened bit": 5,
}
# The kernels' own work (csrc/dp_common.cuh): a lane owns NS = 4 contiguous
# slots (2 for B2 at W=64), a warp 32 * NS, a band W / (32 * NS) warps. Per
# cell: the recurrences as the design computes them (B1's four channels
# packed in two words, so a choice moves three registers, not five; F as a
# second pass over the lane's slots from the scanned carry); for NS - 1 of
# NS slots, the lane's local F step and the register moves of the band
# shift (E's words and the ref window); per lane and row, the carry scan's
# keys and maxes, the winner's decoding, the row's constants, loads, codes
# and loop; and per lane and row, the warp shuffles of E's edge, the scan
# (6) and the winner's fields, more when a band spans warps.
SW_DESIGN = {
    "cell_ops": {
        "E: open vs extend, value and two channel words": 6,
        "tmp: validity, match test, diagonal score and channel words": 12,
        "tmp: E vs diagonal and empty clamp (three words each), band mask": 10,
        "E: one more column": 1,
        "F pass: open, H vs F, gap columns, band masks, carry of three words": 17,
        "best: compare, score, key, two channel words": 6,
    },
    "f_step_ops": 7, "shift_moves": 4, "row_ops": 30,
    "row_shuffles": 12, "row_shuffles_multi_warp": 4,
}
PILEUP_DESIGN = {
    "cell_ops": {
        "E: open vs extend, opened bit": 5,
        "tmp: validity with the row, match test, diagonal, direction": 9,
        "tmp: E vs diagonal, empty clamp, band mask": 6,
        "E-opened bit into the plane": 1,
        "F pass: open, H vs F, band masks, fjump, carry": 14,
        "best: compare, score, key": 4,
        "plane word": 1,
    },
    "f_step_ops": 4, "shift_moves": 3, "row_ops": 28,
    "row_shuffles": 9, "row_shuffles_multi_warp": 0,
}


def _design_per_cell(W: int, design: dict):
    """The kernel design's int32 operations (register moves included) and
    warp shuffles a cell: NS slots a lane, so per-lane-row terms are shared
    by NS cells."""
    ns = min(W // 32, 4)
    ops = (sum(design["cell_ops"].values())
           + (design["f_step_ops"] + design["shift_moves"]) * (ns - 1) / ns
           + design["row_ops"] / ns)
    multi_warp = W > 32 * ns
    shuffles = (design["row_shuffles"] + design["row_shuffles_multi_warp"] * multi_warp) / ns
    return ops, shuffles


def _costs(cells: int, n_bytes: int, W: int, cell_ops: dict, design: dict,
           pad_cells: int = 0) -> dict:
    """Bound and design floor of ``cells`` DP cells (and ``pad_cells``
    cells of B2 past a read's end, at PILEUP_PAD_CELL_OPS)."""
    fn_ops = sum(cell_ops.values())
    pad_ops = sum(PILEUP_PAD_CELL_OPS.values())
    bound, by = _bound_ms(n_bytes, cells * fn_ops + pad_cells * pad_ops)
    design_ops, design_shuffles = _design_per_cell(W, design)
    design_ms = (cells * max(design_ops / INT32_OPS_PER_S, design_shuffles / SHUFFLES_PER_S)
                 + pad_cells * pad_ops / INT32_OPS_PER_S) * 1e3
    return {"cells": cells, "pad_cells": pad_cells, "bound_ms": bound, "bound_by": by,
            "fn_ops_per_cell": fn_ops, "design_ops_per_cell": design_ops,
            "design_shuffles_per_cell": design_shuffles, "design_bound_ms": design_ms}


SASS_MNEMONICS = ("IMAD", "IADD3", "ISETP", "SEL", "LOP3", "VIMNMX", "IMNMX", "MOV", "SHFL",
                  "BAR", "LDL", "STL")


def _sass_mix(name: str) -> dict[str, dict[str, int]]:
    """Static SASS instruction counts of each instantiation of a built
    kernel, by mnemonic (``cuobjdump -sass``): which pipes the compiler put
    the int32 work on (IMAD issues on the FMA pipe; IADD3, ISETP, SEL,
    LOP3 and IMNMX on the INT32 pipe), the shuffles it kept and the local
    memory spills; ``all`` counts every instruction."""
    from ont_tcrconsensus_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    mix: dict[str, collections.Counter] = {}
    counter = None
    for line in text.splitlines():
        fn = re.search(r"Function : \S*?([a-z][a-z_]*_kernel)I((?:Li\d+E)+)E", line)
        if fn:
            args = ",".join(re.findall(r"Li(\d+)E", fn.group(2)))
            counter = mix.setdefault(f"{fn.group(1)}<{args}>", collections.Counter())
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]+)", line)
        if counter is not None and op:
            counter[op.group(1)] += 1
    return {fn: {**{m: c[m] for m in SASS_MNEMONICS}, "all": sum(c.values())}
            for fn, c in sorted(mix.items())}


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` to a synchronized device, for
    work driven from the host (a loop of launches)."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _device_ms(fn) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` (CUDA activity): the
    milliseconds in which the card ran a kernel, copy or set (the device
    events' intervals merged), and the number of those events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"device_ms": busy_us / 1e3, "events": len(spans)}


def _time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` calls (the caller
    has warmed it up)."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# kernels against their plain versions


def check_sw(dev, seed: int, B: int, L: int, W: int) -> dict:
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import sw_align, sw_kernel

    reads, rl, refs, tl, offs = (torch.from_numpy(x).to(dev)
                                 for x in dp_cases.dp_batch(B, L, W, seed))
    args = (reads, rl, refs, tl, offs)
    got = sw_kernel.align_banded_cuda(*args, band_width=W)
    want = sw_align.align_banded(*args, band_width=W)
    torch.cuda.synchronize()
    max_err = 0
    for f in ("score", "read_start", "read_end", "ref_start", "ref_end", "n_match", "n_cols"):
        a, b = getattr(got, f), getattr(want, f)
        err = int((a.long() - b.long()).abs().max())
        if err:
            bad = int((a != b).nonzero()[0, 0])
            raise AssertionError(f"B1 L={L}: {f} differs (first pair {bad}: "
                                 f"kernel {int(a[bad])}, plain {int(b[bad])})")
        max_err = max(max_err, err)
    for _ in range(2):
        sw_kernel.align_banded_cuda(*args, band_width=W)
    ms = _time_ms(lambda: sw_kernel.align_banded_cuda(*args, band_width=W), 7)
    plain_ms = _time_ms(lambda: sw_align.align_banded(*args, band_width=W), 1)
    return {"L": L, "B": B, "W": W, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            **_sw_costs(rl, refs.shape[1], L, W),
            "aligned_pairs": int((got.score > 0).sum())}


def _sw_costs(rl, Lr: int, L: int, W: int) -> dict:
    """B1's bound and design floor for read lengths ``rl``: rows past a
    read's length cannot move the result, so the function needs only the
    rows of each read, and reads each read base once."""
    import torch

    B = rl.shape[0]
    rows = int(torch.clamp(rl, min=0, max=L).long().sum())
    n_bytes = rows + B * Lr + 3 * 4 * B + 7 * 4 * B
    return _costs(rows * W, n_bytes, W, SW_CELL_OPS, SW_DESIGN)


def check_pileup(dev, seed: int, N: int, L: int, W: int) -> dict:
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import pileup, pileup_kernel

    reads, rl, refs, tl, _ = (torch.from_numpy(x).to(dev)
                              for x in dp_cases.dp_batch(N, L, W, seed, offsets=False))
    args = (reads, rl, refs, tl)
    best_k, planes_k = pileup_kernel.forward_planes_cuda(*args, band_width=W)
    best_p, planes_p = pileup._forward_batch(*args, band_width=W)
    torch.cuda.synchronize()
    for name, a, b in (("best", best_k, best_p), ("planes", planes_k, planes_p)):
        if not torch.equal(a, b):
            bad = (a != b).reshape(N, -1).any(dim=1).nonzero()[0, 0]
            raise AssertionError(f"B2 L={L}: {name} differs (first lane {int(bad)})")
    max_err = max(int((best_k.long() - best_p.long()).abs().max()),
                  int((planes_k.int() - planes_p.int()).abs().max()))
    for _ in range(2):
        pileup_kernel.forward_planes_cuda(*args, band_width=W)
    ms = _time_ms(lambda: pileup_kernel.forward_planes_cuda(*args, band_width=W), 7)
    plain_ms = _time_ms(lambda: pileup._forward_batch(*args, band_width=W), 1)
    return {"L": L, "N": N, "W": W, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            **_pileup_costs(rl, refs.shape[1], L, W),
            "aligned_lanes": int((best_k[:, 0] > 0).sum())}


def _pileup_costs(rl, Lr: int, L: int, W: int) -> dict:
    """B2's bound and design floor for read lengths ``rl``: every row's
    planes are output, each cell written once; the rows of a read and the
    one after its end need the DP, the rows after that only the bases."""
    import torch

    N = rl.shape[0]
    dp_rows = int(torch.clamp(rl.long() + 1, min=0, max=L).sum())
    n_bytes = N * L + N * Lr + 2 * 4 * N + 3 * 4 * N + 2 * N * L * W
    return _costs(dp_rows * W, n_bytes, W, PILEUP_CELL_OPS, PILEUP_DESIGN,
                  pad_cells=(N * L - dp_rows) * W)


@contextlib.contextmanager
def _launch_shapes(module, name: str, shape_of):
    """Count the CUDA calls of the dispatcher ``module.name`` by input shape
    while the block runs, keeping a host copy of the first call's inputs of
    each shape: {shape: [calls, args, kwargs]}. The dispatcher is wrapped,
    not the kernel's wrapper, which keeps counting its own launches."""
    import torch

    fn = getattr(module, name)
    seen: dict = {}

    def record(*args, **kwargs):
        shape = shape_of(*args, **kwargs)
        if shape[0] and args[0].device.type == "cuda":
            if shape not in seen:
                seen[shape] = [0, tuple(a.to("cpu", copy=True) if torch.is_tensor(a) else a
                                        for a in args), dict(kwargs)]
            seen[shape][0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def _sw_shape(reads, read_lens, refs, *rest, band_width=256, **_):
    return (reads.shape[0], reads.shape[1], refs.shape[1], band_width)


def _pileup_shape(reads, read_lens, refs, ref_lens, band_width):
    return (reads.shape[0], reads.shape[1], refs.shape[1], band_width)


def launch_gaps(shapes: dict, launch, costs, dev) -> dict:
    """Each recorded shape's kernel time on its first launch's own inputs,
    moved back to the card (CUDA-event median of 5 after one warm-up), its
    bound, and the launches x (time - bound) it costs the run."""
    import torch

    rows, total = [], 0.0
    for shape, (calls, host_args, kwargs) in sorted(shapes.items()):
        args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in host_args)
        launch(*args, **kwargs)
        ms = _time_ms(lambda: launch(*args, **kwargs), 5)
        c = costs(args[1], shape[2], shape[1], shape[3])
        gap = calls * (ms - c["bound_ms"])
        total += gap
        rows.append({"shape": list(shape), "launches": calls, "ms": ms,
                     "bound_ms": c["bound_ms"], "design_bound_ms": c["design_bound_ms"],
                     "launches_x_gap_ms": gap})
    return {"shapes": rows, "launches_x_gap_ms": total,
            "kernel_ms": sum(r["launches"] * r["ms"] for r in rows)}


def _polish_tile(seed: int, C: int, S: int, L: int):
    """C clusters of S noisy copies (8% errors) of one template each, width
    L, and a draft per cluster (a 3%-error copy): (reads (C, S, L), read
    lengths (C, S), drafts (C, L), draft lengths (C,)), numpy."""
    from ont_tcrconsensus_tpu_torch.io.dp_cases import noisy_copy

    rng = np.random.default_rng(seed)
    reads = np.full((C, S, L), 5, np.uint8)
    drafts = np.full((C, L), 5, np.uint8)
    rl = np.zeros((C, S), np.int32)
    dl = np.zeros(C, np.int32)
    for c in range(C):
        tpl = rng.integers(0, 4, int(rng.integers(L - 600, L - 140))).astype(np.uint8)
        draft = noisy_copy(rng, tpl, 0.03)[:L]
        drafts[c, : len(draft)], dl[c] = draft, len(draft)
        for s in range(S):
            read = noisy_copy(rng, tpl, 0.08)[:L]
            reads[c, s, : len(read)], rl[c, s] = read, len(read)
    return reads, rl, drafts, dl


def polish_split(dev, seed: int, C: int = 64, S: int = 16, L: int = 2048, W: int = 64) -> dict:
    """One polish round at a main-path tile (C clusters of S subreads, width
    L, band W), split into the kernel B2 forward, the plain scan-log
    traceback and the vote; then the whole round once more under
    ``torch.profiler``, whose device time over the round's unprofiled wall
    time is the card's busy share in polish."""
    import torch

    from ont_tcrconsensus_tpu_torch.ops import consensus, pileup

    reads, rl, drafts, dl = _polish_tile(seed, C, S, L)
    reads_t, rl_t, dl_t = (torch.from_numpy(x).to(dev) for x in
                           (reads.reshape(C * S, L), rl.reshape(C * S), dl))
    drafts_t = torch.from_numpy(drafts).to(dev)
    refs_t = drafts_t.repeat_interleave(S, dim=0)
    tl_t = dl_t.repeat_interleave(S)

    def forward():
        return pileup.forward_auto(reads_t, rl_t, refs_t, tl_t, W)

    best, planes = forward()
    fwd_ms = _host_ms(forward, 3)

    def traceback():
        return pileup._traceback_batch(best, planes, reads_t, W, L)

    base_at, ins_cnt, ins_base = (x.reshape(C, S, L) for x in traceback()[:3])
    tb_ms = _host_ms(traceback, 3)
    vote_ms = _host_ms(
        lambda: consensus.vote_columns_batch(base_at, ins_cnt, ins_base, drafts_t, dl_t), 3)

    def one_round():
        b, p = forward()
        cols = (x.reshape(C, S, L) for x in pileup._traceback_batch(b, p, reads_t, W, L)[:3])
        return consensus.vote_columns_batch(*cols, drafts_t, dl_t)

    round_ms = _host_ms(one_round, 1)
    traced = _device_ms(one_round)
    busy = traced["device_ms"] / round_ms if traced["events"] else None
    return {"C": C, "S": S, "L": L, "W": W, "forward_ms": fwd_ms, "traceback_ms": tb_ms,
            "vote_ms": vote_ms, "round_ms": round_ms, "device_ms": traced["device_ms"],
            "device_events": traced["events"], "busy_share": busy}


# float32 operations of the polisher network a position (a multiply-add
# counted as two): Dense(F, 96); per GRU layer and direction three gates,
# each an input and a hidden product; Dense(192, 10). Gate nonlinearities
# and the GELU are not counted.
def _polisher_flops_per_position(F: int, hidden: int = 96) -> int:
    gru = sum(2 * 3 * hidden * (fan_in + hidden) * 2 for fan_in in (hidden, 2 * hidden))
    return 2 * F * hidden + gru + 2 * 2 * hidden * 10


def polisher_parity(seed: int, C: int = 64, S: int = 16, L: int = 2048, W: int = 64) -> dict:
    """The served polisher at a main-path tile on the card and on the CPU:
    the consensus rounds' kept final pileup (recomputed against the final
    drafts if the rounds ran out), its features and the network's logits
    on both devices. Every gated decision must agree: the class call where
    the class softmax clears 0.9, the insertion where the insertion softmax
    does, at covered positions of clusters at or above the depth gate."""
    import torch

    from ont_tcrconsensus_tpu_torch import convert
    from ont_tcrconsensus_tpu_torch.models import polisher
    from ont_tcrconsensus_tpu_torch.ops import consensus, pileup

    reads, rl, _, _ = _polish_tile(seed, C, S, L)
    t0 = time.perf_counter()
    drafts, dlens, kept = consensus.consensus_clusters_batch(
        reads, rl, band_width=W, keep_final_pileup=True, keep_pos=False, device="cuda")
    torch.cuda.synchronize()
    consensus_s = time.perf_counter() - t0
    source = "kept"
    if kept is None:
        source = "recomputed"
        kept = pileup.pileup_columns_batch_auto(
            torch.from_numpy(reads).cuda(), torch.from_numpy(rl).cuda(),
            torch.from_numpy(drafts).cuda(), torch.from_numpy(dlens).cuda(),
            band_width=W, out_len=L)[:3]
    params = polisher.load_default_params()
    live = (rl > 0).sum(axis=1)
    in_draft = np.arange(L)[None, :] < dlens[:, None]
    res: dict = {"C": C, "S": S, "L": L, "W": W, "pileup": source, "consensus_s": consensus_s,
                 "weights": os.path.basename(polisher.serving_weights_path())}
    got = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            planes = [x.to(dev) for x in kept[:3]]
            drafts_t = torch.from_numpy(drafts).to(dev)
            model = convert.polisher_from_numpy(params, device=dev)
            feats = consensus.pileup_features(*planes, drafts_t)
            logits = model(feats)
            pred, conf, depth, ins_pred, ins_conf = polisher._predictions(model, feats, planes[0])
            covered = in_draft & (depth > 0) & (live >= 4)[:, None]
            cls_call = np.where(covered & (conf >= 0.9), pred, 255)
            ins_call = np.where(covered & (ins_conf >= 0.9) & (ins_pred > 0), ins_pred, 0)
            got[dev] = {"feats": feats.cpu(), "logits": logits.cpu(), "cls": cls_call,
                        "ins": ins_call, "conf": conf, "ins_conf": ins_conf}
            if dev == "cuda":
                for _ in range(2):
                    model(consensus.pileup_features(*planes, drafts_t))
                res["features_ms"] = _time_ms(
                    lambda: consensus.pileup_features(*planes, drafts_t), 7)
                res["network_ms"] = _time_ms(lambda: model(feats), 7)
    a, b = got["cuda"], got["cpu"]
    res["max_abs_feature_diff"] = float((a["feats"] - b["feats"]).abs().max())
    res["max_abs_logit_diff"] = float((a["logits"] - b["logits"]).abs().max())
    flips = np.argwhere((a["cls"] != b["cls"]) | (a["ins"] != b["ins"]))
    res["decision_flips"] = len(flips)
    res["flips"] = [{"cluster": int(c), "position": int(j),
                     "conf": [float(a["conf"][c, j]), float(b["conf"][c, j])],
                     "ins_conf": [float(a["ins_conf"][c, j]), float(b["ins_conf"][c, j])]}
                    for c, j in flips[:20]]
    res["class_calls_changing_the_draft"] = int(
        ((a["cls"] != 255) & (a["cls"] != np.where(in_draft, drafts, 255))).sum())
    res["insertion_calls"] = int((a["ins"] > 0).sum())
    flops = C * L * _polisher_flops_per_position(a["feats"].shape[-1])
    res["network_bound_ms"] = flops / FP32_FLOPS_PER_S * 1e3
    return res


# ---------------------------------------------------------------------------
# the QC error profile


def error_profile_phase(seed: int = 5, n: int = 512) -> dict:
    """The error profile's cs strings of ``n`` simulated reads (1.4-2.3 kb
    regions, the systematic ONT error model) against their reference
    spans: the device path on the card against the numpy fill, every
    string equal. Times: the device path twice (host clock to a
    synchronized card) and the numpy fill once; then one device call traced
    for its device events and busy time."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.ops import encode
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    rng = np.random.default_rng(seed)
    ref = simulator.make_reference(rng, num_regions=32, region_len=(1400, 2300))
    names = list(ref)
    model = simulator.OntErrorModel()
    queries, spans = [], []
    for _ in range(n):
        seq = ref[names[int(rng.integers(len(names)))]]
        span = seq[int(rng.integers(0, 30)): len(seq) - int(rng.integers(0, 30))]
        read, _ = simulator.mutate_ont(rng, span, model)
        queries.append(encode.encode_seq(read))
        spans.append(encode.encode_seq(span))
    t0 = time.perf_counter()
    want = error_profile.banded_cs_batch(queries, spans)
    numpy_s = time.perf_counter() - t0
    device_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = error_profile.banded_cs_batch_device(queries, spans, device="cuda")
        torch.cuda.synchronize()
        device_s.append(time.perf_counter() - t0)
        if got != want:
            bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"error profile: read {bad}'s cs string differs between "
                                 f"the device path and numpy: {got[bad][:80]!r} vs "
                                 f"{want[bad][:80]!r}")
    traced = _device_ms(lambda: error_profile.banded_cs_batch_device(queries, spans,
                                                                     device="cuda"))
    lens = [len(q) for q in queries]
    return {"n_reads": n, "read_len": [min(lens), max(lens)], "device_s": device_s,
            "numpy_s": numpy_s, "device_events": traced["events"],
            "device_busy_ms": traced["device_ms"], "strings_equal": True}


# ---------------------------------------------------------------------------
# end to end


def _write_lane(root: str, lib) -> None:
    from ont_tcrconsensus_tpu_torch.io import fastx

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "fastq_pass", "barcode01"))
    fastx.write_fasta(os.path.join(root, "reference.fa"), lib.reference.items())
    fastx.write_fastq(os.path.join(root, "fastq_pass", "barcode01", "barcode01.fastq.gz"),
                      lib.reads)


def _run_lane(root: str, knobs: dict, device: str, timings: dict | None = None):
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import run_with_config

    shutil.rmtree(os.path.join(root, "fastq_pass", "nano_tcr"), ignore_errors=True)
    cfg = RunConfig.from_dict({
        "reference_file": os.path.join(root, "reference.fa"),
        "fastq_pass_dir": os.path.join(root, "fastq_pass"),
        "delete_tmp_files": False,
        **knobs,
    })
    return run_with_config(cfg, device=device, timings=timings)


# files of a run that hold times, not results
TIMED_FILES = ("barcode01/stage_manifest.json", "barcode01/logs/stage_timing.tsv")


def _artifacts(root: str) -> dict[str, bytes]:
    """Every file under ``nano_tcr/``, by path under it."""
    nano = os.path.join(root, "fastq_pass", "nano_tcr")
    out = {}
    for dirpath, _, files in os.walk(nano):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, nano)] = fh.read()
    return out


def _stage_names(tree: dict[str, bytes]) -> list[str]:
    rows = tree[TIMED_FILES[1]].decode().splitlines()[1:]
    return sorted(r.split("\t")[0] for r in rows)


# the lanes' polish: the default config (no polish_method key: the bi-GRU
# polisher) and the vote consensus alone
POLISH = {"rnn": {}, "poa": {"polish_method": "poa"}}


def small_e2e(method: str) -> dict:
    import torch

    from ont_tcrconsensus_tpu_torch.io import simulator

    lib = simulator.simulate_library(
        seed=11, num_regions=4, molecules_per_region=(2, 3), reads_per_molecule=(5, 8),
        sub_rate=0.006, ins_rate=0.003, del_rate=0.003, region_len=(700, 850),
    )
    root = os.path.join(WORK, "small")
    _write_lane(root, lib)
    knobs = {"minimal_length": 600, "min_reads_per_cluster": 4, "read_batch_size": 64,
             **POLISH[method]}
    t0 = time.perf_counter()
    got_cuda = _run_lane(root, knobs, "cuda")
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    art_cuda = _artifacts(root)
    t0 = time.perf_counter()
    got_cpu = _run_lane(root, knobs, "cpu")
    cpu_s = time.perf_counter() - t0
    art_cpu = _artifacts(root)
    if sorted(art_cuda) != sorted(art_cpu):
        raise AssertionError(f"small e2e ({method}): the file sets differ between cuda and "
                             f"cpu: {sorted(set(art_cuda) ^ set(art_cpu))}")
    for rel in sorted(set(art_cuda) - set(TIMED_FILES)):
        if art_cuda[rel] != art_cpu[rel]:
            raise AssertionError(f"small e2e ({method}): {rel} differs between cuda and cpu")
    if _stage_names(art_cuda) != _stage_names(art_cpu):
        raise AssertionError(f"small e2e ({method}): stage names differ between cuda and cpu")
    for dev, got in (("cuda", got_cuda), ("cpu", got_cpu)):
        if got.get("barcode01") != lib.true_counts:
            raise AssertionError(f"small e2e ({method}) on {dev}: counts "
                                 f"{got.get('barcode01')} != truth {lib.true_counts}")
    return {"polish": method, "n_reads": len(lib.reads), "cuda_s": cuda_s, "cpu_s": cpu_s,
            "files_compared": len(art_cuda) - len(TIMED_FILES), "artifacts_identical": True,
            "counts_exact": True}


@contextlib.contextmanager
def _polisher_clock(stats: dict):
    """While the block runs, add the host-clock seconds of every polisher
    call, its stream synchronized before and after, to ``stats["s"]``, and
    set ``stats["peak_gb"]`` to the highest device-memory peak reached
    inside a call that raised the process's peak (the factory the run calls
    is wrapped; the polisher's arithmetic is untouched)."""
    import torch

    from ont_tcrconsensus_tpu_torch.models import polisher

    make = polisher.make_pipeline_polisher

    def timed_make(*args, **kwargs):
        polish = make(*args, **kwargs)

        def timed(*a, **kw):
            # the calling thread's stream only: the QC worker has its own
            torch.cuda.current_stream().synchronize()
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            try:
                return polish(*a, **kw)
            finally:
                torch.cuda.current_stream().synchronize()
                stats["s"] += time.perf_counter() - t0
                if torch.cuda.max_memory_allocated() > peak:
                    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

        timed.wants_v4 = polish.wants_v4
        return timed

    polisher.make_pipeline_polisher = timed_make
    try:
        yield
    finally:
        polisher.make_pipeline_polisher = make


# the full lane's runs: the default config (rnn polish, QC profiles on
# the overlapped worker), the same without the error profiles and with
# them on the main thread, and the vote consensus alone
LANE_RUNS = {**POLISH, "rnn, error_profile_sample 0": {"error_profile_sample": 0},
             "rnn, overlap_qc false": {"overlap_qc": False}}


def full_e2e(kernels, rounds: int) -> dict:
    """The full lane: the default config, then ``rounds`` times in turns the
    default config without the error profiles, with them on the main
    thread, and as it is, then once under ``poa``. Kernel launches are
    counted over the first run (recorded by shape for :func:`launch_gaps`)
    and over the ``poa`` run, each from zero."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.ops import pileup, pileup_kernel, sw_kernel

    dev = torch.device("cuda")
    recorded = {"sw": (sw_kernel, "align_banded_auto", _sw_shape),
                "pileup": (pileup, "forward_auto", _pileup_shape)}
    shapes: dict = {}

    t0 = time.perf_counter()
    lib = simulator.simulate_library(
        seed=33, num_regions=56, molecules_per_region=(8, 14), reads_per_molecule=(12, 22),
        error_model=simulator.OntErrorModel(), with_adapters=True, num_similar_pairs=6,
        similar_divergence=0.01, num_negative_controls=2,
    )
    root = os.path.join(WORK, "full")
    _write_lane(root, lib)
    data_s = time.perf_counter() - t0
    knobs = {"minimal_length": 1000, "min_reads_per_cluster": 4, "read_batch_size": 1024}
    methods = (["rnn"] + ["rnn, error_profile_sample 0", "rnn, overlap_qc false", "rnn"] * rounds
               + ["poa"])
    seconds, stages, peaks, polisher_runs, launches, diffs = [], [], [], [], {}, {}
    for run, method in enumerate(methods):
        counted = run == 0 or method == "poa"  # each path's launches, from zero
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if counted:
            for k in kernels:
                k.launches = 0
        stage_s: dict[str, float] = {}
        pol = {"s": 0.0, "peak_gb": None}
        with contextlib.ExitStack() as stack:
            if run == 0:
                shapes = {key: stack.enter_context(_launch_shapes(module, name, shape_of))
                          for key, (module, name, shape_of) in recorded.items()}
            stack.enter_context(_polisher_clock(pol))
            t0 = time.perf_counter()
            got = _run_lane(root, {**knobs, **LANE_RUNS[method]}, "cuda", timings=stage_s)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        stages.append(stage_s)
        polisher_runs.append(pol)
        if counted:
            launches[method] = {k.__name__: k.launches for k in kernels}
        counts = got.get("barcode01") or {}
        diffs.update({f"run {run} ({method}): {k}": (counts.get(k, 0), lib.true_counts.get(k, 0))
                      for k in set(counts) | set(lib.true_counts)
                      if counts.get(k, 0) != lib.true_counts.get(k, 0)})
    out = {"n_reads": len(lib.reads), "n_regions": len(lib.reference), "polish": methods,
           "seconds": seconds, "reads_per_s": [len(lib.reads) / s for s in seconds],
           "counts_exact": not diffs,
           "max_memory_allocated_gb": peaks, "polisher": polisher_runs,
           "data_s": data_s, "launches": launches, "stage_s": stages,
           "launch_gaps": {
               "sw": launch_gaps(shapes["sw"], sw_kernel.align_banded_cuda, _sw_costs, dev),
               "pileup": launch_gaps(shapes["pileup"], pileup_kernel.forward_planes_cuda,
                                     _pileup_costs, dev)}}
    if diffs:
        out["count_diffs"] = diffs
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every number to this JSON file")
    parser.add_argument("--lane-runs", type=int, default=1,
                        help="full-size lane: rounds of runs without the QC error profiles, "
                             "with them on the main thread and with them overlapped, after "
                             "the first (the main path's) run; one poa run follows them")
    args = parser.parse_args(argv)

    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this script needs one card")
    sys.path.insert(0, ROOT)
    try:
        from ont_tcrconsensus_tpu_torch.device import resolve_device
        from ont_tcrconsensus_tpu_torch.ops import _build, pileup_kernel, sw_kernel
    except ImportError as exc:
        return _fail(f"the port is not beside this script ({exc})")
    if any(m in ("jax", "flax", "ont_tcrconsensus_tpu")
           or m.startswith(("jax.", "flax.", "ont_tcrconsensus_tpu."))
           for m in sys.modules):
        return _fail("the port imported JAX or the JAX package")

    report: dict = {}
    # 1. device
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {smi}", flush=True)
    report["device"] = {"kind": kind, "nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda}

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    report["sass"] = {}
    for name in _build.KERNELS:
        for fn, mix in _sass_mix(name).items():
            report["sass"][fn] = mix
            print(f"  sass {fn}: " + ", ".join(f"{m} {n}" for m, n in mix.items()), flush=True)

    # 3. kernel parity at main-path shapes
    # (batch, L, W): the read passes' buckets at band 128, the
    # self-homology pass's band 512; polish at band 64, and at band 128 for
    # the 3072-wide bucket (stages.polish_clusters_all)
    report["sw"] = [check_sw(dev, seed, B, L, W) for seed, (B, L, W) in
                    enumerate(((2048, 2048, 128), (2048, 3072, 128), (256, 2560, 512)))]
    report["pileup"] = [check_pileup(dev, 10 + seed, N, L, W)
                        for seed, (N, L, W) in
                        enumerate(((1024, 2048, 64), (1024, 3072, 64), (1024, 3072, 128)))]
    for key in ("sw", "pileup"):
        for r in report[key]:
            print(f"parity {key} L={r['L']} W={r['W']}: exact; kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
                  f"{r['fn_ops_per_cell']} ops a cell); design floor {r['design_bound_ms']:.3f} ms "
                  f"({r['design_ops_per_cell']} ops, {r['design_shuffles_per_cell']:.2f} "
                  f"shuffles a cell)", flush=True)
    split = report["polish_split"] = polish_split(dev, 20)
    print(f"polish round (C={split['C']} S={split['S']} L={split['L']} W={split['W']}): "
          f"B2 forward {split['forward_ms']:.1f} ms, traceback {split['traceback_ms']:.1f} ms, "
          f"vote {split['vote_ms']:.1f} ms; whole round {split['round_ms']:.1f} ms, device "
          f"{split['device_ms']:.1f} ms over {split['device_events']} traced events, busy share "
          f"{split['busy_share']}", flush=True)

    # 4. the polisher, cuda vs cpu
    pol = report["polisher"] = polisher_parity(20)
    print(f"polisher (C={pol['C']} S={pol['S']} L={pol['L']} W={pol['W']}, {pol['weights']}, "
          f"{pol['pileup']} pileup): max |logit cuda - cpu| {pol['max_abs_logit_diff']:.3g}, "
          f"features {pol['max_abs_feature_diff']:.3g}; {pol['decision_flips']} gated decisions "
          f"differ ({pol['class_calls_changing_the_draft']} class calls change the draft, "
          f"{pol['insertion_calls']} insertions); on the card features {pol['features_ms']:.3f} "
          f"ms, network {pol['network_ms']:.3f} ms (float32 bound {pol['network_bound_ms']:.3f} "
          f"ms)", flush=True)
    if pol["decision_flips"]:
        _dump(args.out, report)
        return _fail(f"polisher decisions differ between cuda and cpu: {pol['flips']}")

    # 5. the QC error profile's device path against numpy
    ep = report["error_profile"] = error_profile_phase()
    print(f"error profile ({ep['n_reads']} reads of {ep['read_len'][0]}-{ep['read_len'][1]} nt): "
          f"every cs string equal on the card and in numpy; device path "
          + ", ".join(f"{t:.2f}" for t in ep["device_s"])
          + f" s ({ep['device_events']} device events, busy {ep['device_busy_ms']:.1f} ms), "
          f"numpy {ep['numpy_s']:.2f} s", flush=True)

    # 6. small e2e, cuda vs cpu, under both polish methods
    report["small_e2e"] = [small_e2e(method) for method in POLISH]
    for small in report["small_e2e"]:
        print(f"small e2e ({small['polish']}): {small['files_compared']} files identical on "
              f"cuda and cpu, stage names equal, counts exact (cuda {small['cuda_s']:.1f} s, "
              f"cpu {small['cpu_s']:.1f} s)", flush=True)

    # 7. full-size e2e (the main path under the default config, then in
    # turns without the QC profiles, with them serial and overlapped, then
    # the poa path)
    kernels = (sw_kernel.align_banded_cuda, pileup_kernel.forward_planes_cuda)
    full = report["full_e2e"] = full_e2e(kernels, max(args.lane_runs, 1))
    print(f"full e2e: {full['n_reads']} reads in " + ", ".join(
          f"{s:.2f} s ({r:.1f} reads/s, {m})"
          for s, r, m in zip(full["seconds"], full["reads_per_s"], full["polish"]))
          + f"; counts_exact={full['counts_exact']}, max memory "
          + ", ".join(f"{gb:.2f}" for gb in full["max_memory_allocated_gb"])
          + f" GB, launches {full['launches']}", flush=True)
    for run, stage_s in enumerate(full["stage_s"]):
        qc = "; ".join(
            f"{r} error profile: worker {stage_s[f'{r}_error_profile_bg']:.2f} s, commit wait "
            f"{stage_s[f'{r}_error_profile']:.3f} s" for r in ("round1", "round2")
            if f"{r}_error_profile_bg" in stage_s)
        print(f"full e2e run {run} ({full['polish'][run]}): {full['reads_per_s'][run]:.1f} "
              f"reads/s; stages (s): "
              + ", ".join(f"{k} {v:.2f}" for k, v in stage_s.items())
              + f"; polisher {full['polisher'][run]['s']:.2f} (peak inside it: "
              f"{full['polisher'][run]['peak_gb']} GB)" + (f"; {qc}" if qc else ""), flush=True)
    for key, gaps in full["launch_gaps"].items():
        print(f"full e2e run 0 {key} launches by (batch, L, Lr, W): " + ", ".join(
              f"{tuple(r['shape'])} x{r['launches']} {r['ms']:.3f} ms (bound {r['bound_ms']:.3f})"
              for r in gaps["shapes"]), flush=True)
        print(f"full e2e run 0 {key}: kernel {gaps['kernel_ms']:.1f} ms in all, launches x "
              f"(time - bound) {gaps['launches_x_gap_ms']:.1f} ms", flush=True)
    _dump(args.out, report)
    if not full["counts_exact"]:
        return _fail(f"full e2e counts differ from the truth: {full.get('count_diffs')}")
    if not all(n for path in full["launches"].values() for n in path.values()):
        return _fail(f"a kernel of a path never launched: {full['launches']}")

    # 8. kernels line
    entries = []
    for k, key, name, src, replaces in (
        (sw_kernel.align_banded_cuda, "sw", "sw_banded",
         "ont_tcrconsensus_tpu_torch/csrc/sw_banded.cu", "ont_tcrconsensus_tpu/ops/sw_pallas.py:56"),
        (pileup_kernel.forward_planes_cuda, "pileup", "pileup_forward",
         "ont_tcrconsensus_tpu_torch/csrc/pileup_forward.cu",
         "ont_tcrconsensus_tpu/ops/pileup_pallas.py:61"),
    ):
        r = report[key][1]  # L=3072: the read passes' band 128, the polish band 64
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": full["launches"]["rnn"][k.__name__],
            "max_abs_err": max(x["max_abs_err"] for x in report[key]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    shutil.rmtree(WORK, ignore_errors=True)
    return 0


def _dump(path, report) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)


if __name__ == "__main__":
    sys.exit(main())
