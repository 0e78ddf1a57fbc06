#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, kernels held to their
plain versions.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and imports nothing of the JAX package. Phases, each
of which fails the script (non-zero exit, no result line):

1. device: the card's name and ``nvidia-smi`` name/power-limit line; the
   host's ingest parser, printed as ``{"parser": "native"|"python",
   "native_build_s": ..., "build_error": ...}``: the native C++ parser
   (``ont_tcrconsensus_tpu_torch/io/native``, built now with g++ and zlib
   into ``build/torch_native/``) must load where g++ and
   ``/usr/include/zlib.h`` are there; where either is missing a line
   names which, and every ingest runs the Python parsers, as in the JAX
   package. Phase 8's first run, phase 10's quarantine run and phase 12's
   in-process jobs must ingest through that parser alone (their read
   batches are counted by path);
2. build: the six kernels (``ont_tcrconsensus_tpu_torch/csrc/*.cu``), one
   ``nvcc`` each, started together; ptxas's registers and spills and each
   instantiation's SASS instruction mix (``cuobjdump``) are printed;
3. kernel parity: kernel B1 (banded SW stats) at B=2048, W=128 and kernel
   B2 (pileup forward planes) at N=1024, W=64, each at L=2048 and L=3072
   (the width buckets of 1.4-2.3 kb reads), plus B1 at the self-homology
   band 512 and B2 at the 3072 bucket's band 128, against the plain
   PyTorch version on the same card tensors: every output exactly equal.
   Times are CUDA-event medians of 7 calls after 2 warm-ups, each call
   enqueued behind a ~1 ms spin of the card so that the events bracket
   the device's work and not the host's enqueue (``_time_ms``, every
   kernel alike), and beside it the median of 7 calls as their caller
   meets them (``call_ms``, no spin); the bound is
   the larger of bytes over the HBM rate and the int32 operations the
   function needs over the int32 issue rate (``_bound_ms``); the design's
   own floor (its second F pass, band-shift moves, carry scan and warp
   shuffles) is reported beside it. The plain versions' times are one
   call each, the call whose outputs the kernel is held to. Kernel B3
   (the polish traceback) on B2's planes of the same batches at N=1024,
   L=2048 and 3072 at W=64, and L=3072 at W=128 (out_len L), against the
   plain ``_traceback_steps`` on the same card tensors: every column and
   the spans exactly equal; its bound (a 32-byte sector a step of every
   walk, the columns written once) and beside it the design's floor: the
   larger of the bytes it stages (the walked lanes' chunks of whole rows)
   over the HBM rate and the longest walk's steps times one staged step of
   a lone lane through cold planes, measured first. B3 also on seeded
   random direction fields (``dp_cases.random_planes``, N=128, L=2048) at
   W=64 and 128 with out_len L and 3L/4: every output equal to the plain
   steps'. Then one polish round at a main-path
   tile, split into the B2 forward, the B3 traceback and the vote, beside
   one call of the plain traceback's host loop, and traced once with
   ``torch.profiler`` for the card's busy share; at that tile, two vote
   rounds fused (``ops/consensus._pair_program``: both rounds, their end
   extensions and flags on the card, one readback) beside two unfused
   rounds (a readback and the host extension each), host clock, median
   of 3, their drafts equal. Kernel B5 (the fuzzy match) at the lane's two
   call shapes, the primer trim (P=8 patterns of m=47 over B=2048 windows
   of 150) and the UMI windows (P=2, m=32, B=2048, Lw=81), and kernel B6
   (the UMI dovetail distance) on 8192 pairs of width 128 (lengths 58-68)
   at k_end 8 and 16 and on the 256 x 256 full matrix at k_end 8, all on
   seeded cases (``dp_cases.fuzzy_case``, ``dovetail_case``: planted
   instances with edits, IUPAC codes, empty and short windows, ties on the
   end and the start; empty sequences, a_len > b_len), against the plain
   versions on the same card tensors: every output exactly equal; times,
   plain times, the bound (the bit-parallel word steps these inputs need,
   ``BITVECTOR_STEP_OPS``, against the bytes of each sequence within its
   length) and beside it the cell bound of the DP's cells; ptxas's
   registers and spills, and the warps an SM holds (the launch's one-warp
   blocks over the SMs). Both kernels
   also past one word at small batches: at the word edges
   (``dp_cases.WORD_EDGES``), at ``FUZZY_MULTIWORD`` and
   ``DOVETAIL_MULTIWORD``, and at each launcher's limit (m = 1787, La =
   1452), exact;
3b. band centres and global distance: kernels B2 and B3 with every lane
   off the diagonal (``dp_cases.dp_batch``'s band centres, each 0 drawn
   anew from +-[1, W]: ``dp_cases.nonzero_offsets``) at the polish tile's
   first shape (N=1024, L=2048, W=64) and at W=128 (N=256, L=384),
   against the plain forward and steps at the same offsets on the same
   card tensors: every output equal; their times, plain times and bounds
   as in phase 3. ``ops/pileup.pileup_columns`` at the band centres
   {-40, -7, 0, 5, 37} (``dp_cases.band_centre_cluster``) at W=64 and 128
   on ``cuda`` against ``cpu``: every output equal, one B2 and one B3
   launch a call, each counted as given band centres. The global edit distance (``ops/edit_distance.pairwise``,
   ``many_vs_many``, ``identity_matrix``: B6 at k_end 0) on 8192 pairs and
   the 256 x 256 matrix against the plain version at k_end 0 on the same
   card tensors, and the identity against the CPU's (a 32 x 64 block):
   equal, one B6 launch a call, counted as at k_end 0; times, plain times and bounds as B6's in
   phase 3;
4. polisher parity: at the same tile, the vote rounds' kept final pileup
   (recomputed against the final drafts if the rounds ran out), then the
   features and the served (v3) bi-GRU on ``cuda`` and on ``cpu``: the
   largest logit difference, and the positions whose gated decisions
   (0.9 confidence, depth gate) differ, which must be none; the card's
   times (CUDA-event medians of 7) of the features and the network;
5. error profile, kernel B4: 512 simulated reads of 1.4-2.3 kb (the
   systematic ONT error model, seed 5) against their reference spans
   through the device path (``banded_cs_batch_device`` on ``cuda``, B4
   inside): every cs string equal to the numpy fill's. Its tile, recorded
   from that call: kernel B4 (the QC error profile's fill and walk)
   against the plain ``_device_cs_core`` on the same card tensors, every
   op log equal up to its walk's stop. B4's time (CUDA-event median of
   7), the plain version's one call, the bound (the tile's band cells and
   walk steps over the int32 rate; its bytes) and the design's floor (the
   tile's slowest read alone, L2 flushed first, with its walk's steps
   times phase 3's staged step beside it), the bytes the design stages,
   and ptxas's registers, spills and shared memory. B4 also on the tests'
   tiles and crafted band starts (``dp_cases.cs_tiles`` at w_pad 128 and
   320, ``dp_cases.cs_crafted``): every op log equal to the plain core's.
   Then the device path twice more (host clock), each equal to numpy's,
   and once traced by ``torch.profiler`` for its device events and busy
   time;
6. small e2e: the tests' 4-region lane under ``rnn`` (the default) and
   under ``poa``, each on ``cuda`` and on ``cpu`` (plain versions; each
   CPU run in a process of its own, started first, beside the card's
   runs, whose seconds it shares the host with), both
   through the default graph executor: every file under ``nano_tcr/``
   byte-identical (the QC logs and CSVs, both error profiles, the
   reports), but the files of timings (:data:`TIMED_FILES`): the stage
   table's names must agree, and ``telemetry.json`` and ``history.jsonl``
   must have equal key sets (only the card has the keys of
   :data:`CARD_ONLY`: the memory gauge and the graph nodes' memory
   samples), equal stage names and dispatch sites with equal dispatch and
   get counts, and the same config fingerprint; under ``rnn`` a third run
   on ``cuda`` under ``executor: "imperative"`` must write the graph run's
   files byte for byte (but the files of timings); counts equal to the
   simulator's truth;
7. observation on the card: the small lane under ``rnn`` with
   ``telemetry: "full"``, ``profile_trace_dir``, ``live_port: 0`` and a
   generous ``stage_timeout_s``: ``/healthz``, ``/metrics`` and
   ``/progress`` answer while it runs (polled from a thread), and
   ``/progress`` names the graph node the run is in;
   ``logs/trace.json`` holds a span for every stage of the stage table,
   on the main thread's row or, for the QC worker's ``*_bg`` stages, on a
   worker's row; the ``torch.profiler`` trace names the six kernels (its
   size and event count are printed); ``python -m
   ont_tcrconsensus_tpu_torch --report`` exits 0 in a subprocess that
   never loads torch; ``robustness_report.json`` holds no watchdog event;
   counts equal the truth;
8. full-size e2e: the representative lane (about 11k untrimmed reads of
   1.4-2.3 kb, 56 regions + 6 near-duplicate pairs + 2 negative controls,
   the systematic ONT error model, read batch 1024, band 128, seed 33) on
   ``cuda``, unobserved, under the default config (the graph executor,
   ``rnn`` polish, the error profiles of 512 reads a round on the
   overlapped QC worker, ``telemetry: "on"``); then, on the small lane of
   phase 6 (a polish round's host loop costs a lane of any depth about the
   same, so only the small lane keeps the script inside its time limit),
   ``--lane-runs`` rounds (1 by default) of the default config in turns with
   ``error_profile_sample: 0`` (no QC profile, launches counted: B4 0), with
   ``overlap_qc: false``
   (the profiles on the main thread), with ``executor: "imperative"``
   (which must not run the graph), as it is and with ``telemetry:
   "off"``, then once under ``poa``. Each default run must have run the
   graph executor; its
   nodes, graftcheck's verdict and static memory high-water, the donation
   verdicts and each node's static memory estimate beside its measured
   boundary sample (``--report --memory``'s reconciliation, its
   divergences named) are printed. For each default run its
   ``telemetry.json`` gives every
   dispatch site's host and blocked seconds, the kernel builds (0 on a
   warm build) and the device memory high-water mark, which must agree
   with ``torch.cuda.max_memory_allocated`` within 1%, and the run's
   telemetry roll-up (telemetry.json and the history entry) is timed; the
   default runs' reads/s after the first are printed against the ``off``
   runs', with the ratio of each adjacent on/off pair, and each round's
   imperative run against the graph run after it: reads/s, their ratio
   and each stage's seconds side by side. The telemetry's
   cost is also bounded directly: each plant (a dispatch scope, a
   readback through ``timed_get``, a stage span, a counter, a histogram
   sample) is timed armed against disarmed on the card's host, and its
   added seconds, times its calls in the first run, plus the roll-up,
   are set against that run's seconds. Kernel launch counts are zeroed
   just before the first run (the main path's) and read just after it,
   and again around the ``poa`` run; each kernel must have launched in
   both, B3 as often as B2 (each forward is followed by its traceback),
   and every run's counts must equal the truth; B4 launches on the QC
   profiles' runs and not without them; B5 and B6 on every run counted;
   the first run's B6 launches at k_end 0 and its B2 and B3 launches given
   band centres, counted where the kernels launch, must be 0. Each run's stage
   seconds are printed under
   the stage table's names, the error profiles' worker seconds
   (``*_bg``) beside the main thread's wait at their commit. The first
   run also records each launch's (batch, L, Lr, W) (B4's (L, N, M,
   w_pad)), with a host copy of
   each shape's first inputs (off the card, so the run's peak memory is
   the lane's own; the copies are in that run's wall time); after the
   runs each shape's kernel is timed on those inputs, for the launches x
   (time - bound) the run spent at its real shapes; each of B4's tiles is
   first held to the plain ``_device_cs_core`` on its own inputs (every op
   log up to its stop; the plain core's one call timed). Peak device memory
   and the polisher's seconds (host clock to its stream synchronized) are
   read per run, and the peak reached inside a polisher call when that
   call raised it. The host/device overlaps: after every run no thread of
   :data:`OVERLAP_THREADS` (assign's prefetch worker and readback thread,
   polish's pack worker) may be alive; for the first run, the
   ``consensus.get`` readbacks (one a pair of vote rounds), the
   ``assign.dispatch`` and ``polish.dispatch`` host and blocked seconds
   and the ``round1_fused_assign``, ``round2_fused_assign`` and
   ``round1_polish`` seconds are printed on one line, beside the card's
   busy share in the ``round1_fused_assign`` window of one more run of
   the full lane (in a directory of its own, that window traced by
   ``torch.profiler``, counts equal to the truth); and one line of what
   kernels B5 and B6 serve: their launches, the ``assign.dispatch`` and
   ``cluster.batched_dispatch`` host seconds, the ``round1_fused_assign``
   and ``round1_umi_cluster`` seconds and that window's device events and
   busy share;
9. robustness on the card: the small lane under ``poa`` (no retry
   back-off), one chaos drill a run: a transient fault
   at ``assign.dispatch`` and ``polish.dispatch`` (retried), an out of
   memory error at ``polish.dispatch`` (the chunk batch shrinks), a
   killed ``overlap.worker`` (recomputed on the main thread), a transient
   fault at ``graph.node`` (outside every retry, as in the JAX package:
   the library fails, and ``resume: true`` completes it from the round-1
   checkpoint), a ``truncate-file`` library beside a good one (the good
   one is counted, ``failed_libraries_p0.log`` is written and the run
   raises), and, in a process of its own through the CLI, a ``preempt``
   (exit 143) and a ``kill`` (exit 137) at ``run.round1_checkpoint``, each
   completed by ``resume: true``, then a ``corrupt-artifact`` caught by
   ``verify_resume: "full"`` (a ``resume.verify`` rerun), and last a
   ``corrupt-input`` under ``on_bad_record: "drop"`` (``dropped`` events,
   no quarantine file). Each drill must
   end with the truth's counts and the counts CSV and merged FASTA of
   phase 6's undisturbed run under ``poa`` on ``cuda``; its ``robustness_report.json`` events (site,
   classification, outcome) and the phase's seconds are printed;
10. ingest validation on the card: phase 8's full lane again under
   ``on_bad_record: "quarantine"``, ``contracts: "strict"`` and the
   ``corrupt-input`` drill (three malformed blocks spliced between
   records), launches counted from zero: the truth's counts, every file
   under ``nano_tcr/`` byte-identical to phase 8's first run but the files
   of timings and :data:`INGEST_DIFFERS`, B1, B2, B3 and B4 launched as often as
   there, at least three ``quarantined`` events with canonical reasons and
   one ``summary``, no contract violated, and ``quarantine.fastq.gz``
   holding exactly the spliced blocks (cut from the corrupted copy at the
   events' offsets, they leave the lane's file); its seconds and reads/s
   beside phase 8's, and, on the host, the drill's gzip rewrite of the
   corrupted lane, the tolerant parse of it and the strict parse of the
   clean lane, one call each. Then ``--validate`` in processes that must not load
   torch: exit 0 naming the lane's records on its config, exit 1 naming
   the malformed records with the first one's offset and reason on a copy
   whose discovered input is the corrupted file. Then the analysis verb
   (``python -m ont_tcrconsensus_tpu_torch.qc.analysis_cli``) on phase 8's
   first run, its summaries and ``outs/`` files printed, or, where
   matplotlib does not import, a line saying it was not run and why;
11. the data mesh (``parallel/mesh.py``, ``parallel/distributed.py``):
   phase 6's small lane under the default config plus ``mesh_shape:
   {"data": torch.cuda.device_count()}`` (data=1 on a one-card host,
   every card on a larger one; the full lane's second run is phase 12's
   served job, which keeps the script inside its time limit), launches
   counted from zero and by slice: the truth's counts, every file under
   ``nano_tcr/`` byte-identical to phase 6's cuda run but the files of
   timings (and, at data > 1, :data:`MESH_DIFFERS`), every kernel
   launched, each but B4 (no QC profile is sharded) on every slice, B3 as
   often as B2, ``mesh_slice_busy`` for
   every slice and ``mesh_config`` in ``history.jsonl``; its seconds and
   reads/s beside phase 6's. Then B1 at
   B=2048, L=2048, W=128, B2 at N=1024, L=2048, W=64, B3 on those
   planes and B6 on 8192 pairs at k_end 8 split over a
   ``data=2`` mesh of two slices of ONE card (``cuda:0`` twice), each bit
   for bit the unsplit launch, both timed (CUDA-event medians of 5). Then
   the small lane under ``poa`` without the QC error profiles at
   ``data=2`` over those two slices of the card (``install_slice_devices``):
   undisturbed (every file the
   unsharded run's but :data:`MESH_DIFFERS`), ``mesh.device_lost`` (one
   ``mesh.degraded`` event at ``round1_polish``, data 2 to 1, the lost
   slice gauged 0), ``mesh.slice_oom`` (``oom_shrink``, no degradation)
   and a transient ``mesh.dispatch`` (``retried``), each ending with the
   unsharded run's counts CSV and merged FASTA. Last, two CLI processes
   with ``TCR_CONSENSUS_DISTRIBUTED=1`` (one gloo group over localhost,
   both on ``cuda:0``) on a two-library copy of the small lane under
   ``distributed: true``: both exit 0, each owns one library, each
   library's files equal one process's run of both, and the per-process
   files (``robustness_report_p<i>.json``, ...) are there; each process's
   seconds are printed;
12. the warm-serving daemon (``serve/``): a ``Daemon`` in this process on
   a thread, on ``cuda``, phase 8's full-lane config (the default config)
   as its template, prewarm on: the prewarm report (each warm-up launch's
   bucket, seconds and B1-B6 launches; the kernel build/load seconds) and
   ``warmup_s``. Then phase 8's full lane as job 1 over real HTTP
   (``POST /jobs``), launches counted from zero: done with the truth's
   counts, every file under ``nano_tcr/`` byte-identical to phase 8's run
   0 but the files of timings, which must match by schema and names
   (telemetry keys, stage names, manifest stages, the run entry of
   ``history.jsonl``), B1, B2, B3 and B4 launched as often as there, 0 kernel
   builds in its ``telemetry.json``; its seconds and reads/s beside run
   0's (B5 and B6 among them), its ``wait_s`` and ``dispatch_first_stage_s``, and its peak
   memory beside the admission estimate's byte figures; its ``source:
   "serve"`` ledger entry carries the daemon's ``warmup_s``
   (``tests/test_torch_serve.py`` holds a later entry without it). Drills
   on the small
   lane under ``poa`` without the QC profiles: a transient
   ``serve.job_run`` retried to done, a fatal one poisoned in
   ``serve_poison.json``, a ``serve.daemon_loop`` crash journaling the
   popped job and flushing ``serve_crash:RuntimeError``, and a ``python -m
   ont_tcrconsensus_tpu_torch serve ... --port 0`` process sent SIGTERM
   mid-job: exit 143, the job journaled with ``resume: true``, completed
   by a restarted daemon to phase 9's drills' counts CSV and merged
   FASTA (its cold start to ``serve_info.json`` and ``warmup_s`` printed).
   Last a packed pair (``serve_workers: 2`` over ``devices=["cuda:0",
   "cuda:0"]``) of two tenants of the drills' knobs: resident at once on
   disjoint slices, each writing the transient drill's served job's files,
   their seconds beside that job's.

13. polisher training and the bf16 gate (``models/train.py``,
   ``models/polisher.py``): ``make_examples`` of 16 examples at the
   training CLI's template length (1,600 nt, width 2048, band 64) on
   ``cuda``, launches counted from zero (B2 at least once), and on
   ``cpu`` (in a process of its own, as are the CPU sides below and the
   training CLI, so they run beside the card's work): labels, insertion
   labels and loss weights equal, features within 1e-6. The bf16
   exactness A/B at JAX's defaults (96 clusters, template 1,300) into a
   temporary artifact: its ``identical`` and ``mismatched_clusters``, and
   the gate read against that artifact, which must agree with
   ``identical`` (a mismatch is a result, a bf16 network that does not
   run a failure). On one batch of 8 from the served (v3) weights, the loss
   (within 1e-5 relative) and every gradient leaf (within 1e-3 of its
   largest magnitude) on ``cuda`` against ``cpu``. 50 Adam steps on the
   card at batch 8 from ``init_params(0)``: each step's CUDA-event ms
   (median printed), the loss must fall, and the r and z hidden biases
   stay exactly zero; the weights are written to a temporary file, read
   back and served by ``evaluate_consensus_gain`` (16 clusters at depth
   4) on ``cuda`` and ``cpu``, which must agree. A 5-step ``train`` loss
   trace from the same start on ``cuda`` and ``cpu`` (within 1e-3
   relative). At phase 4's tile, the largest bf16 logit difference from
   float32, both networks' CUDA-event ms (median of 7) and the GRU
   kernels ``torch.profiler`` names for each. ``python -m
   ont_tcrconsensus_tpu_torch.models.train --steps 2 --pool-examples 4
   --eval-clusters 4 --out <tmp>`` must exit 0 on ``cuda``; it shares the
   card, so it starts after the timed parts (the train steps, the networks
   at the tile), beside the rest. ``models/weights/`` must keep every file's
   sha256. The phase's B2 launches (the CLI's excepted), B3's, which
   must equal them, and B4's (counted from zero; no step computes a QC
   profile) join the kernels line.

14. the native ingest and the serve load harness on the card: on phase
   8's full lane, the native ``parse_file``, the concatenated
   ``parse_chunks`` (at the default and at 1M bases a chunk) and the
   Python ``read_fastx`` give the same records, and ``batch_parsed_chunks``
   gives ``batch_reads``' batches one for one; on phase 10's corrupted
   copy the native tolerant parse, whole and chunked, gives the Python
   twin's records and bad regions (offset, reason, bytes); each parse's
   host seconds. Then ``scripts/torch_serve_load.py`` in this process on
   ``cuda``: ``smoke`` (the exact ledger, the saturation burst's 429s
   equal to burst - ``queue_max``), ``packed`` on two slices of
   ``cuda:0`` (resident high-water >= 2, disjoint leases) and
   ``sustained`` (its default dataset: 3 regions of 2 molecules of 5-6
   reads, ``poa``; 2 tenants, ``--ledger`` into a temporary file):
   counts exact, B1, B2, B3 and B4 launched (counted from zero, the prewarm's
   included; in every scenario B3 as often as B2), 0 steady kernel builds; its reads/s, wait and first-stage
   p50/p99 and ``cold_start_s``. Last ``scripts/torch_perf_gate.py`` on
   that ledger in a process where torch cannot be imported: exit 0,
   ``warn`` on one entry. The phase's launches join the kernels line.

15. the lane-scale path: ``scripts/torch_lane_scale_proof.py`` on
   ``cuda`` in a process of its own at 3,000 reads (the JAX package's
   medium tier) with 600 unique molecules at depth 3 in its heavy region (past the
   UMI shortlist's threshold of 256) and ``min_reads_per_cluster: 2``,
   held to the medium tier's assertions (``tests/test_lane_scale.py``):
   the heavy region at least 0.96 of the truth and never over it, every
   other region exact, B1, B2, B3, B5 and B6 launched, B3 as often as B2,
   and B4 not at all (the twin runs without a QC profile); its reads/s, stage
   seconds, peak device memory and launches are printed. The tier's
   "every other region exact" is a property of its size: at 10,000 reads
   the JAX package's own run loses a depth-4 molecule too.

Each phase's start (seconds since the script began) is printed. Then one
``{"kernels": [...]}`` line (B1-B6), the ``nvidia-smi`` line, and last
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
import signal
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
        fn = re.search(r"Function : \S*?([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E", line)
        if fn:  # template arguments: ints and bools
            args = ",".join(re.findall(r"L[ib](\d+)E", fn.group(2)))
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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _busy(prof)


def _busy(prof) -> dict:
    """A finished ``torch.profiler`` run's device milliseconds (the CUDA
    events' intervals merged) and its number of device events."""
    from torch.autograd import DeviceType

    # the profiler's raw records: ``prof.events()`` builds a Python event
    # tree from them, tens of seconds at the 10^5 events of a traced call,
    # for the same device intervals (it drops the hidden records too)
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not getattr(e, "is_hidden_event", lambda: False)())
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"device_ms": busy_us / 1e3, "events": len(spans)}


def _timed_once(fn):
    """``fn()``'s result and its CUDA-event time in ms, one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _time_ms(fn, reps: int, spin: bool = True) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` calls (the caller
    has warmed it up). Each call is enqueued behind a ~1 ms spin of the
    card (``torch.cuda._sleep``), so the events bracket the device's work
    and not the host's enqueue of it; ``spin=False`` times the call as its
    caller meets it, the host's enqueue included where the kernel is
    shorter than it."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(2_000_000)
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
    # the plain version's one call: its parity result and its time
    want, plain_ms = _timed_once(lambda: sw_align.align_banded(*args, band_width=W))
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
    call_ms = _time_ms(lambda: sw_kernel.align_banded_cuda(*args, band_width=W), 7, spin=False)
    return {"L": L, "B": B, "W": W, "max_abs_err": max_err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
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
    (best_p, planes_p), plain_ms = _timed_once(
        lambda: pileup._forward_batch(*args, band_width=W))
    for name, a, b in (("best", best_k, best_p), ("planes", planes_k, planes_p)):
        if not torch.equal(a, b):
            bad = (a != b).reshape(N, -1).any(dim=1).nonzero()[0, 0]
            raise AssertionError(f"B2 L={L}: {name} differs (first lane {int(bad)})")
    max_err = max(int((best_k.long() - best_p.long()).abs().max()),
                  int((planes_k.int() - planes_p.int()).abs().max()))
    for _ in range(2):
        pileup_kernel.forward_planes_cuda(*args, band_width=W)
    ms = _time_ms(lambda: pileup_kernel.forward_planes_cuda(*args, band_width=W), 7)
    call_ms = _time_ms(lambda: pileup_kernel.forward_planes_cuda(*args, band_width=W), 7,
                       spin=False)
    return {"L": L, "N": N, "W": W, "max_abs_err": max_err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            **_pileup_costs(rl, refs.shape[1], L, W),
            "aligned_lanes": int((best_k[:, 0] > 0).sum())}


def _pileup_costs(rl, Lr: int, L: int, W: int, extra_bytes: int = 0) -> dict:
    """B2's bound and design floor for read lengths ``rl``: every row's
    planes are output, each cell written once; the rows of a read and the
    one after its end need the DP, the rows after that only the bases.
    ``extra_bytes``: further inputs read once (the band centres)."""
    import torch

    N = rl.shape[0]
    dp_rows = int(torch.clamp(rl.long() + 1, min=0, max=L).sum())
    n_bytes = N * L + N * Lr + 2 * 4 * N + 3 * 4 * N + 2 * N * L * W + extra_bytes
    return _costs(dp_rows * W, n_bytes, W, PILEUP_CELL_OPS, PILEUP_DESIGN,
                  pad_cells=(N * L - dp_rows) * W)


# int32 operations of one traceback step, counted from the plain version's
# step (ops/pileup._traceback_steps); the gather and the column writes are
# the bytes
TRACEBACK_STEP_OPS = {
    "column, clamps, cell index": 8,
    "plane fields, deletion run, choice": 10,
    "diagonal, insertion, fresh, drop test": 8,
    "next row, slot, mode": 8,
    "spans, stop test, state": 10,
}
SECTOR_BYTES = 32  # the least a load moves from device memory
TB_CHUNK_ROWS = 32  # csrc/pileup_traceback.cu kRows: plane rows a staged chunk


def staged_step_ns(dev, L: int = 3072, W: int = 64, reps: int = 5) -> float:
    """One step of a lone lane's walk in kernel B3, in ns: one lane whose
    planes are all plain diagonal cells, walked from row L - 1 to row 0 (L
    steps, each a new row; the rows come through the kernel's staged
    chunks, the first one cold). The L2 cache (50 MB) is overwritten before
    each of ``reps`` CUDA-event timed launches; the median over L is the
    time a walk pays a step when nothing else runs, the unit of the
    design's walk floor."""
    import torch

    from ont_tcrconsensus_tpu_torch.ops import traceback_kernel

    best = torch.tensor([[1, L - 1, W // 2]], dtype=torch.int32, device=dev)
    planes = torch.zeros((1, L, W), dtype=torch.int16, device=dev)
    reads = torch.zeros((1, L), dtype=torch.uint8, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    traceback_kernel.traceback_columns_cuda(best, planes, reads, W, L)
    times = []
    for _ in range(reps):
        flush.fill_(1)
        times.append(_time_ms(
            lambda: traceback_kernel.traceback_columns_cuda(best, planes, reads, W, L), 1))
    return float(np.median(times)) * 1e6 / L


def _traceback_parity(label: str, args, N: int):
    """Kernel B3 against the plain ``_traceback_steps`` on the same card
    tensors (best, planes, reads, W, out_len): every output equal. Returns
    the plain columns and the plain call's CUDA-event ms."""
    from ont_tcrconsensus_tpu_torch.ops import pileup, traceback_kernel
    from ont_tcrconsensus_tpu_torch.parallel.mesh import lockstep

    import torch

    got = traceback_kernel.traceback_columns_cuda(*args)
    want, plain_ms = _timed_once(lambda: lockstep([pileup._traceback_steps(*args)])[0])
    for name, a, b in zip(("base_at", "ins_cnt", "ins_base", "pos_at", "spans"), got, want):
        if not torch.equal(a, b):
            bad = (a != b).reshape(N, -1).any(dim=1).nonzero()[0, 0]
            raise AssertionError(f"B3 {label}: {name} differs (first lane {int(bad)})")
    return want, plain_ms


def check_traceback(dev, seed: int, N: int, L: int, W: int, step_ns: float) -> dict:
    """Kernel B3 on B2's planes of a ``dp_batch`` (out_len = L) against the
    plain ``_traceback_steps`` on the same card tensors: every output equal."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import pileup_kernel, traceback_kernel

    reads, rl, refs, tl, _ = (torch.from_numpy(x).to(dev)
                              for x in dp_cases.dp_batch(N, L, W, seed, offsets=False))
    best, planes = pileup_kernel.forward_planes_cuda(reads, rl, refs, tl, band_width=W)
    args = (best, planes, reads, W, L)
    want, plain_ms = _traceback_parity(f"L={L} W={W}", args, N)
    for _ in range(2):
        traceback_kernel.traceback_columns_cuda(*args)
    ms = _time_ms(lambda: traceback_kernel.traceback_columns_cuda(*args), 7)
    call_ms = _time_ms(lambda: traceback_kernel.traceback_columns_cuda(*args), 7, spin=False)
    return {"L": L, "N": N, "W": W, "max_abs_err": 0, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            **_traceback_costs(best, want[4], N, L, W, L, step_ns),
            "aligned_lanes": int((best[:, 0] > 0).sum())}


def check_traceback_random(dev, seed: int, N: int, L: int, W: int) -> list[dict]:
    """Kernel B3 on a seeded random direction field (``dp_cases.
    random_planes``: long walks over many chunks, deletion runs up to 40,
    walks at slot 0 and W - 1, N bases, dead lanes) with out_len L and 3L/4,
    against the plain steps on the same card tensors: every output equal."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases

    best, planes, reads = (torch.from_numpy(x).to(dev)
                           for x in dp_cases.random_planes(seed, N, L, W))
    rows = []
    for out_len in (L, 3 * L // 4):
        want, _ = _traceback_parity(f"random planes L={L} W={W} out_len={out_len}",
                                    (best, planes, reads, W, out_len), N)
        s = want[4].long()
        rows.append({"N": N, "L": L, "W": W, "out_len": out_len, "equal": True,
                     "longest_walk": int(torch.maximum(s[:, 1] - s[:, 0], s[:, 3] - s[:, 2])
                                         .clamp(min=0).max()),
                     "insertion_columns": int((want[1] > 0).sum()),
                     "deletion_columns": int((want[0] == 4).sum())})
    return rows


def _traceback_costs(best, spans, N: int, L: int, W: int, out_len: int, step_ns: float,
                     extra_bytes: int = 0) -> dict:
    """B3's bound and floor from the walks' spans: a lane takes at least
    max(read span, draft span) steps (each step consumes a read base, a
    draft column or both). Bytes: a 32-byte sector a step, the columns
    written once, best and spans. The design's floor: the larger of the
    bytes it stages (each walked lane's chunks of TB_CHUNK_ROWS whole rows,
    from its first row's chunk to one past its last row's, and the chunks'
    read bases) over the HBM rate and the longest walk's steps at
    ``step_ns`` each. ``extra_bytes``: further inputs read once (the band
    centres)."""
    import torch

    s = spans.long()
    steps = torch.maximum(s[:, 1] - s[:, 0], s[:, 3] - s[:, 2]).clamp(min=0)
    total = int(steps.sum())
    n_bytes = (SECTOR_BYTES * total + N * out_len * (1 + 4 + 1 + 4) + N * 4 * 4 + N * 3 * 4
               + extra_bytes)
    bound, by = _bound_ms(n_bytes, total * sum(TRACEBACK_STEP_OPS.values()))
    live = (best[:, 0] > 0) & (best[:, 1] >= 0)
    top = best[:, 1].long().clamp(max=L - 1)
    rows_walked = (top - s[:, 0] + 2).clamp(min=1)  # the last row's chunk and its lookahead
    chunks = (rows_walked + TB_CHUNK_ROWS - 1) // TB_CHUNK_ROWS + 1
    staged_rows = torch.minimum(chunks * TB_CHUNK_ROWS, top + 1)
    staged = int(torch.where(live, staged_rows * (W * 2 + 1), 0).sum())
    longest = int(steps.max()) if N else 0
    walk_ms = longest * step_ns * 1e-6
    staged_ms = staged / HBM_BYTES_PER_S * 1e3
    return {"steps": total, "longest_walk": longest, "bound_ms": bound, "bound_by": by,
            "step_ns": step_ns, "staged_bytes": staged, "staged_bytes_ms": staged_ms,
            "walk_floor_ms": walk_ms, "design_floor_ms": max(walk_ms, staged_ms)}


# ---------------------------------------------------------------------------
# phase 3b: kernels B2 and B3 off the diagonal (each lane's band centre)

# (N, L, W): the polish tile's first shape, and band 128 at a length whose
# plain versions (a launch-bound loop over the rows) take about 2 s
BAND_CENTRE_SHAPES = ((1024, 2048, 64), (256, 384, 128))
BAND_CENTRE_CLUSTER = (30, 192)  # (S, L) of dp_cases.band_centre_cluster


def check_band_centres(dev, seed: int, N: int, L: int, W: int, step_ns: float) -> dict:
    """Kernels B2 and B3 with every lane off the diagonal
    (``dp_cases.dp_batch``'s band centres, zeros drawn anew from +-[1, W])
    against the plain forward and steps at the same offsets on the same
    card tensors: every output equal. Times, plain times and bounds as in
    phase 3 (the band centres among the bytes read)."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import pileup, pileup_kernel, traceback_kernel
    from ont_tcrconsensus_tpu_torch.parallel.mesh import lockstep

    reads, rl, refs, tl, offs = dp_cases.dp_batch(N, L, W, seed)
    offs = dp_cases.nonzero_offsets(seed, offs, W)
    reads, rl, refs, tl, offs = (torch.from_numpy(x).to(dev)
                                 for x in (reads, rl, refs, tl, offs))
    fwd = (reads, rl, refs, tl, W)

    def b2():
        return pileup_kernel.forward_planes_cuda(*fwd, offs=offs)

    best, planes = b2()
    (best_p, planes_p), b2_plain_ms = _timed_once(
        lambda: pileup._forward_batch(*fwd, offs=offs))
    for name, a, b in (("best", best, best_p), ("planes", planes, planes_p)):
        if not torch.equal(a, b):
            bad = (a != b).reshape(N, -1).any(dim=1).nonzero()[0, 0]
            raise AssertionError(f"B2 with offsets L={L} W={W}: {name} differs (first lane "
                                 f"{int(bad)})")
    args = (best, planes, reads, W, L)

    def b3():
        return traceback_kernel.traceback_columns_cuda(*args, offs=offs)

    got = b3()
    want, b3_plain_ms = _timed_once(lambda: lockstep([pileup._traceback_steps(*args, offs)])[0])
    for name, a, b in zip(("base_at", "ins_cnt", "ins_base", "pos_at", "spans"), got, want):
        if not torch.equal(a, b):
            bad = (a != b).reshape(N, -1).any(dim=1).nonzero()[0, 0]
            raise AssertionError(f"B3 with offsets L={L} W={W}: {name} differs (first lane "
                                 f"{int(bad)})")
    rows = {}
    for key, fn, plain_ms in (("b2", b2, b2_plain_ms), ("b3", b3, b3_plain_ms)):
        for _ in range(2):
            fn()
        rows[key] = {"max_abs_err": 0, "ms": _time_ms(fn, 7), "call_ms": _time_ms(fn, 7, spin=False),
                     "plain_ms": plain_ms}
    rows["b2"].update(_pileup_costs(rl, refs.shape[1], L, W, extra_bytes=4 * N))
    rows["b3"].update(_traceback_costs(best, want[4], N, L, W, L, step_ns, extra_bytes=4 * N))
    spans = want[4]
    return {"N": N, "L": L, "W": W, "offsets": [int(offs.min()), int(offs.max())],
            "zero_offsets": int((offs == 0).sum()),
            "aligned_lanes": int((best[:, 0] > 0).sum()),
            "lanes_past_the_draft": int(((spans[:, 2] < 0) | (spans[:, 3] > tl)).sum()),
            **rows}


def check_pileup_columns_offsets(dev, seed: int, W: int) -> dict:
    """``ops/pileup.pileup_columns`` at the band centres {-40, -7, 0, 5, 37}
    (``dp_cases.band_centre_cluster``) on ``dev`` against ``cpu``: every
    output equal, one B2 and one B3 launch; out_len 3L/4 at W = 128."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import pileup, pileup_kernel, traceback_kernel

    S, L = BAND_CENTRE_CLUSTER
    out_len = L if W == 64 else 3 * L // 4
    case = dp_cases.band_centre_cluster(seed, S, L)
    counters = (pileup_kernel.forward_planes_cuda, traceback_kernel.traceback_columns_cuda)
    before = [(k.launches, k.launches_offs) for k in counters]
    got = pileup.pileup_columns(*case, band_width=W, out_len=out_len, device=dev)
    launches = [(k.launches - b, k.launches_offs - o) for k, (b, o) in zip(counters, before)]
    if launches != [(1, 1), (1, 1)]:
        raise AssertionError(f"pileup_columns with offsets: B2/B3 launches (all, given band "
                             f"centres) {launches}")
    want = pileup.pileup_columns(*case, band_width=W, out_len=out_len, device="cpu")
    for name, a, b in zip(("base_at", "ins_cnt", "ins_base", "pos_at", "spans"), got, want):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"pileup_columns with offsets W={W}: {name} differs on cuda")
    return {"S": S, "L": L, "W": W, "out_len": out_len, "equal": True,
            "offsets": sorted(set(int(o) for o in case[4])),
            "aligned_lanes": int((want[4][:, 1] > want[4][:, 0]).sum())}


# ---------------------------------------------------------------------------
# kernels B5 (the fuzzy match) and B6 (the UMI dovetail distance)

# The bound of each: the least work known to compute the function, the
# bit-parallel DP (Myers 1999, in Hyyro's 64-row words, as
# csrc/bitvector.cuh runs it): the int32 operations of one word step,
# counted from its formulas, a 64-bit add, shift or two-input logical op as
# two int32 operations and a three-input logical expression as one a half
# (Hopper's LOP3), times the word steps these inputs need (a pair's
# ceil(rows / 64) words over its columns), plus B5's per-column terms and
# B6's corner (its top row past its left column, its left column's rows).
# Loads and the match tables are not counted.
BITVECTOR_STEP_OPS = {
    "Xv = Eq | Mv": 2,
    "Eq & Pv, + Pv (and the carry from the word below)": 4,
    "Xh = (sum ^ Pv) | Eq": 2,
    "Ph = Mv | ~(Xh | Pv)": 2,
    "Mh = Pv & Xh": 2,
    "Ph << 1 | hin, Mh << 1": 4,
    "Pv = Mh | ~(Xv | Ph)": 2,
    "Mv = Ph & Xv": 2,
}
BITVECTOR_COLUMN_OPS = {
    "B5 score at the last row: two one-bit extracts, add, subtract": 4,
    "B5 pass 1, first minimum: compare, two selects": 3,
    "B5 pass 2, last equal column: compare, select": 2,
    "B6 corner's top row past its left column: two extracts, add, subtract, min": 5,
    "B6 corner's left column, a row: two extracts, add, max": 4,
}
# The cell bound, kept beside it: int32 operations a DP cell of each needs,
# one per two-input add, compare, select, min or logical op, counted from the
# plain versions' recurrences (ops/fuzzy_match._final_row,
# ops/edit_distance.pairwise_dovetail_plain) written as min(diag + sub,
# min(up, prev) + 1); loads and per-row or per-column terms (the overhangs
# past k_end) are not counted
FUZZY_CELL_OPS = {"match test: and, compare": 2,
                  "recurrence: add, min, add, min": 4}
DOVETAIL_CELL_OPS = {"match test: compare": 1, "recurrence: add, min, add, min": 4,
                     "candidate: add the row's overhang, min": 2}
# the lane's two call shapes (P, m, B, Lw): the primer trim (4 bundled
# primers and their reverse complements, m = 47, over 2 x 1024 windows of
# trim_window 150) and the UMI windows (2 patterns of 32 over 2 x 1024
# windows of 81)
FUZZY_SHAPES = ((8, 47, 2048, 150), (2, 32, 2048, 81))
# B6's: the shortlist's distance chunk (cluster/umi._PAIR_CHUNK pairs at
# pad width 128) at the UMI path's k_end 8 and the rescue's 16, and the full
# matrix of 256 x 256
DOVETAIL_PAIRS, DOVETAIL_L, DOVETAIL_GRID = 8192, 128, 256
# past one word at small batches: B5's word edges (one pattern of each
# length of dp_cases.WORD_EDGES) and its longest pattern, (P, m, B, Lw);
# B6's word edges (every a length of WORD_EDGES at every kind) and its
# widest first sequences, (n, L, lens)
FUZZY_WIDE = ((6, 129, 60, 180), (2, 1787, 64, 1900))
DOVETAIL_WIDE = ((48, 140, None), (64, 1452, (1300, 1452)))


def _words(rows):
    """64-row words a column of ``rows`` rows takes (a tensor)."""
    return (rows.clamp(min=0) + 63) // 64


def _ptxas(log: str) -> dict:
    """ptxas's registers and spill bytes of a library's one kernel
    (``-Xptxas -v``; empty when the library was not built in this run)."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    return {"registers": max(regs) if regs else None,
            "spill_bytes": sum(spills) if regs else None}


def _warps_an_sm(blocks: int) -> float:
    """The warps an SM holds at a launch of ``blocks`` one-warp blocks, the
    launch spread over the card's SMs."""
    import torch

    return blocks / torch.cuda.get_device_properties(0).multi_processor_count


def _exact(label: str, got, want) -> int:
    """Every output equal, else raise naming the first difference; the
    largest absolute difference (0)."""
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.equal(a, b):
            bad = tuple((a != b).nonzero()[0].tolist()) if a.shape == b.shape else ()
            raise AssertionError(f"{label}: output {i} differs at {bad}: kernel "
                                 f"{a[bad].tolist()}, plain {b[bad].tolist()}")
    return 0


def check_fuzzy(dev, seed: int, P: int, m: int, B: int, Lw: int, ptxas: dict,
                plens=None) -> dict:
    """Kernel B5 against the plain version on the same card tensors
    (``dp_cases.fuzzy_case``): dist, start and end exactly equal. The bound
    counts the word steps these inputs need: ceil(p_len / 64) words over
    each window's columns (pass 1) and over its prefix [0, end) (pass 2),
    against the bytes of each pattern and window within its length; the
    cell bound p_len rows over the same columns."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import fuzzy_kernel, fuzzy_match

    args = [torch.from_numpy(x).to(dev)
            for x in dp_cases.fuzzy_case(seed, P, m, B, Lw, plens=plens)]
    got = fuzzy_kernel.fuzzy_find_multi_cuda(*args)
    want, plain_ms = _timed_once(lambda: fuzzy_match.fuzzy_find_multi_plain(*args))
    err = _exact(f"B5 P={P} m={m} B={B} Lw={Lw}", got, want)
    for _ in range(2):
        fuzzy_kernel.fuzzy_find_multi_cuda(*args)
    ms = _time_ms(lambda: fuzzy_kernel.fuzzy_find_multi_cuda(*args), 7)
    call_ms = _time_ms(lambda: fuzzy_kernel.fuzzy_find_multi_cuda(*args), 7, spin=False)
    rows = args[1].clamp(0, m).long()[:, None]
    cols1 = args[3].clamp(0, Lw).long()[None, :].expand(P, B)
    cols2 = want[2].long()
    cells = int((rows * (cols1 + cols2)).sum())
    steps = int((_words(rows) * (cols1 + cols2)).sum())
    c = BITVECTOR_COLUMN_OPS
    n_ops = (steps * sum(BITVECTOR_STEP_OPS.values())
             + int(cols1.sum()) * (c["B5 score at the last row: two one-bit extracts, add, subtract"]
                                   + c["B5 pass 1, first minimum: compare, two selects"])
             + int(cols2.sum()) * (c["B5 score at the last row: two one-bit extracts, add, subtract"]
                                   + c["B5 pass 2, last equal column: compare, select"]))
    # each pattern's masks and each window's bases read once, lengths
    # included, the three outputs written once
    n_bytes = (int(rows.sum()) + 4 * P + int(args[3].clamp(0, Lw).sum()) + 4 * B
               + 3 * 4 * P * B)
    bound, by = _bound_ms(n_bytes, n_ops)
    cell_bound, cell_by = _bound_ms(n_bytes, cells * sum(FUZZY_CELL_OPS.values()))
    return {"P": P, "m": m, "B": B, "Lw": Lw, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "word_steps": steps, "ops": n_ops, "bound_ms": bound,
            "bound_by": by, "cells": cells, "cell_bound_ms": cell_bound, "cell_bound_by": cell_by,
            "fn_ops_per_cell": sum(FUZZY_CELL_OPS.values()),
            "exact_hits": int((want[0] == 0).sum()), "ptxas": ptxas,
            "warps_an_sm": _warps_an_sm(-(-B // 32) * P)}


def check_dovetail(dev, seed: int, k_end: int, grid: bool, ptxas: dict, n: int = DOVETAIL_PAIRS,
                   L: int = DOVETAIL_L, lens=(58, 68), a_lens=None, nw: bool = False) -> dict:
    """Kernel B6 against the plain version on the same card tensors
    (``dp_cases.dovetail_case``, by default lengths 58-68 at width 128):
    ``n`` pairs, or (``grid``) the 256 x 256 full matrix, whose plain
    yardstick runs on the repeated pairs. ``nw``: B6 reached through the
    global distance's public functions (``edit_distance.pairwise``,
    ``many_vs_many``), which call it at k_end 0. The bound counts the word steps
    these inputs need: ceil(a_len / 64) words over columns 1..b_len of each
    pair, with the score's and the corner's terms, against the bytes of
    each sequence within its length; the cell bound rows 1..a_len over
    those columns (the border row and column take no DP step)."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import dovetail_kernel, edit_distance

    a, al, b, bl = (torch.from_numpy(x).to(dev) for x in dp_cases.dovetail_case(
        seed, DOVETAIL_GRID if grid else n, L, lens, a_lens=a_lens))
    Q = T = DOVETAIL_GRID

    def kernel():
        if nw:
            return (edit_distance.many_vs_many if grid else edit_distance.pairwise)(a, al, b, bl)
        if grid:
            return dovetail_kernel.many_vs_many_dovetail_cuda(a, al, b, bl, k_end)
        return dovetail_kernel.pairwise_dovetail_cuda(a, al, b, bl, k_end)

    def plain():
        if grid:  # the grid's pairs repeated, as the plain many-vs-many makes them
            return edit_distance.pairwise_dovetail_plain(
                a.repeat_interleave(T, dim=0), al.repeat_interleave(T), b.repeat(Q, 1),
                bl.repeat(Q), k_end).reshape(Q, T)
        return edit_distance.pairwise_dovetail_plain(a, al, b, bl, k_end)

    rows = al.clamp(0, L).long()
    cols = bl.clamp(0, L).long()
    a_len, b_len = al.long(), bl.long()
    # each sequence's bases within its length and its length read once
    # (a grid's Q + T sequences, a pair's two), each distance written once
    n_pairs = Q * T if grid else n
    n_bytes = int(rows.sum() + cols.sum()) + 4 * (len(al) + len(bl)) + 4 * n_pairs
    if grid:
        rows, cols, a_len, b_len = rows[:, None], cols[None, :], a_len[:, None], b_len[None, :]
    if nw and k_end != 0:
        raise ValueError("the global distance is B6 at k_end 0")
    b6 = dovetail_kernel.dovetail_cuda
    before = (b6.launches, b6.launches_nw)
    got = kernel()
    if (b6.launches, b6.launches_nw) != (before[0] + 1, before[1] + (k_end == 0)):
        raise AssertionError(f"B6 {'nw ' if nw else ''}made {b6.launches - before[0]} "
                             f"launches, {b6.launches_nw - before[1]} of them at k_end 0")
    want, plain_ms = _timed_once(plain)
    err = _exact(f"B6 {'nw ' if nw else ''}{'grid' if grid else 'pairs'} n={n_pairs} L={L} "
                 f"k_end={k_end}", [got], [want])
    if nw and grid:  # the identity on the card against the CPU's plain route (a block)
        ident = edit_distance.identity_matrix(a, al, b, bl)[:32, :64]
        want_ident = edit_distance.identity_matrix(a[:32].cpu(), al[:32].cpu(), b[:64].cpu(),
                                                   bl[:64].cpu())
        if not torch.equal(ident.cpu(), want_ident):
            raise AssertionError("identity_matrix on the card differs from the CPU's")
    for _ in range(2):
        kernel()
    ms = _time_ms(kernel, 7)
    call_ms = _time_ms(kernel, 7, spin=False)
    cells = int((rows * cols).sum())
    steps = int((_words(rows) * cols).expand_as(rows * cols).sum())
    top_cols = (cols - torch.minimum(cols, (b_len - k_end).clamp(min=0))).expand_as(rows * cols)
    left_rows = (rows - torch.minimum(rows, (a_len - k_end).clamp(min=0))).expand_as(rows * cols)
    c = BITVECTOR_COLUMN_OPS
    n_ops = (steps * sum(BITVECTOR_STEP_OPS.values())
             + int(top_cols.sum())
             * c["B6 corner's top row past its left column: two extracts, add, subtract, min"]
             + int(left_rows.sum()) * c["B6 corner's left column, a row: two extracts, add, max"])
    bound, by = _bound_ms(n_bytes, n_ops)
    cell_bound, cell_by = _bound_ms(n_bytes, cells * sum(DOVETAIL_CELL_OPS.values()))
    return {"shape": f"{Q} x {T}" if grid else f"{n_pairs} pairs", "L": L, "k_end": k_end,
            "pairs": n_pairs, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "word_steps": steps, "ops": n_ops, "bound_ms": bound, "bound_by": by,
            "cells": cells, "cell_bound_ms": cell_bound, "cell_bound_by": cell_by,
            "fn_ops_per_cell": sum(DOVETAIL_CELL_OPS.values()), "ptxas": ptxas,
            "warps_an_sm": _warps_an_sm(-(-n_pairs // 32))}


@contextlib.contextmanager
def _launch_shapes(module, name: str, shape_of, keep: bool = True):
    """Count the CUDA calls of the dispatcher ``module.name`` by input shape
    while the block runs, keeping (when ``keep``) a host copy of the first
    call's inputs of each shape: {shape: [calls, args, kwargs]}. The
    dispatcher is wrapped, not the kernel's wrapper, which keeps counting
    its own launches."""
    import torch

    fn = getattr(module, name)
    seen: dict = {}

    def record(*args, **kwargs):
        shape = shape_of(*args, **kwargs)
        if shape[0] and args[0].device.type == "cuda":
            if shape not in seen:
                seen[shape] = [0, tuple(a.to("cpu", copy=True) if torch.is_tensor(a) else a
                                        for a in args) if keep else None, dict(kwargs)]
            seen[shape][0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def _sw_shape(reads, read_lens, refs, *rest, band_width=256, **_):
    return (reads.shape[0], reads.shape[1], refs.shape[1], band_width)


def _pileup_shape(reads, read_lens, refs, ref_lens, band_width, offs=None):
    return (reads.shape[0], reads.shape[1], refs.shape[1], band_width)


def _traceback_shape(reads, read_lens, refs, ref_lens, band_width, out_len, offs=None):
    return (reads.shape[0], reads.shape[1], refs.shape[1], band_width, out_len)


def traceback_gaps(shapes: dict, forward_shapes: dict, step_ns: float, dev) -> dict:
    """:func:`launch_gaps` for kernel B3: each recorded traceback shape
    (batch, L, Lr, W, out_len) replays B2 on the first forward's inputs of
    its (batch, L, Lr, W), recorded by the same run, and times B3 on those
    planes (CUDA-event median of 5 after one warm-up), against the bound
    and the design's floor of this output's walks."""
    from ont_tcrconsensus_tpu_torch.ops import pileup_kernel, traceback_kernel

    rows, total = [], 0.0
    for shape, (calls, _, _) in sorted(shapes.items()):
        N, L, Lr, W, out_len = shape
        reads, read_lens, refs, ref_lens = (
            a.to(dev) for a in forward_shapes[(N, L, Lr, W)][1][:4])
        best, planes = pileup_kernel.forward_planes_cuda(reads, read_lens, refs, ref_lens, W)
        spans = traceback_kernel.traceback_columns_cuda(best, planes, reads, W, out_len)[4]
        ms = _time_ms(lambda: traceback_kernel.traceback_columns_cuda(
            best, planes, reads, W, out_len), 5)
        c = _traceback_costs(best, spans, N, L, W, out_len, step_ns)
        gap = calls * (ms - c["bound_ms"])
        total += gap
        rows.append({"shape": list(shape), "launches": calls, "ms": ms,
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "design_floor_ms": c["design_floor_ms"],
                     "launches_x_gap_ms": gap})
        del best, planes
    return {"shapes": rows, "launches_x_gap_ms": total,
            "kernel_ms": sum(r["launches"] * r["ms"] for r in rows)}


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
    L, band W), split into the kernel B2 forward, the kernel B3 traceback
    and the vote, beside one call of the plain scan-log traceback (the
    host loop B3 replaced); then the whole round once more under
    ``torch.profiler``, whose device time over the round's unprofiled wall
    time is the card's busy share in polish; and two rounds fused against
    unfused (:func:`fused_pair_split`)."""
    import torch

    from ont_tcrconsensus_tpu_torch.ops import consensus, pileup
    from ont_tcrconsensus_tpu_torch.parallel.mesh import lockstep

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
    plain_tb_ms = _host_ms(
        lambda: lockstep([pileup._traceback_steps(best, planes, reads_t, W, L)])[0], 1)
    vote_ms = _host_ms(
        lambda: consensus.vote_columns_batch(base_at, ins_cnt, ins_base, drafts_t, dl_t), 3)

    def one_round():
        b, p = forward()
        cols = (x.reshape(C, S, L) for x in pileup._traceback_batch(b, p, reads_t, W, L)[:3])
        return consensus.vote_columns_batch(*cols, drafts_t, dl_t)

    round_ms = _host_ms(one_round, 1)
    traced = _device_ms(one_round)
    busy = traced["device_ms"] / round_ms if traced["events"] else None
    pair = fused_pair_split(dev, reads, rl, drafts, dl, W)
    return {"C": C, "S": S, "L": L, "W": W, "forward_ms": fwd_ms, "traceback_ms": tb_ms,
            "plain_traceback_ms": plain_tb_ms, "vote_ms": vote_ms, "round_ms": round_ms,
            "device_ms": traced["device_ms"], "device_events": traced["events"],
            "busy_share": busy, **pair}


def fused_pair_split(dev, reads, rl, drafts, dl, W: int) -> dict:
    """Two vote rounds at the polish tile as ``ops/consensus`` runs them:
    fused (``_pair_program``: both rounds, their end extensions and flags
    on the card, one readback) beside unfused (each round's pileup and
    vote, a readback, the ends extended on the host). Both from the tile's
    drafts, host clock, median of 3; the drafts of both must be equal."""
    import torch

    from ont_tcrconsensus_tpu_torch.obs import device as obs_device
    from ont_tcrconsensus_tpu_torch.ops import consensus, pileup
    from ont_tcrconsensus_tpu_torch.parallel.mesh import lockstep

    L = reads.shape[2]
    sub_t, rl_t = torch.from_numpy(reads).to(dev), torch.from_numpy(rl).to(dev)

    def fused():
        out = lockstep([consensus._pair_program(
            sub_t, rl_t, torch.from_numpy(drafts).to(dev), torch.from_numpy(dl).to(dev), W,
            False)])[0]
        return obs_device.to_host(out[:5])

    def unfused():
        d, n = drafts.copy(), dl.copy()
        for _ in range(2):
            td, tn = torch.from_numpy(d).to(dev), torch.from_numpy(n).to(dev)
            cols = pileup.pileup_columns_batch_auto(sub_t, rl_t, td, tn, band_width=W, out_len=L)
            nd, nn = consensus.vote_columns_batch(*cols[:3], td, tn)
            nd, nn, spans = obs_device.to_host((nd[:, :L], nn, cols[4]))
            d, n = consensus._extend_ends_batch(nd.copy(), nn.astype(np.int32), reads, rl,
                                                spans, n)
        return d, n

    got, want = fused(), unfused()
    if got[2].any() or got[3].any():
        raise AssertionError("fused pair: a draft grew past the padded width")
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError("fused pair: its drafts differ from two unfused rounds'")
    return {"pair_fused_ms": _host_ms(fused, 3), "pair_unfused_ms": _host_ms(unfused, 3),
            "pair_stable": int(got[4].sum())}


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
                res["_feats_cuda"] = feats  # phase 13's bf16 tile (popped, not reported)
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


# int32 operations of one band cell of the fill and one step of the walk,
# counted from the plain version (qc/error_profile._device_cs_core); loads
# are not counted, and the scratch plane is not among the bytes
CS_CELL_OPS = {
    "source lanes, band tests, diagonal and up": 8,
    "cell index, validity, match test, substitution": 9,
    "diagonal, up, best, up-wins direction": 5,
    "prefix min of best - lane, left": 3,
    "left vs best, direction, row value, plane cell": 5,
}
CS_STEP_OPS = {
    "band offset, in-band and stop tests": 6,
    "plane index, diagonal, up, left": 8,
    "kind, next row and column": 7,
}


def _cs_stops(kind: np.ndarray) -> np.ndarray:
    """Each read's first STOP row of an op log (S, L) (S when none)."""
    stop = kind == 4
    return np.where(stop.any(axis=0), stop.argmax(axis=0), kind.shape[0])


def _oplog_mismatch(got, want):
    """The first read whose op log (kind, qb, rb) differs up to and
    including its walk's first STOP, or None."""
    gs, ws_ = _cs_stops(got[0]), _cs_stops(want[0])
    S = min(got[0].shape[0], want[0].shape[0])
    upto = np.arange(S)[:, None] <= gs[None, :]
    bad = gs != ws_
    for g, w in zip(got, want):
        bad |= ((g[:S] != w[:S]) & upto).any(axis=0)
    return int(np.flatnonzero(bad)[0]) if bad.any() else None


def _cs_costs(arrays, stops: np.ndarray) -> dict:
    """B4's bound from one tile's own data (numpy inputs qpad, rpad, n, m,
    lo_all, ws): the band cells of rows 1..n of each read's own band ws and
    the steps of each walk, at CS_CELL_OPS and CS_STEP_OPS, over the int32
    rate; bytes: every input read once, the op log written once."""
    qpad, rpad, n_arr, _, lo_all, ws = arrays
    L, N = qpad.shape
    S = N + rpad.shape[1]
    cells = int((n_arr.astype(np.int64) * ws).sum())
    steps = int(stops.sum())
    n_bytes = sum(a.nbytes for a in arrays) + 3 * S * L
    bound, by = _bound_ms(n_bytes, cells * sum(CS_CELL_OPS.values())
                          + steps * sum(CS_STEP_OPS.values()))
    # the design's own traffic: each read's codes and band starts staged
    # whole, its packed plane rows 0..n written and staged back for the walk
    w_pad = -(-int(ws.max()) // 64) * 64
    staged = L * (N + rpad.shape[1] + 4 * (N + 1)) + int((n_arr.astype(np.int64) + 1).sum()) \
        * w_pad // 4 * 2
    return {"L": L, "N": N, "M": rpad.shape[1], "cells": cells, "steps": steps,
            "rows_max": int(n_arr.max()), "longest_walk": int(stops.max()),
            "bound_ms": bound, "bound_by": by, "staged_bytes": staged,
            "staged_bytes_ms": staged / HBM_BYTES_PER_S * 1e3}


def _cs_lone_read_ms(arrays, w_pad: int, k: int, dev, reps: int = 5) -> float:
    """Kernel B4 on read ``k`` of a tile alone (its row of every input), the
    L2 cache (50 MB) overwritten before each of ``reps`` CUDA-event timed
    launches: the median, the time this design needs for its slowest block
    when nothing shares the card with it (its inputs cold; the plane rows
    its fill writes are still in L2 for its walk)."""
    import torch

    from ont_tcrconsensus_tpu_torch.ops import cs_kernel

    args = [torch.from_numpy(a[k:k + 1].copy()).to(dev) for a in arrays]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    cs_kernel.error_profile_cs_cuda(*args, w_pad)
    times = []
    for _ in range(reps):
        flush.fill_(1)
        times.append(_time_ms(lambda: cs_kernel.error_profile_cs_cuda(*args, w_pad), 1))
    return float(np.median(times))


def _cs_shape(qpad, rpad, *rest, w_pad):
    return (qpad.shape[0], qpad.shape[1], rpad.shape[1], w_pad)


def cs_gaps(shapes: dict, dev) -> dict:
    """:func:`launch_gaps` for kernel B4: each recorded tile shape (L, N, M,
    w_pad) held to the plain ``_device_cs_core`` on its first launch's own
    card tensors (every op log up to its stop; the plain core's one call
    timed) and timed (CUDA-event median of 5 after one warm-up), against
    the bound of that tile's cells and walks and the design's floor (the
    tile's slowest read alone, :func:`_cs_lone_read_ms`)."""
    from ont_tcrconsensus_tpu_torch.ops import cs_kernel
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    rows, total = [], 0.0
    for shape, (calls, host_args, kwargs) in sorted(shapes.items()):
        args = [a.to(dev) for a in host_args]
        w_pad = kwargs["w_pad"]
        got = [x.cpu().numpy() for x in cs_kernel.error_profile_cs_cuda(*args, w_pad)]
        plain, plain_ms = _timed_once(lambda: error_profile._device_cs_core(
            *args, w_pad=w_pad, n_fill=int(host_args[2].max())))
        bad = _oplog_mismatch(got, [x.cpu().numpy() for x in plain])
        if bad is not None:
            raise AssertionError(f"B4 at {shape}: read {bad}'s op log differs from the "
                                 "plain core's")
        del plain
        ms = _time_ms(lambda: cs_kernel.error_profile_cs_cuda(*args, w_pad), 5)
        arrays = [a.numpy() for a in host_args]
        stops = _cs_stops(got[0])
        c = _cs_costs(arrays, stops)
        gap = calls * (ms - c["bound_ms"])
        total += gap
        rows.append({"shape": list(shape), "launches": calls, "ms": ms, "plain_ms": plain_ms,
                     "oplogs_equal_plain": True,
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "design_floor_ms": _cs_lone_read_ms(
                         arrays, w_pad, int(np.argmax(arrays[2] + stops)), dev),
                     "longest_walk": c["longest_walk"], "launches_x_gap_ms": gap})
        del args
    return {"shapes": rows, "launches_x_gap_ms": total,
            "kernel_ms": sum(r["launches"] * r["ms"] for r in rows)}


def check_cs_tiles(dev) -> list[dict]:
    """Kernel B4 on the tests' tiles (``dp_cases.cs_tiles``: ragged reads
    with N bases, leading insertions and paths far off the diagonal at
    w_pad 128; |n - m| up to 120 at w_pad 320) and on crafted band starts
    (``dp_cases.cs_crafted``: a band jump the walks leave by, a band
    moving back that forces the tail insertion), against the plain core on
    the same card tensors: every op log up to its stop."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import cs_kernel
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    tiles = [(label, *dp_cases.cs_tile_arrays(qs, rs))
             for label, (qs, rs) in dp_cases.cs_tiles().items()]
    tiles += [(case, *dp_cases.cs_crafted(case)) for case in dp_cases.CS_CRAFTED]
    rows = []
    for label, arrays, w_pad in tiles:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = [x.cpu().numpy() for x in cs_kernel.error_profile_cs_cuda(*args, w_pad)]
        want = [x.cpu().numpy() for x in error_profile._device_cs_core(
            *args, w_pad=w_pad, n_fill=int(arrays[2].max()))]
        bad = _oplog_mismatch(got, want)
        if bad is not None:
            raise AssertionError(f"B4 on the {label} tile: read {bad}'s op log differs from "
                                 "the plain core's")
        rows.append({"tile": label, "w_pad": w_pad, "reads": int(arrays[0].shape[0]),
                     "rows_max": int(arrays[2].max()), "walk_steps": int(_cs_stops(got[0]).sum()),
                     "oplogs_equal_plain": True})
    return rows


def error_profile_phase(step_ns: float, ptxas: list[str], seed: int = 5, n: int = 512) -> dict:
    """Kernel B4 on the error profile's tile of ``n`` simulated reads
    (1.4-2.3 kb regions, the systematic ONT error model) against their
    reference spans, the tile the device path itself lays out (recorded
    from its first call): against the plain ``_device_cs_core`` on the
    same card tensors, every op log up to its stop. The device path's
    strings (B4 inside) against the numpy fill, its seconds (two more
    calls, host clock) and one traced call; see the module docstring
    (phase 5)."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.ops import cs_kernel, encode
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    dev = torch.device("cuda")
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

    def device_path():
        strings = error_profile.banded_cs_batch_device(queries, spans, device="cuda")
        if strings != want:
            bad = next(i for i, (a, b) in enumerate(zip(strings, want)) if a != b)
            raise AssertionError(f"error profile: read {bad}'s cs string differs between "
                                 f"the device path and numpy: {strings[bad][:80]!r} vs "
                                 f"{want[bad][:80]!r}")

    with _launch_shapes(error_profile, "cs_core_auto", _cs_shape) as tiles:
        device_path()
    ((_, host_args, kwargs),) = tiles.values()
    w_pad = kwargs["w_pad"]
    arrays = [a.numpy() for a in host_args]
    args = [a.to(dev) for a in host_args]
    got = [x.cpu().numpy() for x in cs_kernel.error_profile_cs_cuda(*args, w_pad)]
    plain, plain_ms = _timed_once(lambda: error_profile._device_cs_core(
        *args, w_pad=w_pad, n_fill=int(arrays[2].max())))
    bad = _oplog_mismatch(got, [x.cpu().numpy() for x in plain])
    if bad is not None:
        raise AssertionError(f"B4: read {bad}'s op log differs from the plain core's")
    for _ in range(2):
        cs_kernel.error_profile_cs_cuda(*args, w_pad)
    kernel_ms = _time_ms(lambda: cs_kernel.error_profile_cs_cuda(*args, w_pad), 7)
    call_ms = _time_ms(lambda: cs_kernel.error_profile_cs_cuda(*args, w_pad), 7, spin=False)
    stops = _cs_stops(got[0])
    costs = _cs_costs(arrays, stops)
    # the design's floor: the read with the most rows and steps, alone
    slow = int(np.argmax(arrays[2] + stops))
    lone_ms = _cs_lone_read_ms(arrays, w_pad, slow, dev)
    del args, plain

    device_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        device_path()
        torch.cuda.synchronize()
        device_s.append(time.perf_counter() - t0)
    traced = _device_ms(device_path)
    lens = [len(q) for q in queries]
    return {"n_reads": n, "read_len": [min(lens), max(lens)], "w_pad": w_pad, "ms": kernel_ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "max_abs_err": 0, **costs,
            "lone_read": {"column": slow, "rows": int(arrays[2][slow]),
                          "steps": int(stops[slow]), "ms": lone_ms,
                          "walk_x_step_ms": int(stops[slow]) * step_ns * 1e-6},
            "design_floor_ms": lone_ms, "ptxas": ptxas, "device_s": device_s,
            "tiles": check_cs_tiles(dev),
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


def _run_lane(root: str, knobs: dict, device: str, timings: dict | None = None,
              fresh: bool = True):
    """One run of the lane at ``root``; ``fresh`` first removes its output
    (a ``resume: true`` run keeps it)."""
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import run_with_config

    if fresh:
        shutil.rmtree(os.path.join(root, "fastq_pass", "nano_tcr"), ignore_errors=True)
    return run_with_config(RunConfig.from_dict(_lane_raw(root, knobs)), device=device,
                           timings=timings)


def _lane_raw(root: str, knobs: dict) -> dict:
    """The run config of the lane at ``root``: a one-shot run's, a
    daemon's template or a served job's overrides."""
    return {"reference_file": os.path.join(root, "reference.fa"),
            "fastq_pass_dir": os.path.join(root, "fastq_pass"),
            "delete_tmp_files": False, **knobs}


# files of a run that hold times, not results (the stage table's names and
# the observation files' keys and names are compared instead)
TIMED_FILES = ("barcode01/stage_manifest.json", "barcode01/logs/stage_timing.tsv",
               "telemetry.json", "history.jsonl")
# the files of a corrupted run under quarantine that differ from the clean
# run's: the report (the ingest events, the chaos plan, strict contracts)
# and the quarantine artifact; tests/test_torch_ingest_e2e.py holds this
# list to the JAX package's clean and corrupted runs
INGEST_DIFFERS = ("robustness_report.json", "barcode01/quarantine.fastq.gz")
# the gauge only a run on the card has
DEVICE_GAUGE = "device.hbm_bytes_in_use"
# and the graph executor's node-boundary memory samples, which only a run
# on the card takes: (section, key)
CARD_ONLY = (("gauges", DEVICE_GAUGE), ("counters", "memory.reconcile"),
             ("transfers", "node_hbm"))


def _keys(value):
    """A JSON value's nested key sets (the values themselves dropped)."""
    if isinstance(value, dict):
        return {k: _keys(v) for k, v in value.items()}
    return None


def _compare_obs(cuda: dict[str, bytes], cpu: dict[str, bytes], label: str) -> dict:
    """telemetry.json and history.jsonl of a cuda run and a cpu run of one
    lane: equal keys (but the card's own, :data:`CARD_ONLY`), stage names,
    dispatch sites and their counts, and config fingerprint."""
    tel = {dev: json.loads(tree["telemetry.json"]) for dev, tree in
           (("cuda", cuda), ("cpu", cpu))}
    hist = {dev: [json.loads(ln) for ln in tree["history.jsonl"].decode().splitlines()]
            for dev, tree in (("cuda", cuda), ("cpu", cpu))}
    keys = {dev: _keys(t) for dev, t in tel.items()}
    for section, key in CARD_ONLY:
        if key not in tel["cuda"][section] or key in tel["cpu"][section]:
            raise AssertionError(f"{label}: {section}.{key} must be on cuda only")
        del keys["cuda"][section][key]
    if keys["cuda"] != keys["cpu"]:
        raise AssertionError(f"{label}: telemetry.json keys differ between cuda and cpu")
    counts = {dev: {site: (d["dispatches"], d["gets"]) for site, d in t["dispatch"].items()}
              for dev, t in tel.items()}
    if counts["cuda"] != counts["cpu"]:
        raise AssertionError(f"{label}: dispatch counts differ: {counts}")
    if len(hist["cuda"]) != 1 or len(hist["cpu"]) != 1:
        raise AssertionError(f"{label}: history.jsonl must hold one entry a run")
    (hc,), (hp,) = hist["cuda"], hist["cpu"]
    if (set(hc) != set(hp) or hc["fingerprint"] != hp["fingerprint"]
            or (hc["backend"], hp["backend"]) != ("cuda", "cpu")):
        raise AssertionError(f"{label}: history entries differ in keys, fingerprint or backend")
    return {"dispatch_counts": counts["cuda"], "fingerprint": hc["fingerprint"],
            "stages": sorted(tel["cuda"]["stages"])}


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


def _small_library():
    """The tests' 4-region lane (seed 11, 73 reads of 700-850 nt)."""
    from ont_tcrconsensus_tpu_torch.io import simulator

    return simulator.simulate_library(
        seed=11, num_regions=4, molecules_per_region=(2, 3), reads_per_molecule=(5, 8),
        sub_rate=0.006, ins_rate=0.003, del_rate=0.003, region_len=(700, 850),
    )


SMALL_KNOBS = {"minimal_length": 600, "min_reads_per_cluster": 4, "read_batch_size": 64}
# the lanes' polish: the default config (no polish_method key: the bi-GRU
# polisher) and the vote consensus alone
POLISH = {"rnn": {}, "poa": {"polish_method": "poa"}}


def _small_cpu(method: str, results_q) -> None:
    """Phase 6's CPU side under ``method``, in a process of its own beside
    the card's runs: the small lane on the CPU in a directory of its own.
    Puts its seconds, counts and files (or the error) on ``results_q``."""
    import traceback

    try:
        lib = _small_library()
        root = os.path.join(WORK, f"small_cpu_{method}")
        _write_lane(root, lib)
        t0 = time.perf_counter()
        got = _run_lane(root, {**SMALL_KNOBS, **POLISH[method]}, "cpu")
        results_q.put({"method": method, "cpu_s": time.perf_counter() - t0,
                       "counts": got.get("barcode01"), "tree": _artifacts(root)})
    except BaseException:
        results_q.put({"method": method, "error": traceback.format_exc()})


def _small_cuda(method: str) -> dict:
    """Phase 6's card side under ``method``: the small lane on ``cuda``
    and, under ``rnn``, again under the imperative executor, which must
    write the graph run's files."""
    import torch

    lib = _small_library()
    root = os.path.join(WORK, f"small_{method}")
    _write_lane(root, lib)
    knobs = {**SMALL_KNOBS, **POLISH[method]}
    t0 = time.perf_counter()
    runs = [("cuda", _run_lane(root, knobs, "cuda"))]
    torch.cuda.synchronize()
    out = {"cuda_s": time.perf_counter() - t0, "tree": _artifacts(root), "imperative_s": None}
    if method == "rnn":
        t0 = time.perf_counter()
        runs.append(("cuda, imperative",
                     _run_lane(root, {**knobs, "executor": "imperative"}, "cuda")))
        torch.cuda.synchronize()
        out["imperative_s"] = time.perf_counter() - t0
        art_imp, art_cuda = _artifacts(root), out["tree"]
        if sorted(art_imp) != sorted(art_cuda):
            raise AssertionError(f"small e2e: the file sets differ between the executors: "
                                 f"{sorted(set(art_imp) ^ set(art_cuda))}")
        for rel in sorted(set(art_cuda) - set(TIMED_FILES)):
            if art_imp[rel] != art_cuda[rel]:
                raise AssertionError(f"small e2e: {rel} differs between the graph and the "
                                     "imperative executor")
    for dev, got in runs:
        if got.get("barcode01") != lib.true_counts:
            raise AssertionError(f"small e2e ({method}) on {dev}: counts "
                                 f"{got.get('barcode01')} != truth {lib.true_counts}")
    return out


def small_e2e(trees: dict) -> list[dict]:
    """Phase 6: see the module docstring. The CPU sides run in processes
    of their own, started first, beside the card's runs. ``trees``
    receives each method's cuda files (phases 9, 11 and 12 hold runs to
    them)."""
    import multiprocessing
    import queue

    lib = _small_library()
    ctx = multiprocessing.get_context("spawn")
    results_q = ctx.Queue()
    procs = [ctx.Process(target=_small_cpu, args=(method, results_q), daemon=True)
             for method in POLISH]
    cpu: dict[str, dict] = {}
    try:
        for proc in procs:
            proc.start()
        cuda = {method: _small_cuda(method) for method in POLISH}
        for _ in procs:
            try:
                res = results_q.get(timeout=900)
            except queue.Empty:
                raise AssertionError("small e2e: a CPU side gave no result") from None
            if "error" in res:
                raise AssertionError(f"small e2e ({res['method']}): the CPU side failed:\n"
                                     f"{res['error']}")
            cpu[res["method"]] = res
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    out = []
    for method in POLISH:
        art_cuda, art_cpu = cuda[method]["tree"], cpu[method]["tree"]
        if sorted(art_cuda) != sorted(art_cpu):
            raise AssertionError(f"small e2e ({method}): the file sets differ between cuda and "
                                 f"cpu: {sorted(set(art_cuda) ^ set(art_cpu))}")
        for rel in sorted(set(art_cuda) - set(TIMED_FILES)):
            if art_cuda[rel] != art_cpu[rel]:
                raise AssertionError(f"small e2e ({method}): {rel} differs between cuda and cpu")
        if _stage_names(art_cuda) != _stage_names(art_cpu):
            raise AssertionError(f"small e2e ({method}): stage names differ between cuda and cpu")
        obs = _compare_obs(art_cuda, art_cpu, f"small e2e ({method})")
        if cpu[method]["counts"] != lib.true_counts:
            raise AssertionError(f"small e2e ({method}) on cpu: counts "
                                 f"{cpu[method]['counts']} != truth {lib.true_counts}")
        trees[method] = art_cuda
        out.append({"polish": method, "n_reads": len(lib.reads),
                    "cuda_s": cuda[method]["cuda_s"], "cpu_s": cpu[method]["cpu_s"],
                    "imperative_s": cuda[method]["imperative_s"],
                    "files_compared": len(art_cuda) - len(TIMED_FILES),
                    "artifacts_identical": True, "counts_exact": True, "obs": obs})
    return out


# the CLI in a subprocess (--report, --validate): its exit code and whether
# torch was loaded
_CLI_PROBE = r"""
import runpy, sys
sys.argv = ["ont_tcrconsensus_tpu_torch", *sys.argv[1:]]
try:
    runpy.run_module("ont_tcrconsensus_tpu_torch", run_name="__main__")
    rc = 0
except SystemExit as exc:
    rc = exc.code or 0
loaded = any(m == "torch" or m.startswith("torch.") for m in sys.modules)
sys.stderr.write(f"TORCH_LOADED={loaded}\n")
sys.exit(rc)
"""


def _cli_probe(*args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", _CLI_PROBE, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)


def _poll_live(polled: dict, stop) -> None:
    """Read /healthz and /metrics of the run's live plane once each, as
    soon as it serves, and /progress until it names the graph node the run
    is in (its per-node position)."""
    import urllib.request

    from ont_tcrconsensus_tpu_torch.obs import live as obs_live

    while not stop.is_set() and (len(polled) < 3 or polled["/progress"].get("node") is None):
        srv = obs_live.server()
        if srv is not None:
            for route in ("/healthz", "/metrics", "/progress"):
                if route in polled and (route != "/progress" or polled[route].get("node")):
                    continue
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{route}",
                                                timeout=5) as resp:
                        body = resp.read()
                        polled[route] = {"status": resp.status, "bytes": len(body)}
                        if route == "/progress":
                            doc = json.loads(body)
                            polled[route].update(node=doc.get("node"),
                                                 nodes_total=doc.get("nodes_total"))
                except OSError:
                    pass
        time.sleep(0.01)


def observation_phase() -> dict:
    """The small lane under ``rnn`` with every observation knob on; see the
    module docstring (phase 7)."""
    import threading

    import torch


    lib = _small_library()
    root = os.path.join(WORK, "obs")
    _write_lane(root, lib)
    prof_dir = os.path.join(root, "profile")
    knobs = {**SMALL_KNOBS, "telemetry": "full", "profile_trace_dir": prof_dir, "live_port": 0,
             "stage_timeout_s": 600}
    polled: dict = {}
    stop = threading.Event()
    poller = threading.Thread(target=_poll_live, args=(polled, stop), daemon=True)
    poller.start()
    t0 = time.perf_counter()
    try:
        got = _run_lane(root, knobs, "cuda")
        torch.cuda.synchronize()
    finally:
        stop.set()
        poller.join(timeout=10)
    run_s = time.perf_counter() - t0
    if got.get("barcode01") != lib.true_counts:
        raise AssertionError(f"observation: counts {got.get('barcode01')} != the truth")
    if sorted(polled) != ["/healthz", "/metrics", "/progress"] or any(
            r["status"] != 200 for r in polled.values()):
        raise AssertionError(f"observation: the live plane answered {polled}")
    if polled["/progress"].get("node") is None or not polled["/progress"].get("nodes_total"):
        raise AssertionError(f"observation: /progress never named a graph node: {polled}")
    tree = _artifacts(root)
    nano = os.path.join(root, "fastq_pass", "nano_tcr")
    # every stage of the table has its span: the main thread's, or for a
    # worker stage (*_bg) a worker's row
    trace = json.loads(tree["logs/trace.json"])
    rows = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    spans = collections.defaultdict(set)
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            spans[e["name"]].add("worker" if rows[e["tid"]].startswith("stage-")
                                 else rows[e["tid"]])
    table = _stage_names(tree)
    missing = [name for name in table if spans.get(name) != (
        {"worker"} if name.endswith("_bg") else {"MainThread"})]
    if missing or not any(n.endswith("_bg") for n in table):
        raise AssertionError(f"observation: stages without their span on their row: {missing}")
    # the whole-run profiler trace names the six kernels
    (prof_name,) = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(prof_dir, prof_name), "rb") as fh:
        raw = fh.read()
    kernels_named = {k: k.encode() in raw for k in ("sw_banded_kernel", "pileup_forward_kernel",
                                                     "pileup_traceback_kernel",
                                                     "error_profile_cs_kernel",
                                                     "fuzzy_match_kernel", "dovetail_kernel")}
    if not all(kernels_named.values()):
        raise AssertionError(f"observation: the profiler trace lacks a kernel: {kernels_named}")
    rep = _cli_probe("--report", os.path.dirname(nano))
    if rep.returncode != 0 or "TORCH_LOADED=False" not in rep.stderr:
        raise AssertionError(f"observation: --report rc {rep.returncode}: {rep.stderr[-2000:]}")
    report = json.loads(tree["robustness_report.json"])
    stalls = [e for e in report["events"] if e["site"] == "watchdog.stall"]
    if stalls:
        raise AssertionError(f"observation: watchdog events in a healthy run: {stalls}")
    tel = json.loads(tree["telemetry.json"])
    if tel["trace_json"] != "logs/trace.json" or DEVICE_GAUGE not in tel["gauges"]:
        raise AssertionError("observation: telemetry.json lacks its trace or the device gauge")
    return {"n_reads": len(lib.reads), "run_s": run_s, "live": polled,
            "stages": table, "trace_events": len(trace["traceEvents"]),
            "trace_bytes": len(tree["logs/trace.json"]),
            "profiler_trace_bytes": len(raw), "profiler_trace_events": raw.count(b'"ph":'),
            "profiler_kernels_named": kernels_named, "report_lines": len(rep.stdout.splitlines()),
            "compile": tel["compile"], "hbm_high_water_bytes": tel["gauges"][DEVICE_GAUGE],
            "dispatch": tel["dispatch"]}


# the robustness drills' config: the small lane under the cheap polish,
# with no back-off between retries
DRILL_KNOBS = {**SMALL_KNOBS, "polish_method": "poa", "retry_base_delay_s": 0.0}
# three malformed blocks spliced between the library's records
CORRUPT_INPUT = [{"site": "ingest.library_fastq", "kind": "corrupt-input"}]
DRILL_FILES = ("counts/umi_consensus_counts.csv", "fasta/merged_consensus.fasta")


def _drill_files(root: str, library: str = "barcode01") -> dict[str, bytes]:
    out = {}
    for rel in DRILL_FILES:
        with open(os.path.join(root, "fastq_pass", "nano_tcr", library, rel), "rb") as fh:
            out[rel] = fh.read()
    return out


def _drill_events(root: str) -> list[tuple[str, str, str]]:
    with open(os.path.join(root, "fastq_pass", "nano_tcr", "robustness_report.json")) as fh:
        report = json.load(fh)
    return [(e["site"], e["classification"], e["outcome"]) for e in report["events"]]


def _drill_stages(root: str) -> dict:
    path = os.path.join(root, "fastq_pass", "nano_tcr", "barcode01", "stage_manifest.json")
    with open(path) as fh:
        data = json.load(fh)
    return data.get("stages", data)


def _drill_cli(root: str, knobs: dict) -> subprocess.CompletedProcess:
    """The port's CLI on the card in a process of its own (a kill or a
    preemption ends that process, not this one)."""
    shutil.rmtree(os.path.join(root, "fastq_pass", "nano_tcr"), ignore_errors=True)
    cfg = os.path.join(root, "drill_config.json")
    with open(cfg, "w") as fh:
        json.dump({"reference_file": os.path.join(root, "reference.fa"),
                   "fastq_pass_dir": os.path.join(root, "fastq_pass"),
                   "delete_tmp_files": False, **knobs}, fh)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TCR_CHAOS")}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-m", "ont_tcrconsensus_tpu_torch", cfg],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)


def robustness_phase(undisturbed: dict[str, bytes]) -> dict:
    """Phase 9: the chaos drills on the card; see the module docstring.
    ``undisturbed`` is phase 6's cuda run of the small lane under ``poa``
    (the drills' knobs but the retry back-off, which writes nothing): every
    drill ends with its counts CSV and merged FASTA."""

    t_phase = time.perf_counter()
    lib = _small_library()
    root = os.path.join(WORK, "drills")
    _write_lane(root, lib)
    want = {rel: undisturbed[f"barcode01/{rel}"] for rel in DRILL_FILES}
    drills: dict[str, list] = {}

    def finish(name: str, got: dict, expect: tuple = ()) -> None:
        if got.get("barcode01") != lib.true_counts:
            raise AssertionError(f"drill {name}: counts {got.get('barcode01')} != the truth")
        if _drill_files(root) != want:
            raise AssertionError(f"drill {name}: the counts CSV or the merged FASTA differs "
                                 "from the undisturbed run's")
        events = _drill_events(root)
        missing = [e for e in expect if e not in events]
        if missing:
            raise AssertionError(f"drill {name}: no {missing} among the events {events}")
        drills[name] = events

    def failing(name: str, knobs: dict) -> str:
        try:
            _run_lane(root, knobs, "cuda")
        except RuntimeError as exc:
            return str(exc)
        raise AssertionError(f"drill {name}: the run did not fail")

    # in-run recovery
    for name, plan, expect in (
        ("transient at assign.dispatch and polish.dispatch",
         [{"site": "assign.dispatch", "kind": "transient"},
          {"site": "polish.dispatch", "kind": "transient"}],
         (("assign.round1", "transient", "retried"), ("assign.round1", "transient", "recovered"),
          ("polish.dispatch", "transient", "retried"),
          ("polish.dispatch", "transient", "recovered"))),
        ("oom at polish.dispatch", [{"site": "polish.dispatch", "kind": "oom"}],
         (("polish.dispatch", "oom", "oom_shrink"), ("polish.dispatch", "oom", "recovered"))),
        ("killed overlap.worker", [{"site": "overlap.worker", "kind": "transient"}],
         (("overlap.worker", "transient", "retried"),
          ("overlap.worker", "transient", "recovered"))),
    ):
        finish(name, _run_lane(root, {**DRILL_KNOBS, "chaos": plan}, "cuda"), expect)

    # graph.node is outside every retry wrapper (as in the JAX package): the
    # node fails its library, and resume completes it from the round-1
    # checkpoint (the fault fires at the 8th node, round2_umi_records)
    name = "transient at graph.node, then resume"
    msg = failing(name, {**DRILL_KNOBS, "chaos": [
        {"site": "graph.node", "kind": "transient", "skip": 7}]})
    done = _drill_stages(root)
    if "round1_consensus" not in done or "counts" in done or "barcode01" not in msg:
        raise AssertionError(f"drill {name}: {msg}; stages {sorted(done)}")
    finish(name, _run_lane(root, {**DRILL_KNOBS, "resume": True}, "cuda", fresh=False))

    # a truncated library beside a good one
    name = "truncate-file beside a good library"
    lib_dir = os.path.join(root, "fastq_pass", "barcode02")
    os.makedirs(lib_dir)
    shutil.copy(os.path.join(root, "fastq_pass", "barcode01", "barcode01.fastq.gz"),
                os.path.join(lib_dir, "barcode02.fastq.gz"))
    try:
        msg = failing(name, {**DRILL_KNOBS, "chaos": [
            {"site": "ingest.library_fastq", "kind": "truncate-file"}]})
        with open(os.path.join(root, "fastq_pass", "nano_tcr", "failed_libraries_p0.log")) as fh:
            failed = [ln.split("\t")[0] for ln in fh.read().splitlines()]
        if (not msg.startswith("1 library(ies) failed: ['barcode01']") or failed != ["barcode01"]
                or _drill_files(root, "barcode02") != want):
            raise AssertionError(f"drill {name}: {msg}; failed {failed}")
        drills[name] = _drill_events(root)
    finally:
        shutil.rmtree(lib_dir)
        for f in os.listdir(os.path.join(root, "fastq_pass", "barcode01")):
            if "chaos" in f:
                os.remove(os.path.join(root, "fastq_pass", "barcode01", f))

    # in a process of its own: a preemption and a kill at the round-1
    # checkpoint, each resumed here
    for name, kind, rc in (("preempt at run.round1_checkpoint, then resume", "preempt", 143),
                           ("kill at run.round1_checkpoint, then resume", "kill", 137)):
        proc = _drill_cli(root, {**DRILL_KNOBS, "chaos": [
            {"site": "run.round1_checkpoint", "kind": kind}]})
        done = _drill_stages(root)
        if proc.returncode != rc or "round1_consensus" not in done or "counts" in done:
            raise AssertionError(f"drill {name}: exit {proc.returncode} (want {rc}), stages "
                                 f"{sorted(done)}: {proc.stderr[-2000:]}")
        finish(name, _run_lane(root, {**DRILL_KNOBS, "resume": True}, "cuda", fresh=False))

    # a completed artifact rots before a resume that verifies it in full
    name = "corrupt-artifact under verify_resume full"
    finish(name, _run_lane(root, {**DRILL_KNOBS, "resume": True, "verify_resume": "full",
                                  "chaos": [{"site": "resume.verify",
                                             "kind": "corrupt-artifact"}]},
                           "cuda", fresh=False),
           (("resume.verify", "integrity", "rerun"),))

    # malformed records under on_bad_record drop: counted and reported,
    # written nowhere
    name = "corrupt-input under drop"
    finish(name, _run_lane(root, {**DRILL_KNOBS, "on_bad_record": "drop",
                                  "chaos": CORRUPT_INPUT}, "cuda"),
           (("ingest.quarantine", "data_fault", "dropped"),
            ("ingest.quarantine", "data_fault", "summary")))
    if os.path.exists(os.path.join(root, "fastq_pass", "nano_tcr", "barcode01",
                                   "quarantine.fastq.gz")):
        raise AssertionError(f"drill {name}: a quarantine file was written")
    return {"n_reads": len(lib.reads), "seconds": time.perf_counter() - t_phase,
            "drills": drills}


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


@contextlib.contextmanager
def _rollup_clock(stats: dict):
    """While the block runs, add the host-clock seconds of the run's
    telemetry roll-up (the memory peaks, telemetry.json, the history
    entry) to ``stats["s"]`` (the module functions the run calls are
    wrapped; what they write is untouched)."""
    from ont_tcrconsensus_tpu_torch.obs import device, history, report

    wrapped = [(device, "finalize_memory"), (report, "write_run_telemetry"),
               (history, "record_run")]
    originals = [getattr(mod, name) for mod, name in wrapped]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stats["s"] += time.perf_counter() - t0
        return call

    for (mod, name), fn in zip(wrapped, originals):
        setattr(mod, name, timed(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(wrapped, originals):
            setattr(mod, name, fn)


@contextlib.contextmanager
def _traced_stage(name: str, out: dict):
    """While the block runs, trace the run's first ``name`` stage window
    with ``torch.profiler`` (CUDA activity, every thread's streams): ``out``
    gets the window's wall milliseconds (the profiler running), the device
    milliseconds and events in it (:func:`_busy`) and their ratio, the
    card's busy share there (the StageTimer method the run calls is
    wrapped; the stage's work is untouched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ont_tcrconsensus_tpu_torch.qc import timing

    real = timing.StageTimer.stage

    @contextlib.contextmanager
    def stage(self, stage_name):
        if stage_name != name or out:
            with real(self, stage_name):
                yield
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with real(self, stage_name):
                yield
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        busy = _busy(prof)
        out.update(window_ms=window_ms, **busy, busy_share=busy["device_ms"] / window_ms)

    timing.StageTimer.stage = stage
    try:
        yield
    finally:
        timing.StageTimer.stage = real


# the threads of the host/device overlaps: assign's prefetch worker and
# readback thread, polish's pack worker; none may outlive a run
OVERLAP_THREADS = ("assign-prefetch", "assign-readback", "polish-pack")


def _overlap_threads() -> dict[str, int]:
    """The live threads of :data:`OVERLAP_THREADS`, by name prefix."""
    import threading

    names = [t.name for t in threading.enumerate()]
    return {p: sum(n.startswith(p) for n in names) for p in OVERLAP_THREADS}


# the counters the run's plants add to, one a call
PLANT_COUNTERS = ("assign.batches", "cluster.batched", "polish.chunks")


def plant_cost(dev, reps: int = 5000) -> dict:
    """Microseconds one call of each telemetry plant takes armed and
    disarmed on this host: a dispatch scope, a readback through
    ``timed_get`` (of a small tensor on ``dev``, whose copy is made
    either way), a stage span, a counter and a histogram sample. Medians
    of 5 blocks of ``reps`` calls."""
    import torch

    from ont_tcrconsensus_tpu_torch.obs import device as obs_device, metrics, trace

    x = torch.arange(256, dtype=torch.int32, device=dev)

    def scope():
        with obs_device.dispatch("polish.dispatch"):
            pass

    def span():
        with trace.span("round1_polish"):
            pass

    plants = {"dispatch": scope, "get": lambda: obs_device.timed_get("polisher.get", x),
              "span": span, "counter": lambda: metrics.counter_add("polish.chunks"),
              "sample": lambda: metrics.observe("polish.chunk_clusters", 8)}
    out = {}
    for name, fn in plants.items():
        us = {}
        for armed in (False, True):
            if armed:
                metrics.arm()
            try:
                fn()
                blocks = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    blocks.append((time.perf_counter() - t0) / reps * 1e6)
                us["on" if armed else "off"] = float(np.median(blocks))
            finally:
                if armed:
                    metrics.disarm()
        out[name] = {**us, "added": max(us["on"] - us["off"], 0.0)}
    return out


def plant_calls(tel: dict) -> dict:
    """The plant calls of one run, from its telemetry.json."""
    return {"dispatch": sum(d["dispatches"] for d in tel["dispatch"].values()),
            "get": sum(d["gets"] for d in tel["dispatch"].values()),
            "span": sum(s["calls"] for s in tel["stages"].values()),
            "counter": int(sum(tel["counters"].get(k, 0) for k in PLANT_COUNTERS)),
            "sample": sum(h["count"] for h in tel["histograms"].values())}


# the full lane's knobs (its default config otherwise)
FULL_KNOBS = {"minimal_length": 1000, "min_reads_per_cluster": 4, "read_batch_size": 1024}
# the lanes' runs: the default config (rnn polish, QC profiles on the
# overlapped worker, telemetry on), the same without the error profiles,
# with them on the main thread and without telemetry, and the vote
# consensus alone
LANE_RUNS = {**POLISH, "rnn, error_profile_sample 0": {"error_profile_sample": 0},
             "rnn, overlap_qc false": {"overlap_qc": False},
             "rnn, executor imperative": {"executor": "imperative"},
             "rnn, telemetry off": {"telemetry": "off"}}


def full_e2e(kernels, rounds: int, step_ns: float):
    """The full lane under the default config, then, on the small lane,
    ``rounds`` times in turns the default config without the error
    profiles, with them on the main thread, under the imperative order, as
    it is and without telemetry, then once under ``poa``.
    Kernel launches are counted over the first run (recorded by shape for
    :func:`launch_gaps`, :func:`traceback_gaps`, whose walk floor takes
    ``step_ns`` a step, and :func:`cs_gaps`), over the ``poa``
    run and over the run without the error profiles, each from zero. Each
    default run's telemetry.json is read back and its roll-up timed.
    Returns the numbers and the full lane's simulated library (its first
    run's output stays in ``build/chip_smoke/lane_full`` for phase 10)."""
    import torch

    from ont_tcrconsensus_tpu_torch.io import simulator
    from ont_tcrconsensus_tpu_torch.obs import transfers as obs_transfers
    from ont_tcrconsensus_tpu_torch.ops import (dovetail_kernel, pileup, pileup_kernel, sw_kernel,
                                                traceback_kernel)
    from ont_tcrconsensus_tpu_torch.qc import error_profile

    dev = torch.device("cuda")
    # the off-main-path routes' counts, taken where their kernels launch
    route_counters = ((dovetail_kernel.dovetail_cuda, "launches_nw"),
                      (pileup_kernel.forward_planes_cuda, "launches_offs"),
                      (traceback_kernel.traceback_columns_cuda, "launches_offs"))
    recorded = {"sw": (sw_kernel, "align_banded_auto", _sw_shape, True),
                "pileup": (pileup, "forward_auto", _pileup_shape, True),
                "traceback": (pileup, "_forward_traceback", _traceback_shape, False),
                "cs": (error_profile, "cs_core_auto", _cs_shape, True)}
    shapes: dict = {}

    t0 = time.perf_counter()
    libs = {"full": simulator.simulate_library(
        seed=33, num_regions=56, molecules_per_region=(8, 14), reads_per_molecule=(12, 22),
        error_model=simulator.OntErrorModel(), with_adapters=True, num_similar_pairs=6,
        similar_divergence=0.01, num_negative_controls=2,
    ), "small": _small_library()}
    roots = {lane: os.path.join(WORK, f"lane_{lane}") for lane in libs}
    for lane, lib in libs.items():
        _write_lane(roots[lane], lib)
    data_s = time.perf_counter() - t0
    lane_knobs = {"full": FULL_KNOBS, "small": SMALL_KNOBS}
    methods = (["rnn"] + ["rnn, error_profile_sample 0", "rnn, overlap_qc false",
                          "rnn, executor imperative", "rnn", "rnn, telemetry off"] * rounds
               + ["poa"])
    lanes = ["full"] + ["small"] * (len(methods) - 1)
    seconds, stages, peaks, polisher_runs, launches, diffs = [], [], [], [], {}, {}
    threads: list[dict[str, int]] = []  # the overlaps' live threads after each run
    no_profile: dict[str, int] = {}  # launches of the run without the error profiles
    telemetry: dict[int, dict] = {}
    ingest: dict[str, int] = {}  # run 0's read batches by ingest path
    for run, (lane, method) in enumerate(zip(lanes, methods)):
        root, lib = roots[lane], libs[lane]
        # each path's launches, from zero
        counted = run == 0 or method in ("poa", "rnn, error_profile_sample 0")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if counted:
            for k in kernels:
                k.launches = 0
        for k, route in route_counters:
            setattr(k, route, 0)
        stage_s: dict[str, float] = {}
        pol = {"s": 0.0, "peak_gb": None}
        rollup = {"s": 0.0}
        with contextlib.ExitStack() as stack:
            if run == 0:
                shapes = {key: stack.enter_context(_launch_shapes(module, name, shape_of, keep))
                          for key, (module, name, shape_of, keep) in recorded.items()}
                stack.enter_context(_ingest_batches(ingest))
            stack.enter_context(_polisher_clock(pol))
            stack.enter_context(_rollup_clock(rollup))
            t0 = time.perf_counter()
            got = _run_lane(root, {**lane_knobs[lane], **LANE_RUNS[method]}, "cuda",
                            timings=stage_s)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        threads.append(_overlap_threads())
        if any(threads[-1].values()):
            raise AssertionError(f"full e2e run {run}: threads outlived the run: {threads[-1]}")
        if method == "rnn, executor imperative":
            with open(os.path.join(root, "fastq_pass", "nano_tcr", "telemetry.json")) as fh:
                if "graph" in json.load(fh):
                    raise AssertionError(f"full e2e run {run}: executor imperative ran the "
                                         "graph executor")
        if method == "rnn":
            with open(os.path.join(root, "fastq_pass", "nano_tcr", "telemetry.json")) as fh:
                tel = json.load(fh)
            if "graph" not in tel:
                raise AssertionError(f"full e2e run {run}: the default config did not run "
                                     "the graph executor")
            memory = obs_transfers.analyze_memory(tel)
            telemetry[run] = {
                "dispatch": tel["dispatch"], "compile": tel["compile"],
                "hbm_high_water_bytes": tel["gauges"].get(DEVICE_GAUGE),
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "stages": {k: v["seconds"] for k, v in tel["stages"].items()},
                "plant_calls": plant_calls(tel), "rollup_s": rollup["s"],
                "graph_nodes_run": sorted(n for n, g in tel["graph"]["nodes"].items()
                                          if g.get("runs")),
                "graftcheck": tel["analysis"]["graftcheck"],
                "donation": {e: d["verdict"]
                             for e, d in tel["transfers"].get("donation", {}).items()},
                "memory": {"nodes": memory["nodes"], "problems": memory["problems"]}}
        stages.append(stage_s)
        polisher_runs.append(pol)
        if run == 0:
            routes = {f"{k.__name__}.{route}": getattr(k, route) for k, route in route_counters}
        if method == "rnn, error_profile_sample 0":
            no_profile = {k.__name__: k.launches for k in kernels}
        elif counted:
            launches[method] = {k.__name__: k.launches for k in kernels}
        counts = got.get("barcode01") or {}
        diffs.update({f"run {run} ({lane} lane, {method}): {k}": (counts.get(k, 0), lib.true_counts.get(k, 0))
                      for k in set(counts) | set(lib.true_counts)
                      if counts.get(k, 0) != lib.true_counts.get(k, 0)})
    # the full lane once more, in a directory of its own (run 0's output
    # stays for phase 10), its round-1 assign window traced
    traced_root = os.path.join(WORK, "lane_full_traced")
    shutil.rmtree(traced_root, ignore_errors=True)
    shutil.copytree(roots["full"], traced_root,
                    ignore=lambda d, names: ["nano_tcr"] if "nano_tcr" in names else [])
    assign_window: dict = {}
    with _traced_stage("round1_fused_assign", assign_window):
        traced = _run_lane(traced_root, {**FULL_KNOBS, **LANE_RUNS["rnn"]}, "cuda")
    torch.cuda.synchronize()
    if (traced.get("barcode01") or {}) != libs["full"].true_counts or not assign_window:
        raise AssertionError("full e2e: the traced run's counts differ from the truth, or its "
                             "round1_fused_assign window was not traced")
    n_reads = [len(libs[lane].reads) for lane in lanes]
    out = {"n_reads": len(libs["full"].reads), "n_regions": len(libs["full"].reference),
           "small_n_reads": len(libs["small"].reads),
           "lane": lanes, "polish": methods,
           "seconds": seconds, "reads_per_s": [n / s for n, s in zip(n_reads, seconds)],
           "counts_exact": not diffs,
           "max_memory_allocated_gb": peaks, "polisher": polisher_runs,
           "data_s": data_s, "launches": launches, "launches_no_profile": no_profile,
           "launches_nw": routes["dovetail_cuda.launches_nw"],
           "launches_with_offsets": {k: n for k, n in routes.items() if k.endswith("_offs")},
           "stage_s": stages,
           "telemetry": telemetry, "ingest_batches": ingest,
           "overlap_threads": threads, "assign_window": assign_window,
           "launch_gaps": {
               "sw": launch_gaps(shapes["sw"], sw_kernel.align_banded_cuda, _sw_costs, dev),
               "pileup": launch_gaps(shapes["pileup"], pileup_kernel.forward_planes_cuda,
                                     _pileup_costs, dev),
               "traceback": traceback_gaps(shapes["traceback"], shapes["pileup"], step_ns,
                                           dev),
               "cs": cs_gaps(shapes["cs"], dev)}}
    if diffs:
        out["count_diffs"] = diffs
    return out, libs["full"]


def ingest_phase(lib, clean: dict, kernels) -> dict:
    """Phase 10: ingest validation on the card; see the module docstring.
    ``clean`` is phase 8's numbers (the full lane's first run is its
    clean run, its output still in place)."""
    import gzip
    import importlib.util

    import torch

    from ont_tcrconsensus_tpu_torch.io import fastx, validate
    from ont_tcrconsensus_tpu_torch.robustness import faults

    t_phase = time.perf_counter()
    full_root = os.path.join(WORK, "lane_full")
    root = os.path.join(WORK, "ingest_full")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "fastq_pass", "barcode01"))
    shutil.copy(os.path.join(full_root, "reference.fa"), root)
    lane_fastq = os.path.join("fastq_pass", "barcode01", "barcode01.fastq.gz")
    shutil.copy(os.path.join(full_root, lane_fastq), os.path.join(root, lane_fastq))

    # the full lane under quarantine with three malformed blocks spliced in
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    stage_s: dict[str, float] = {}
    t0 = time.perf_counter()
    got = _run_lane(root, {**FULL_KNOBS, "on_bad_record": "quarantine",
                           "contracts": "strict", "chaos": CORRUPT_INPUT},
                    "cuda", timings=stage_s)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    if got.get("barcode01") != lib.true_counts:
        raise AssertionError(f"ingest: counts under quarantine {got.get('barcode01')} != the "
                             "truth")
    if launches != clean["launches"]["rnn"]:
        raise AssertionError(f"ingest: launches under quarantine {launches} != the clean "
                             f"run's {clean['launches']['rnn']}")
    tree, clean_tree = _artifacts(root), _artifacts(full_root)
    skip = set(TIMED_FILES) | set(INGEST_DIFFERS)
    only = sorted((set(tree) ^ set(clean_tree)) - skip)
    differ = sorted(rel for rel in set(tree) & set(clean_tree) - skip
                    if tree[rel] != clean_tree[rel])
    if only or differ:
        raise AssertionError(f"ingest: files of the quarantine run differ from the clean "
                             f"run's: only on one side {only}, differing {differ}")
    report = json.loads(tree["robustness_report.json"])
    events = [e for e in report["events"] if e["site"] == "ingest.quarantine"]
    bad = [e for e in events if e["outcome"] == "quarantined"]
    summary = [e for e in events if e["outcome"] == "summary"]
    reasons = {validate.R_GZIP, validate.R_NOT_FASTX, validate.R_BAD_HEADER,
               validate.R_MISSING_PLUS, validate.R_LEN_MISMATCH, validate.R_BAD_QUAL,
               validate.R_TRUNCATED}
    if (len(bad) < 3 or len(summary) != 1 or len(events) != len(bad) + 1
            or any(e["detail"]["reason"] not in reasons for e in bad)):
        raise AssertionError(f"ingest: the report's ingest events are wrong: {events}")
    contracts = report["contracts"]
    if contracts["mode"] != "strict" or contracts["violated"]:
        raise AssertionError(f"ingest: contracts {contracts}")
    # the quarantine file holds exactly the spliced blocks: cut at the
    # events' offsets from the corrupted copy, they leave the clean lane
    quarantined = gzip.decompress(tree["barcode01/quarantine.fastq.gz"])
    with open(os.path.join(root, "fastq_pass", "barcode01",
                           "barcode01.chaos-corrupt.gz"), "rb") as fh:
        corrupted = gzip.decompress(fh.read())
    with open(os.path.join(root, lane_fastq), "rb") as fh:
        original = gzip.decompress(fh.read())
    spans = [(e["detail"]["offset"], e["detail"]["offset"] + e["detail"]["bytes"])
             for e in bad]
    blocks = [corrupted[a:b] for a, b in spans]
    rest = b"".join(corrupted[a:b] for a, b in zip([0] + [e for _, e in spans],
                                                    [s for s, _ in spans] + [None]))
    if (b"".join(blocks) != quarantined or rest != original
            or any(b not in faults._CORRUPT_BLOCKS for b in blocks)):
        raise AssertionError("ingest: quarantine.fastq.gz does not hold exactly the "
                             f"spliced blocks: {[b[:40] for b in blocks]}")
    # what the run's round1_fused_assign spends on the host beside the
    # clean run's: the drill's rewrite of the corrupted copy (the graph
    # node times it) and the tolerant parse against the strict one
    host_s = {}
    t0 = time.perf_counter()
    gzip.compress(corrupted)
    host_s["drill_recompress"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    validate.parse_path_tolerant(os.path.join(root, "fastq_pass", "barcode01",
                                              "barcode01.chaos-corrupt.gz"))
    host_s["tolerant_parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sum(1 for _ in fastx.read_fastx(os.path.join(root, lane_fastq)))
    host_s["strict_parse"] = time.perf_counter() - t0

    # --validate in processes of their own: the full lane's config, and a
    # copy of the lane with the corrupted file under a name input
    # discovery finds
    cfgs = {}
    for name, lane_root in (("clean", full_root), ("spliced", os.path.join(WORK, "ingest_v"))):
        if name == "spliced":
            shutil.rmtree(lane_root, ignore_errors=True)
            os.makedirs(os.path.join(lane_root, "fastq_pass", "barcode01"))
            shutil.copy(os.path.join(full_root, "reference.fa"), lane_root)
            with gzip.open(os.path.join(lane_root, lane_fastq), "wb") as fh:
                fh.write(corrupted)
        cfgs[name] = os.path.join(lane_root, "validate_config.json")
        with open(cfgs[name], "w") as fh:
            json.dump({"reference_file": os.path.join(lane_root, "reference.fa"),
                       "fastq_pass_dir": os.path.join(lane_root, "fastq_pass"),
                       **FULL_KNOBS}, fh)
    checks = {}
    for name, want_rc in (("clean", 0), ("spliced", 1)):
        t0 = time.perf_counter()
        proc = _cli_probe(cfgs[name], "--validate")
        checks[name] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                        "torch_loaded": "TORCH_LOADED=False" not in proc.stderr,
                        "line": (proc.stdout.strip().splitlines() or [""])[-1],
                        "problems": [ln for ln in proc.stdout.splitlines()
                                     if ln.startswith("PROBLEM")]}
        if proc.returncode != want_rc or checks[name]["torch_loaded"]:
            raise AssertionError(f"ingest: --validate ({name}) rc {proc.returncode}, want "
                                 f"{want_rc}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    first = bad[0]["detail"]
    if checks["clean"]["line"] != (f"validate: OK (1 input file(s), {len(lib.reads)} "
                                   "records)"):
        raise AssertionError(f"ingest: --validate on the clean lane: {checks['clean']}")
    want = (f"{len(bad)} malformed record(s); first at byte offset {first['offset']}: "
            f"{first['reason']}")
    if not any(want in p for p in checks["spliced"]["problems"]):
        raise AssertionError(f"ingest: --validate on the spliced lane does not name "
                             f"{want!r}: {checks['spliced']}")

    # the analysis verb on the full lane's first run
    analysis = {"run": importlib.util.find_spec("matplotlib") is not None}
    if analysis["run"]:
        nano = os.path.join(full_root, "fastq_pass", "nano_tcr")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ont_tcrconsensus_tpu_torch.qc.analysis_cli", nano,
             os.path.join(full_root, "reference.fa")],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
            env={**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                 "PYTHONPATH": ROOT, "MPLCONFIGDIR": os.path.join(WORK, "matplotlib")})
        if proc.returncode != 0:
            raise AssertionError(f"ingest: the analysis verb failed: {proc.stderr[-2000:]}")
        summaries = json.loads(proc.stdout)
        analysis.update(s=time.perf_counter() - t0, summary=summaries,
                        outs=sorted(os.listdir(os.path.join(nano, "barcode01", "outs"))))
    else:
        analysis["why"] = "matplotlib does not import on this host"
    return {"n_reads": len(lib.reads), "run_s": run_s, "reads_per_s": len(lib.reads) / run_s,
            "clean_s": clean["seconds"][0], "clean_reads_per_s": clean["reads_per_s"][0],
            "launches": launches, "stage_s": stage_s, "host_s": host_s,
            "files_compared": len(set(tree) & set(clean_tree) - skip),
            "events": [(e["outcome"], e["detail"].get("reason"), e["detail"].get("offset"))
                       for e in events],
            "quarantine_bytes": len(quarantined), "contracts_checked": contracts["checked"],
            "validate": checks, "analysis": analysis,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase 11: the data mesh and multi-process distribution

# files the mesh moves at a data axis above 1: round 1's fast path picks
# the reads it aligns per slice, so the reads its error profile samples
# carry other spans (tests/test_torch_mesh_e2e.py holds this to the JAX
# package, whose sharded and unsharded runs differ in it the same way)
MESH_DIFFERS = ("barcode01/logs/barcode01_align_error_profile.log",)
# kernels no sharded call launches: kernel B4 (no QC error profile is
# sharded, as in the JAX package)
UNSHARDED = ("error_profile_cs_cuda",)
PER_PROCESS = ("robustness_report_p{}.json", "telemetry_p{}.json", "history_p{}.jsonl",
               "stack_dumps_p{}.log")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _same_files(tree: dict, other: dict, label: str, but=()) -> int:
    """Every file of ``other`` under nano_tcr/ in ``tree`` byte for byte,
    but the files of timings and ``but``; the number compared."""
    if sorted(tree) != sorted(other):
        raise AssertionError(f"{label}: files differ: {sorted(set(tree) ^ set(other))}")
    skip = set(TIMED_FILES) | set(but)
    differ = [rel for rel in sorted(tree) if rel not in skip and tree[rel] != other[rel]]
    if differ:
        raise AssertionError(f"{label}: files differ byte for byte: {differ}")
    return len(set(tree) - skip)


def _sharded_kernels(dev, mesh_mod) -> dict:
    """B1, B2, B3 and B6 at main-path shapes split over a data=2 mesh of two
    slices of ONE card, against the unsplit launch: bit for bit."""
    import dataclasses

    import torch

    from ont_tcrconsensus_tpu_torch.io import dp_cases
    from ont_tcrconsensus_tpu_torch.ops import (edit_distance, pileup_kernel, sw_kernel,
                                                traceback_kernel)

    def sw_fields(*a, band_width):
        return dataclasses.astuple(sw_kernel.align_banded_cuda(*a, band_width=band_width))

    def traceback(best, planes, reads, band_width):
        return traceback_kernel.traceback_columns_cuda(best, planes, reads, band_width,
                                                       reads.shape[1])

    m = mesh_mod.make_mesh({"data": 2}, devices=[dev, dev])
    d1, d2 = mesh_mod.P("data"), mesh_mod.P("data", None)
    out = {}
    for key, (B, L, W), fn, specs, out_specs in (
        ("sw", (2048, 2048, 128), sw_fields, (d2, d1, d2, d1, d1), (d1,) * 7),
        ("pileup", (1024, 2048, 64), pileup_kernel.forward_planes_cuda, (d2, d1, d2, d1),
         (d2, d2)),
        ("traceback", (1024, 2048, 64), traceback, (d2, d2, d2), (d2,) * 5),
    ):
        args = [torch.from_numpy(x).to(dev) for x in
                dp_cases.dp_batch(B, L, W, 40, offsets=key == "sw")]
        if key == "traceback":  # B2's planes of the pileup case
            args = [*pileup_kernel.forward_planes_cuda(*args[:4], band_width=W), args[0]]
        args = args[:len(specs)]
        whole = fn(*args, band_width=W)
        sharded = mesh_mod.shard_map_compat(
            lambda *a, fn=fn, W=W: tuple(fn(*a, band_width=W)), m, in_specs=specs,
            out_specs=out_specs)
        split = sharded(*args)
        for i, (a, b) in enumerate(zip(whole, split)):
            if not torch.equal(a, b):
                raise AssertionError(f"mesh: {key} output {i} split over two slices differs "
                                     "from the unsplit launch")
        out[key] = {"shape": f"B={B} L={L} W={W}", "max_abs_err": 0,
                    "whole_ms": _time_ms(lambda: fn(*args, band_width=W), 5),
                    "split_ms": _time_ms(lambda: sharded(*args), 5)}
    # B6 on the shortlist's distance chunk, its pair axis split
    args = [torch.from_numpy(x).to(dev)
            for x in dp_cases.dovetail_case(40, DOVETAIL_PAIRS, DOVETAIL_L)]
    whole = edit_distance.pairwise_dovetail(*args)
    sharded = mesh_mod.shard_map_compat(edit_distance.pairwise_dovetail, m,
                                        in_specs=(d2, d1, d2, d1), out_specs=d1)
    if not torch.equal(whole, sharded(*args)):
        raise AssertionError("mesh: dovetail split over two slices differs from the unsplit "
                             "launch")
    out["dovetail"] = {"shape": f"{DOVETAIL_PAIRS} pairs L={DOVETAIL_L} k_end 8",
                       "max_abs_err": 0,
                       "whole_ms": _time_ms(lambda: edit_distance.pairwise_dovetail(*args), 5),
                       "split_ms": _time_ms(lambda: sharded(*args), 5)}
    return out


# the mesh drills' runs: phase 9's drill knobs without the QC error
# profiles (no profile is sharded; they kept the script inside its limit)
MESH_DRILL_KNOBS = {**DRILL_KNOBS, "error_profile_sample": 0}


def _mesh_drills(lib, kernels, mesh_mod) -> dict:
    """The small lane at data=2 over two slices of the card: undisturbed
    (launches counted from zero, in all and by slice), then a lost slice,
    one slice out of memory and a transient dispatch fault; each ends with
    the unsharded run's counts CSV and merged FASTA."""
    root = os.path.join(WORK, "mesh_drills")
    _write_lane(root, lib)
    if _run_lane(root, MESH_DRILL_KNOBS, "cuda").get("barcode01") != lib.true_counts:
        raise AssertionError("mesh drills: the unsharded run's counts differ from the truth")
    unsharded, want = _artifacts(root), _drill_files(root)
    mesh2 = {**MESH_DRILL_KNOBS, "mesh_shape": {"data": 2}}
    out = {}
    mesh_mod.install_slice_devices(["cuda:0", "cuda:0"])
    try:
        for name, plan in (
            ("no fault", None),
            ("mesh.device_lost", [{"site": "mesh.device_lost", "kind": "device-lost"}]),
            ("mesh.slice_oom", [{"site": "mesh.slice_oom", "kind": "oom"}]),
            ("mesh.dispatch transient", [{"site": "mesh.dispatch", "kind": "transient"}]),
        ):
            for k in kernels:
                k.launches = 0
                k.by_slice.clear()
            t0 = time.perf_counter()
            got = _run_lane(root, {**mesh2, **({"chaos": plan} if plan else {})}, "cuda")
            seconds = time.perf_counter() - t0
            launches = {k.__name__: (k.launches, dict(k.by_slice)) for k in kernels}
            if got.get("barcode01") != lib.true_counts or _drill_files(root) != want:
                raise AssertionError(f"mesh drill {name}: the counts CSV or the merged FASTA "
                                     "differs from the unsharded run's")
            events = _drill_events(root)
            with open(os.path.join(root, "fastq_pass", "nano_tcr", "telemetry.json")) as fh:
                tel = json.load(fh)
            with open(os.path.join(root, "fastq_pass", "nano_tcr", "robustness_report.json")) as fh:
                detail = [e.get("detail") for e in json.load(fh)["events"]
                          if e["site"] == "mesh.degraded"]
            busy = tel.get("mesh_slice_busy")
            if name == "no fault":
                _same_files(_artifacts(root), unsharded, "mesh drill no fault", MESH_DIFFERS)
                ok = (events == [] and busy == {"cuda:0": 1.0, "cuda:1": 1.0}
                      and all(sorted(by) == ["cuda:0", "cuda:1"]
                              for name, (_, by) in launches.items() if name not in UNSHARDED))
            elif name == "mesh.device_lost":
                ok = (detail == [{"node": "round1_polish", "data_from": 2, "data_to": 1}]
                      and ("polish.dispatch", "device_lost", "escalated") in events
                      and sorted(busy.values()) == [0.0, 1.0]
                      and tel["counters"].get("mesh.degraded") == 1)
            elif name == "mesh.slice_oom":
                ok = (("polish.dispatch", "oom", "oom_shrink") in events and not detail)
            else:
                ok = (any(e[2] == "retried" for e in events) and not detail)
            if not ok:
                raise AssertionError(f"mesh drill {name}: events {events}, degraded {detail}, "
                                     f"slice gauges {busy}")
            out[name] = {"events": events, "mesh_slice_busy": busy, "seconds": seconds,
                         "launches": launches}
    finally:
        mesh_mod.install_slice_devices(None)
    return out


def _two_processes(lib) -> dict:
    """Two CLI processes on the card, one gloo group, one library each,
    against one process running both libraries."""
    roots = {name: os.path.join(WORK, f"dist_{name}") for name in ("single", "multi")}
    for root in roots.values():
        _write_lane(root, lib)
        os.makedirs(os.path.join(root, "fastq_pass", "barcode02"))
        shutil.copy(os.path.join(root, "fastq_pass", "barcode01", "barcode01.fastq.gz"),
                    os.path.join(root, "fastq_pass", "barcode02", "barcode02.fastq.gz"))
    want = {"barcode01": lib.true_counts, "barcode02": lib.true_counts}
    t0 = time.perf_counter()
    if _run_lane(roots["single"], DRILL_KNOBS, "cuda") != want:
        raise AssertionError("two processes: the one-process run's counts differ from the truth")
    single_s = time.perf_counter() - t0
    cfg = os.path.join(roots["multi"], "dist_config.json")
    with open(cfg, "w") as fh:
        json.dump({"reference_file": os.path.join(roots["multi"], "reference.fa"),
                   "fastq_pass_dir": os.path.join(roots["multi"], "fastq_pass"),
                   "delete_tmp_files": False, "distributed": True, **DRILL_KNOBS}, fh)
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TCR_CHAOS")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ont_tcrconsensus_tpu_torch", cfg], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**base, "PYTHONPATH": ROOT, "TCR_CONSENSUS_DISTRIBUTED": "1",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": str(rank),
             "WORLD_SIZE": "2"}) for rank in range(2)]
    results = []
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=600)
            results.append({"rc": p.returncode, "s": time.perf_counter() - t0,
                            "owns": [ln for ln in err.splitlines() if " owns " in ln],
                            "err": err[-2000:]})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, r in enumerate(results):
        if r["rc"] != 0 or r["owns"] != [f"Process {rank}/2 owns 1 libraries"]:
            raise AssertionError(f"two processes: process {rank} exit {r['rc']}, "
                                 f"{r['owns']}: {r['err']}")
    multi, single = _artifacts(roots["multi"]), _artifacts(roots["single"])
    per_lib = {rel: b for rel, b in single.items() if "/" in rel}
    _same_files({rel: b for rel, b in multi.items() if "/" in rel}, per_lib,
                "two processes: the libraries' files",
                [rel.replace("barcode01", "barcode02") for rel in TIMED_FILES])
    top = sorted(rel for rel in multi if "/" not in rel)
    need = {f.format(i) for f in PER_PROCESS for i in (0, 1)}
    one_process = {"robustness_report.json", "telemetry.json", "history.jsonl"}
    if not need <= set(top) or one_process & set(top):
        raise AssertionError(f"two processes: per-process files {top}")
    return {"single_s": single_s, "process_s": [r["s"] for r in results],
            "owns": [r["owns"][0] for r in results], "files": top,
            "library_files_compared": len(per_lib)}


def mesh_phase(small: dict, small_tree: dict, kernels) -> dict:
    """Phase 11: the data mesh and multi-process distribution on the card;
    see the module docstring. ``small`` is phase 6's numbers of the small
    lane under ``rnn``, ``small_tree`` that run's files on cuda (the
    served full lane of phase 12 is the second run of the full lane, so
    the mesh run takes the small lane and the script stays inside its
    time limit)."""
    import torch

    from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    lib = _small_library()
    root = os.path.join(WORK, "mesh_small")
    _write_lane(root, lib)

    # the main path under the mesh, launches counted from zero
    for k in kernels:
        k.launches = 0
        k.by_slice.clear()
    stage_s: dict[str, float] = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = _run_lane(root, {**SMALL_KNOBS, "mesh_shape": {"data": n_cards}}, "cuda",
                    timings=stage_s)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    by_slice = {k.__name__: dict(k.by_slice) for k in kernels}
    if got.get("barcode01") != lib.true_counts:
        raise AssertionError(f"mesh: small lane counts differ from the truth: {got}")
    labels = [f"cuda:{i}" for i in range(n_cards)]
    if not all(launches.values()) or any(sorted(s) != labels for name, s in by_slice.items()
                                         if name not in UNSHARDED):
        raise AssertionError(f"mesh: a kernel did not launch on every slice: {by_slice}")
    if not _b3_follows_b2(launches):
        raise AssertionError(f"mesh: B3 did not follow every B2 launch: {launches}")
    compared = _same_files(_artifacts(root), small_tree, "mesh small lane",
                           MESH_DIFFERS if n_cards > 1 else ())
    with open(os.path.join(root, "fastq_pass", "nano_tcr", "telemetry.json")) as fh:
        busy = json.load(fh).get("mesh_slice_busy")
    with open(os.path.join(root, "fastq_pass", "nano_tcr", "history.jsonl")) as fh:
        mesh_config = json.loads(fh.readline()).get("mesh_config")
    if busy != {lbl: 1.0 for lbl in labels} or mesh_config != f"data={n_cards}":
        raise AssertionError(f"mesh: slice gauges {busy}, history mesh_config {mesh_config}")
    out = {"cards": n_cards, "n_reads": len(lib.reads), "run_s": run_s,
           "reads_per_s": len(lib.reads) / run_s, "clean_s": small["cuda_s"],
           "clean_reads_per_s": len(lib.reads) / small["cuda_s"], "launches": launches,
           "launches_by_slice": by_slice, "files_compared": compared, "stage_s": stage_s,
           "mesh_slice_busy": busy, "mesh_config": mesh_config}
    out["sharded_kernels"] = _sharded_kernels(dev, mesh_mod)
    out["drills"] = _mesh_drills(_small_library(), kernels, mesh_mod)
    out["processes"] = _two_processes(_small_library())
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 12: the warm-serving daemon


def _http_json(method: str, url: str, obj=None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as err:
        body = err.read().decode()
        return err.code, (json.loads(body) if body.startswith("{") else {"body": body})


def _wait_until(predicate, timeout: float, what: str, poll: float = 0.1):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"serve: timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(poll)


def _start_daemon(daemon):
    """Run ``daemon.serve_forever`` on a thread; returns (thread, outcome
    list: the exit code or the exception it raised)."""
    import threading

    outcome: list = []

    def target():
        try:
            outcome.append(daemon.serve_forever())
        except Exception as exc:  # the loop-crash drill's error, for the caller
            outcome.append(exc)

    thread = threading.Thread(target=target, name="chip-smoke-serve", daemon=True)
    thread.start()
    return thread, outcome


def _stop_daemon(daemon, thread, outcome, want=0) -> None:
    daemon.request_stop()
    thread.join(120)
    if thread.is_alive() or outcome != [want]:
        raise AssertionError(f"serve: the daemon did not stop with {want}: {outcome}")


def _jobs_url() -> str:
    from ont_tcrconsensus_tpu_torch.obs import live as obs_live

    _wait_until(lambda: obs_live.server() is not None, 60, "the live plane")
    return f"http://127.0.0.1:{obs_live.server().port}/jobs"


def _submit_and_wait(url: str, raw: dict, timeout: float = 600,
                     final=("done", "failed", "poisoned")) -> dict:
    status, snap = _http_json("POST", url, raw)
    if status != 202:
        raise AssertionError(f"serve: POST /jobs answered {status}: {snap}")
    job_url = f"{url}/{snap['id']}"
    _wait_until(lambda: _http_json("GET", job_url)[1].get("state") in final, timeout,
                f"{snap['id']}", poll=0.25)
    return _http_json("GET", job_url)[1]


# what a served job's telemetry may hold beyond a one-shot run's: the live
# plane's request counter (the jobs routes are polled while it runs) and
# the daemon's dispatch-to-first-stage latency, both in the job's registry
# (the JAX daemon's jobs have the same)
SERVE_PLANE_NAMES = {"counters": {"live.requests"}, "histograms": {"serve.first_stage_s"}}


def _top_keys(value: dict) -> dict:
    """A JSON object's keys two levels deep (the schema of the files of
    timings: their values are timings)."""
    return {k: sorted(v) if isinstance(v, dict) else type(v).__name__ for k, v in value.items()}


def _timed_schema(tree: dict, other: dict, label: str) -> None:
    """The files of timings of two runs of one lane by schema and names:
    telemetry.json's keys, the stage table's stage names, the manifest's
    stages, and the run entry of history.jsonl (a served job's history
    also holds its ``source: "serve"`` entry)."""
    tel = [json.loads(t["telemetry.json"]) for t in (tree, other)]
    hist = [[json.loads(ln) for ln in t["history.jsonl"].decode().splitlines()]
            for t in (tree, other)]
    stages = [sorted(json.loads(t[TIMED_FILES[0]]).get("stages", {})) for t in (tree, other)]
    problems = []
    keys = [_top_keys(t) for t in tel]
    for section, names in SERVE_PLANE_NAMES.items():
        extra = set(keys[0].get(section, ())) - set(keys[1].get(section, ()))
        if extra <= names:  # what the daemon's own plane planted during the job
            keys[0][section] = sorted(set(keys[0][section]) - extra)
    if keys[0] != keys[1]:
        problems.append("telemetry.json keys")
    if _stage_names(tree) != _stage_names(other):
        problems.append("stage_timing.tsv stage names")
    if stages[0] != stages[1]:
        problems.append("stage_manifest.json stages")
    runs = [[e for e in h if e["source"] == "run"] for h in hist]
    if (len(runs[0]) != 1 or len(runs[1]) != 1 or set(runs[0][0]) != set(runs[1][0])
            or runs[0][0]["fingerprint"] != runs[1][0]["fingerprint"]):
        problems.append("history.jsonl run entries")
    if problems:
        raise AssertionError(f"{label}: the files of timings differ in {problems}")


def _admission_bytes(cfg, budget) -> dict:
    """The byte figures the admission estimate weighs (serve/queue.py's
    arithmetic): the read pass at the job's read batch and one polish tile."""
    from ont_tcrconsensus_tpu_torch.io import bucketing

    width = bucketing.bucket_width(cfg.max_read_length) or cfg.max_read_length
    s_bucket = bucketing.pow2_ceil(max(cfg.max_reads_per_cluster, 1))
    return {"read_pass": budget.read_bytes(width, band_width=cfg.sw_band_width)
            * (cfg.read_batch_size or 128),
            "polish_tile": budget.cluster_bytes(s_bucket, width),
            "working_budget": budget.budget_bytes}


# the serve drills' jobs: phase 9's drill knobs without the QC error
# profiles, which the drills' counts CSV and merged FASTA do not read
SERVE_DRILL_KNOBS = {**DRILL_KNOBS, "error_profile_sample": 0}


def _serve_drills(lib, want: dict) -> tuple[dict, dict]:
    """The ladder, the loop crash and the SIGTERM drain on the small lane
    (``poa``, no QC profile), each in a daemon of its own: in process for
    the first three, then a ``serve`` process of its own, completed in
    process. ``want`` is phase 9's undisturbed counts CSV and merged
    FASTA. Returns the drills' numbers, and the transient drill's served
    job (its files and seconds), the packed pair's serial reference."""
    from ont_tcrconsensus_tpu_torch.robustness import faults
    from ont_tcrconsensus_tpu_torch.serve import daemon as daemon_mod
    from ont_tcrconsensus_tpu_torch.serve import queue as queue_mod

    out, serial = {}, {}
    for name, plan, final in (
        ("transient at serve.job_run", [{"site": "serve.job_run", "kind": "transient"}], "done"),
        ("fatal at serve.job_run", [{"site": "serve.job_run", "kind": "error"}], "poisoned"),
    ):
        root = os.path.join(WORK, "serve_drill")
        _write_lane(root, lib)
        state = os.path.join(WORK, "serve_drill_state")
        shutil.rmtree(state, ignore_errors=True)
        faults.arm(plan)  # the daemon-scope plan: TCR_CHAOS is not set here
        daemon = daemon_mod.Daemon(_lane_raw(root, SERVE_DRILL_KNOBS), port=0, state_dir=state,
                                   do_prewarm=False, device="cuda")
        thread, outcome = _start_daemon(daemon)
        t0 = time.perf_counter()
        snap = _submit_and_wait(_jobs_url(), _lane_raw(root, SERVE_DRILL_KNOBS))
        job = daemon.queue.job(snap["id"])
        _stop_daemon(daemon, thread, outcome)
        d = {"state": snap["state"], "attempts": job.attempts, "error": snap["error"],
             "seconds": time.perf_counter() - t0}
        if snap["state"] != final or job.attempts != 1:
            raise AssertionError(f"serve drill {name}: {d}")
        if final == "done":
            if _drill_files(root) != want:
                raise AssertionError(f"serve drill {name}: the counts CSV or the merged FASTA "
                                     "differs from the undisturbed run's")
            serial = {"tree": _artifacts(root), "job_s": snap["finished_t"] - snap["started_t"]}
        else:
            poison = queue_mod.load_poison(state)
            d["poison"] = [(e["id"], e["classification"]) for e in poison]
            if d["poison"] != [(snap["id"], "fatal")]:
                raise AssertionError(f"serve drill {name}: poison file {poison}")
        out[name] = d

    # the accept loop crashes between pop and dispatch: the popped job is
    # journaled and the flight recorder flushed under the exception's type
    name = "serve.daemon_loop crash"
    state = os.path.join(WORK, "serve_crash_state")
    shutil.rmtree(state, ignore_errors=True)
    faults.arm([{"site": "serve.daemon_loop", "kind": "error",
                 "message": "induced serve-loop crash"}])
    root = os.path.join(WORK, "serve_drill")
    daemon = daemon_mod.Daemon(_lane_raw(root, SERVE_DRILL_KNOBS), port=0, state_dir=state,
                               do_prewarm=False, device="cuda")
    thread, outcome = _start_daemon(daemon)
    status, snap = _http_json("POST", _jobs_url(), _lane_raw(root, SERVE_DRILL_KNOBS))
    thread.join(120)
    with open(queue_mod.journal_path(state)) as fh:
        journal = [(j["id"], j["state"]) for j in json.load(fh)["jobs"]]
    with open(os.path.join(state, "logs", "flight_recorder.json")) as fh:
        reason = json.load(fh)["reason"]
    crash = outcome[0] if outcome else None
    out[name] = {"raised": repr(crash), "journal": journal, "flight_recorder": reason}
    if (status != 202 or not isinstance(crash, RuntimeError)
            or journal != [(snap["id"], "requeued")] or reason != "serve_crash:RuntimeError"):
        raise AssertionError(f"serve drill {name}: {out[name]}")

    # a serve process on the card gets SIGTERM mid-job: exit 143 and the
    # journal; a restarted daemon completes the job
    name = "SIGTERM to a serve process, then restart"
    root = os.path.join(WORK, "serve_sigterm")
    _write_lane(root, lib)
    state = os.path.join(WORK, "serve_sigterm_state")
    shutil.rmtree(state, ignore_errors=True)
    template = os.path.join(root, "serve_template.json")
    with open(template, "w") as fh:
        json.dump(_lane_raw(root, SERVE_DRILL_KNOBS), fh)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TCR_CHAOS")}
    env["PYTHONPATH"] = ROOT
    log_path = os.path.join(WORK, "serve_sigterm.log")
    info = os.path.join(state, daemon_mod.SERVE_INFO_BASENAME)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ont_tcrconsensus_tpu_torch", "serve", template,
             "--port", "0", "--state-dir", state], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    d: dict = {}
    try:
        _wait_until(lambda: os.path.exists(info) or proc.poll() is not None, 300,
                    "serve_info.json", poll=0.05)
        d["cold_start_to_serve_info_s"] = time.perf_counter() - t0
        with open(info) as fh:
            url = f"http://127.0.0.1:{json.load(fh)['port']}/jobs"
        status, snap = _http_json("POST", url, _lane_raw(root, SERVE_DRILL_KNOBS))
        if status != 202:
            raise AssertionError(f"serve drill {name}: POST /jobs answered {status}: {snap}")
        job_url = f"{url}/{snap['id']}"
        _wait_until(lambda: _http_json("GET", job_url)[1].get("first_stage_s") is not None,
                    300, "the job's first stage", poll=0.05)
        listing = _http_json("GET", url)[1]
        d["warmup_s"] = listing["warmup_s"]
        d["prewarm_s"] = (listing.get("prewarm") or {}).get("seconds")
        d["first_stage_s"] = _http_json("GET", job_url)[1]["first_stage_s"]
        proc.send_signal(signal.SIGTERM)
        d["rc"] = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as fh:
        log_tail = fh.read()[-3000:]
    with open(queue_mod.journal_path(state)) as fh:
        d["journal"] = [(j["id"], j["state"], j["raw"].get("resume"))
                        for j in json.load(fh)["jobs"]]
    if d["rc"] != 143 or d["journal"] != [(snap["id"], "requeued", True)]:
        raise AssertionError(f"serve drill {name}: {d}: {log_tail}")
    daemon = daemon_mod.Daemon(_lane_raw(root, SERVE_DRILL_KNOBS), port=0, state_dir=state,
                               do_prewarm=False, device="cuda")
    thread, outcome = _start_daemon(daemon)
    _wait_until(lambda: daemon.jobs_snapshot()["jobs_done"] == 1, 600, "the resumed job")
    states = [j["state"] for j in daemon.jobs_snapshot()["jobs"]]
    _stop_daemon(daemon, thread, outcome)
    d["resumed"] = states
    d["seconds"] = time.perf_counter() - t0
    if (states != ["done"] or os.path.exists(queue_mod.journal_path(state))
            or _drill_files(root) != want):
        raise AssertionError(f"serve drill {name}: resumed {states}; the counts CSV or the "
                             "merged FASTA differs from the undisturbed run's")
    out[name] = d
    return out, serial


def serve_phase(full_lib, full: dict, kernels) -> dict:
    """Phase 12: the warm-serving daemon on the card; see the module
    docstring. ``full`` is phase 8's numbers (its first run's output still
    in place)."""
    import torch

    from ont_tcrconsensus_tpu_torch.obs import history as obs_history
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import _read_counts_csv
    from ont_tcrconsensus_tpu_torch.serve import daemon as daemon_mod
    from ont_tcrconsensus_tpu_torch.serve import queue as queue_mod

    t_phase = time.perf_counter()
    small_lib = _small_library()
    full_root = os.path.join(WORK, "lane_full")
    root1 = os.path.join(WORK, "serve_full")
    lane_fastq = os.path.join("fastq_pass", "barcode01", "barcode01.fastq.gz")
    shutil.rmtree(root1, ignore_errors=True)
    os.makedirs(os.path.join(root1, "fastq_pass", "barcode01"))
    shutil.copy(os.path.join(full_root, "reference.fa"), root1)
    shutil.copy(os.path.join(full_root, lane_fastq), os.path.join(root1, lane_fastq))
    state = os.path.join(WORK, "serve_state")
    shutil.rmtree(state, ignore_errors=True)
    ledger = os.path.join(WORK, "serve_ledger.jsonl")
    if os.path.exists(ledger):
        os.remove(ledger)
    out: dict = {}

    # 1. the daemon: the default config as the template, prewarm on
    job1 = _lane_raw(root1, {**FULL_KNOBS, "history_ledger": ledger})
    t0 = time.perf_counter()
    daemon = daemon_mod.Daemon(job1, port=0, state_dir=state, device="cuda")
    thread, outcome = _start_daemon(daemon)
    _wait_until(lambda: daemon.warmup_s is not None or outcome, 600, "the prewarm")
    out["start_s"] = time.perf_counter() - t0
    out["warmup_s"] = daemon.warmup_s
    out["prewarm"] = daemon.prewarm_report
    entries = out["prewarm"].get("entries", [])
    fused = [e for e in entries if e["kind"] == "fused_assign"]
    pol = [e for e in entries if e["kind"] == "polisher"]
    if (outcome or not entries or not all(e["ok"] for e in entries)
            or not all(e["launches"]["B1"] > 0 and e["launches"]["B5"] > 0 for e in fused)
            or not (fused and fused[0]["launches"]["B6"] > 0)
            or not (pol and pol[0]["launches"]["B2"] > 0
                    and pol[0]["launches"]["B3"] == pol[0]["launches"]["B2"])):
        raise AssertionError(f"serve: prewarm {out['prewarm']} (loop {outcome})")
    url = _jobs_url()

    # 2. the full lane as job 1, launches counted from zero
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = _submit_and_wait(url, job1, timeout=900)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    tree1 = _artifacts(root1)
    tel = json.loads(tree1["telemetry.json"])
    clean = {rel: b for rel, b in _artifacts(full_root).items()
             if not rel.startswith("barcode01/outs/")}  # phase 10's analysis verb
    counts = _read_counts_csv(os.path.join(root1, "fastq_pass", "nano_tcr", "barcode01",
                                           "counts", "umi_consensus_counts.csv"))
    if snap["state"] != "done" or counts != full_lib.true_counts:
        raise AssertionError(f"serve: job 1 {snap['state']} {snap['error']}, counts exact "
                             f"{counts == full_lib.true_counts}")
    compared = _same_files(tree1, clean, "serve job 1 (full lane)")
    _timed_schema(tree1, clean, "serve job 1 (full lane)")
    if launches != full["launches"]["rnn"] or tel["compile"]["count"] != 0:
        raise AssertionError(f"serve: job 1 launches {launches} (phase 8 run 0: "
                             f"{full['launches']['rnn']}), kernel builds {tel['compile']}")
    cfg1 = RunConfig.from_dict(job1)
    out["job1"] = {
        "n_reads": len(full_lib.reads), "seconds": job_s,
        "reads_per_s": len(full_lib.reads) / job_s, "run0_s": full["seconds"][0],
        "run0_reads_per_s": full["reads_per_s"][0], "wait_s": snap["wait_s"],
        "dispatch_first_stage_s": snap["first_stage_s"], "launches": launches,
        "kernel_builds": tel["compile"]["count"], "files_compared": compared,
        "max_memory_allocated_bytes": peak,
        "hbm_high_water_bytes": tel["gauges"].get(DEVICE_GAUGE),
        "admission": _admission_bytes(cfg1, daemon.budget),
        "admission_detail": queue_mod.estimate_admission(cfg1, daemon.budget)[1],
    }

    _stop_daemon(daemon, thread, outcome)
    serve_entries = [e for e in obs_history.read_entries(ledger)[0] if e["source"] == "serve"]
    if len(serve_entries) != 1 or serve_entries[0].get("warmup_s") != daemon.warmup_s:
        raise AssertionError(f"serve: ledger entries {serve_entries}")
    out["ledger"] = [{k: e.get(k) for k in ("job_id", "warmup_s", "steady_s", "wait_s",
                                            "dispatch_first_stage_s", "backend")}
                     for e in serve_entries]

    # 3. the drills, on the small lane under poa without the QC profiles
    out["drills"], serial = _serve_drills(small_lib,
                                          _drill_files(os.path.join(WORK, "drills")))

    # 4. a packed pair on two slices of the one card, held to the
    # transient drill's serially served job of the same knobs
    roots = [os.path.join(WORK, f"serve_pack{t}") for t in "AB"]
    for r in roots:
        _write_lane(r, small_lib)
    packed = daemon_mod.Daemon(
        _lane_raw(roots[0], {**SERVE_DRILL_KNOBS, "serve_workers": 2}), port=0,
        state_dir=os.path.join(WORK, "serve_state_packed"), do_prewarm=False, device="cuda",
        devices=["cuda:0", "cuda:0"])
    thread, outcome = _start_daemon(packed)
    url = _jobs_url()
    t0 = time.perf_counter()
    for r in roots:
        status, body = _http_json("POST", url, _lane_raw(r, SERVE_DRILL_KNOBS))
        if status != 202:
            raise AssertionError(f"serve: packed POST /jobs answered {status}: {body}")
    high, leases = 0, {}
    deadline = time.monotonic() + 600
    while packed.jobs_snapshot()["jobs_done"] < 2 or packed.allocator.resident():
        if time.monotonic() > deadline:
            raise AssertionError(f"serve: packed pair unfinished: {packed.jobs_snapshot()}")
        if packed.allocator.resident() > high:
            high, leases = packed.allocator.resident(), packed.allocator.snapshot()["leases"]
        packed.allocator.wait_for_release(0.05)
    pair_s = time.perf_counter() - t0
    states = [j["state"] for j in packed.jobs_snapshot()["jobs"]]
    _stop_daemon(packed, thread, outcome)
    slices = sorted(tuple(v["devices"]) for v in leases.values())
    if high != 2 or slices != [("cuda:0",), ("cuda:1",)] or states != ["done", "done"]:
        raise AssertionError(f"serve: packed pair high-water {high}, leases {leases}, {states}")
    pair_compared = [_same_files(_artifacts(r), serial["tree"], f"serve packed tenant {i}")
                     for i, r in enumerate(roots)]
    out["packed"] = {"seconds": pair_s, "serial_job_s": serial["job_s"],
                     "resident_high_water": high, "leases": leases,
                     "files_compared": pair_compared}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 13: polisher training and the bf16 gate


def _sha_dir(path: str) -> dict[str, str]:
    import hashlib

    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _grads(params, batch, dev):
    """The loss and every gradient leaf (Flax layout, numpy) of one batch
    on ``dev``."""
    import torch

    from ont_tcrconsensus_tpu_torch import convert
    from ont_tcrconsensus_tpu_torch.models import polisher

    model = polisher.trainable(params, device=dev)
    loss = polisher.cross_entropy_loss(model, *(torch.from_numpy(a).to(dev) for a in batch))
    loss.backward()
    tree = convert.tree_from_state({n: p.grad for n, p in model.named_parameters()})
    leaves = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                leaves[prefix + k] = v.detach().cpu().numpy()

    walk(tree, "")
    return float(loss.detach()), leaves


def _gru_kernels(fn) -> dict[str, int]:
    """The CUDA kernels one call of ``fn`` launches (``torch.profiler``),
    name (template arguments cut) -> count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        # in a process that has traced before, a session loses its first few
        # dozen device records: spend them on a primer of spin kernels
        for _ in range(256):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    names = collections.Counter(
        re.sub(r"^void ", "", e.name).split("<")[0].split("(")[0].strip()
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)
    return dict(names.most_common())


def _gru_path(kernels: dict[str, int]) -> str:
    """Which GRU implementation a forward's kernels show: cuDNN's RNN
    kernels, or ATen's fused GRU cell launched step by step."""
    low = " ".join(kernels).lower()
    if "gru_cell" in low:
        return "ATen fused GRU cell, step by step"
    if "persist" in low:
        return "cuDNN persistent RNN kernel"
    if "rnncell" in low:
        return "cuDNN RNN, step by step (a cell kernel and a GEMM a step)"
    return "other"


TRAIN_TEMPLATE = 1600  # the training CLI's template length (width 2048)
TRAIN_POOL = 16
TRAIN_BATCH = 8
TRAIN_STEPS = 50
TRACE_STEPS = 5


def _training_cpu(weights_q, results_q) -> None:
    """Phase 13's CPU side, in a process of its own beside the card's work:
    the example pool, one batch's loss and gradients from the served
    weights, the loss trace from ``init_params(0)``, and, once the card's
    trained weights' path arrives on ``weights_q``, their evaluation. Puts
    the results (or the error) on ``results_q``."""
    import traceback

    try:
        import torch

        from ont_tcrconsensus_tpu_torch.models import polisher, train

        torch.set_num_threads(2)  # the card's side and the CLI share the host
        t0 = time.perf_counter()
        pool = train.make_examples(seed=0, n_examples=TRAIN_POOL, template_len=TRAIN_TEMPLATE,
                                   device="cpu")
        res = {"examples_s": time.perf_counter() - t0, "pool": pool}
        batch = tuple(a[:TRAIN_BATCH] for a in (pool.feats, pool.labels, pool.ins_labels,
                                                 pool.mask))
        res["grads"] = _grads(polisher.load_default_params(), batch, "cpu")
        init = polisher.init_params(0, feature_dim=pool.feats.shape[-1])
        res["trace"] = train.train(steps=TRACE_STEPS, batch_size=TRAIN_BATCH, params=init,
                                   pool=pool, log_every=0, device="cpu")[1]
        res["eval"] = train.evaluate_consensus_gain(
            polisher.load_params(weights_q.get(timeout=900)), n_clusters=16, depths=(4,),
            template_len=TRAIN_TEMPLATE, device="cpu")
        results_q.put(res)
    except BaseException:
        results_q.put({"error": traceback.format_exc()})


def training_phase(tile_feats) -> dict:
    """Phase 13: the polisher's training path and the bf16 gate on the
    card, against the CPU (see the module docstring). ``tile_feats`` are
    phase 4's features of its polish tile, on the card. The CPU side runs
    in a process of its own from the start; the card's timed parts (the
    train steps, the networks at the tile) come first, then the training
    CLI, which shares the card, starts beside the rest of the card's work."""
    import multiprocessing
    import queue
    import tempfile

    import torch

    from ont_tcrconsensus_tpu_torch import convert
    from ont_tcrconsensus_tpu_torch.models import polisher, train
    from ont_tcrconsensus_tpu_torch.ops import (cs_kernel, dovetail_kernel, fuzzy_kernel,
                                                pileup_kernel, sw_kernel, traceback_kernel)

    t_phase = time.perf_counter()
    out: dict = {}
    weights_dir = os.path.dirname(polisher.DEFAULT_WEIGHTS)
    shas = _sha_dir(weights_dir)
    tmp = tempfile.mkdtemp(prefix="train_", dir=WORK)
    b2 = pileup_kernel.forward_planes_cuda
    b3 = traceback_kernel.traceback_columns_cuda
    sw_kernel.align_banded_cuda.launches = 0
    b2.launches = 0
    b3.launches = 0
    cs_kernel.error_profile_cs_cuda.launches = 0
    fuzzy_kernel.fuzzy_find_multi_cuda.launches = 0
    dovetail_kernel.dovetail_cuda.launches = 0

    def b2_since(start):
        return b2.launches - start

    ctx = multiprocessing.get_context("spawn")
    weights_q, results_q = ctx.Queue(), ctx.Queue()
    cpu_side = ctx.Process(target=_training_cpu, args=(weights_q, results_q), daemon=True)
    cli = None
    try:
        cpu_side.start()
        # examples: the pool in batched calls on the card (the CPU's in its process)
        start = b2.launches
        t0 = time.perf_counter()
        pool = train.make_examples(seed=0, n_examples=TRAIN_POOL, template_len=TRAIN_TEMPLATE,
                                   device="cuda")
        torch.cuda.synchronize()
        out["examples"] = {"n": int(pool.feats.shape[0]), "width": int(pool.feats.shape[1]),
                           "cuda_s": time.perf_counter() - t0, "cuda_b2": b2_since(start)}
        if out["examples"]["cuda_b2"] < 1:
            raise AssertionError("training: make_examples launched no B2 on the card")

        # 50 Adam steps on the card from fresh weights
        init = polisher.init_params(0, feature_dim=pool.feats.shape[-1])
        model = polisher.trainable(init, device="cuda")
        step = polisher.make_train_step(torch.optim.Adam(model.parameters(), lr=1e-3))
        rng = np.random.default_rng(1)
        losses, step_ms = [], []
        arrays = [torch.from_numpy(a).cuda() for a in
                  (pool.feats, pool.labels, pool.ins_labels, pool.mask)]
        for _ in range(TRAIN_STEPS):
            idx = torch.from_numpy(rng.integers(0, len(pool.feats), TRAIN_BATCH)).cuda()
            loss, ms = _timed_once(lambda: step(model, *(a[idx] for a in arrays)))
            losses.append(float(loss))
            step_ms.append(ms)
        rz = sum(int(torch.count_nonzero(p[: 2 * p.shape[0] // 3]))
                 for gru in model.grus for n, p in gru.named_parameters()
                 if n.startswith("bias_hh"))
        out["train"] = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "step_ms_median":
                        float(np.median(step_ms)), "step_ms_first": step_ms[0],
                        "first_loss": losses[0], "last_loss": losses[-1], "rz_nonzero": rz}
        if not losses[-1] < losses[0]:
            raise AssertionError(f"training: the loss did not fall: {losses}")
        if rz:
            raise AssertionError(f"training: {rz} hidden-side r/z biases moved off zero")
        path = os.path.join(tmp, "w.msgpack")
        polisher.save_params(convert.polisher_to_numpy(model), path)
        weights_q.put(path)

        # the served weights' networks at phase 4's tile, float32 and bfloat16
        served = polisher.load_default_params()
        m32 = convert.polisher_from_numpy(served, device="cuda")
        m16 = convert.polisher_from_numpy(served, device="cuda", dtype=torch.bfloat16)
        ab: dict = {}
        with torch.inference_mode():
            l32 = m32(tile_feats)
            l16 = m16(tile_feats.to(torch.bfloat16)).float()
            if not torch.isfinite(l16).all():
                raise AssertionError("bf16: the bf16 network gave non-finite logits")
            for _ in range(2):
                m32(tile_feats)
                m16(tile_feats.to(torch.bfloat16))
            ab["fp32_ms"] = _time_ms(lambda: m32(tile_feats), 7)
            ab["bf16_ms"] = _time_ms(lambda: m16(tile_feats.to(torch.bfloat16)), 7)
        k32 = _gru_kernels(lambda: m32(tile_feats))
        k16 = _gru_kernels(lambda: m16(tile_feats.to(torch.bfloat16)))
        ab.update({"tile": list(tile_feats.shape),
                   "max_abs_logit_diff": float((l16 - l32).abs().max()),
                   "bf16_gru_path": _gru_path(k16), "fp32_gru_path": _gru_path(k32),
                   "bf16_kernels": k16, "fp32_kernels": k32})

        # the CLI on the card, in its own process, beside the untimed rest
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("TCR_CONSENSUS_FORCE_CPU", None)
        t_cli = time.perf_counter()
        cli = subprocess.Popen(
            [sys.executable, "-m", "ont_tcrconsensus_tpu_torch.models.train", "--steps", "2",
             "--pool-examples", "4", "--eval-clusters", "4", "--out",
             os.path.join(tmp, "cli.msgpack")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # the bf16 gate: the A/B at JAX's defaults into a temporary artifact
        start = b2.launches
        t0 = time.perf_counter()
        ab_path = os.path.join(tmp, "polisher_bf16_ab_gpu.json")
        rec = polisher.run_bf16_exactness_ab(n_clusters=96, template_len=1300, out_path=ab_path,
                                             device="cuda")
        ab.update({"identical": rec["identical"], "mismatched_clusters":
                   rec["mismatched_clusters"], "n_clusters": rec["n_clusters"],
                   "ab_s": time.perf_counter() - t0, "ab_b2": b2_since(start)})
        real_path = polisher.bf16_ab_artifact_path
        polisher.bf16_ab_artifact_path = lambda backend: ab_path
        try:
            ab["certified_by_the_temporary_artifact"] = polisher.bf16_serving_certified(
                min_polish_depth=4)
        finally:
            polisher.bf16_ab_artifact_path = real_path
        if ab["certified_by_the_temporary_artifact"] != rec["identical"]:
            raise AssertionError(f"bf16: the gate disagrees with its A/B: {ab}")
        out["bf16"] = ab

        # gradients of one batch from the served (v3) weights, a 5-step loss
        # trace from the same start, and the trained weights read back and
        # served through the pipeline polisher
        batch = tuple(a[:TRAIN_BATCH] for a in (pool.feats, pool.labels, pool.ins_labels,
                                                 pool.mask))
        grads_cuda = _grads(served, batch, "cuda")
        trace_cuda = train.train(steps=TRACE_STEPS, batch_size=TRAIN_BATCH, params=init,
                                 pool=pool, log_every=0, device="cuda")[1]
        start = b2.launches
        t0 = time.perf_counter()
        eval_cuda = train.evaluate_consensus_gain(
            polisher.load_params(path), n_clusters=16, depths=(4,), template_len=TRAIN_TEMPLATE,
            device="cuda")
        out["eval"] = {"cuda_s": time.perf_counter() - t0, "cuda_b2": b2_since(start),
                       "table": eval_cuda}
        out["b2_launches"] = b2.launches
        out["b3_launches"] = b3.launches
        out["b1_launches"] = sw_kernel.align_banded_cuda.launches
        out["b4_launches"] = cs_kernel.error_profile_cs_cuda.launches
        out["b5_launches"] = fuzzy_kernel.fuzzy_find_multi_cuda.launches
        out["b6_launches"] = dovetail_kernel.dovetail_cuda.launches
        if b3.launches != b2.launches:
            raise AssertionError(f"training: B3 launched {b3.launches} times, B2 {b2.launches}")

        cli_out, cli_err = cli.communicate(timeout=900)
        out["cli"] = {"rc": cli.returncode, "seconds": time.perf_counter() - t_cli,
                      "names_cuda": "training on cuda" in cli_err,
                      "saved": os.path.exists(os.path.join(tmp, "cli.msgpack"))}
        if cli.returncode != 0 or not out["cli"]["names_cuda"] or not out["cli"]["saved"]:
            raise AssertionError(f"training CLI: {out['cli']}\n{cli_out[-2000:]}\n"
                                 f"{cli_err[-2000:]}")

        # the CPU side's results against the card's
        try:
            cpu = results_q.get(timeout=900)
        except queue.Empty:
            raise AssertionError("training: the CPU side gave no result") from None
        if "error" in cpu:
            raise AssertionError(f"training: the CPU side failed:\n{cpu['error']}")
        cpu_pool = cpu["pool"]
        out["examples"]["cpu_s"] = cpu["examples_s"]
        for f in ("labels", "ins_labels", "mask"):
            if not np.array_equal(getattr(pool, f), getattr(cpu_pool, f)):
                raise AssertionError(f"training: the cuda examples' {f} differ from the cpu's")
        out["examples"]["max_abs_feature_diff"] = float(
            np.abs(pool.feats - cpu_pool.feats).max())
        if out["examples"]["max_abs_feature_diff"] > 1e-6:
            raise AssertionError(f"training: features differ {out['examples']}")
        (lc, gc), (lp, gp) = grads_cuda, cpu["grads"]
        rel = {k: float(np.abs(gc[k] - gp[k]).max() / max(np.abs(gp[k]).max(), 1e-30))
               for k in gp}
        worst = max(rel, key=rel.get)
        out["grads"] = {"loss_cuda": lc, "loss_cpu": lp, "loss_rel_diff": abs(lc - lp) / abs(lp),
                        "max_rel_grad_diff": rel[worst], "worst_leaf": worst}
        if out["grads"]["loss_rel_diff"] > 1e-5 or rel[worst] > 1e-3:
            raise AssertionError(f"training: gradients cuda vs cpu {out['grads']}")
        trace_rel = float(np.max(np.abs(np.subtract(trace_cuda, cpu["trace"]))
                                 / np.abs(cpu["trace"])))
        out["trace"] = {"cuda": trace_cuda, "cpu": cpu["trace"], "max_rel_diff": trace_rel}
        if trace_rel > 1e-3:
            raise AssertionError(f"training: loss traces differ {out['trace']}")
        if cpu["eval"] != eval_cuda:
            raise AssertionError(f"training: evaluation cuda {eval_cuda} != cpu {cpu['eval']}")
        cpu_side.join(timeout=60)
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.wait()
        if cpu_side.is_alive():
            cpu_side.kill()
            cpu_side.join()
    if _sha_dir(weights_dir) != shas:
        raise AssertionError("training: models/weights/ changed")
    out["weights_unchanged"] = True
    out["seconds"] = time.perf_counter() - t_phase
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: the native parser against the Python parsers on the full lane,
# the serve load harness on the card and the perf gate


@contextlib.contextmanager
def _ingest_batches(counts: dict):
    """Count the read batches each ingest path yields while the block runs:
    ``native`` (the native parser's columnar path) and ``python`` (the
    Python parsers' record path)."""
    from ont_tcrconsensus_tpu_torch.io import bucketing

    real = {"native": bucketing.batch_parsed_chunks, "python": bucketing.batch_reads}
    counts.update(native=0, python=0)

    def counting(name):
        def wrapped(*args, **kwargs):
            for batch in real[name](*args, **kwargs):
                counts[name] += 1
                yield batch
        return wrapped

    bucketing.batch_parsed_chunks, bucketing.batch_reads = counting("native"), counting("python")
    try:
        yield counts
    finally:
        bucketing.batch_parsed_chunks, bucketing.batch_reads = real["native"], real["python"]


def _check_ingest_path(counts: dict, parser: str, label: str) -> None:
    """The run ingested through ``parser`` (phase 1's answer) alone."""
    other = "python" if parser == "native" else "native"
    if counts[parser] == 0 or counts[other] != 0:
        raise AssertionError(f"{label}: ingest batches {counts}, want the {parser} parser's")


def _records_view(parsed) -> list[tuple]:
    """(header, codes, quals) of each record of a native parse."""
    return [(parsed.names[i], parsed.codes[parsed.offsets[i]:parsed.offsets[i + 1]].tobytes(),
             None if parsed.quals is None
             else parsed.quals[parsed.offsets[i]:parsed.offsets[i + 1]].tobytes())
            for i in range(parsed.num_records)]


def _concat(chunks):
    """Whole-file view of a list of native chunks."""
    return [r for c in chunks for r in _records_view(c)], [b for c in chunks for b in c.bad]


def _batches_view(batches) -> list[tuple]:
    return [(b.width, b.ids, b.codes.tobytes(), None if b.quals is None else b.quals.tobytes(),
             b.lengths.tobytes(), b.valid.tobytes()) for b in batches]


# the gate, in a process where torch cannot be imported
_GATE_PROBE = r"""
import runpy, sys
sys.modules["torch"] = None
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
    rc = 0
except SystemExit as exc:
    rc = exc.code or 0
sys.exit(rc)
"""


def ingest_serve_phase(full_lib, parser: str, kernels) -> dict:
    """Phase 14: see the module docstring. ``parser`` is phase 1's answer
    ("native" or "python")."""
    import importlib.util

    from ont_tcrconsensus_tpu_torch.io import bucketing, fastx, native, validate
    from ont_tcrconsensus_tpu_torch.ops import encode

    t_phase = time.perf_counter()
    out: dict = {"parser": parser}
    lane = os.path.join(WORK, "lane_full", "fastq_pass", "barcode01", "barcode01.fastq.gz")
    corrupted = os.path.join(WORK, "ingest_full", "fastq_pass", "barcode01",
                             "barcode01.chaos-corrupt.gz")
    host_s: dict[str, float] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        value = fn()
        host_s[name] = time.perf_counter() - t0
        return value

    # 1. the parsers on the full lane: the Python parser is the reference
    py = timed("python_read_fastx", lambda: [
        (r.header, encode.encode_seq(r.sequence).tobytes(),
         None if r.quality is None
         else (np.frombuffer(r.quality.encode(), np.uint8) - 33).astype(np.uint8).tobytes())
        for r in fastx.read_fastx(lane)])
    py_tol, py_bad = timed("python_tolerant_corrupted",
                           lambda: validate.parse_path_tolerant(corrupted))
    py_tol = [(r.header.decode("utf-8", "replace"),
               validate.CODE_LUT[np.frombuffer(r.seq, np.uint8)].tobytes(),
               None if r.qual is None
               else (np.frombuffer(r.qual, np.uint8) - 33).astype(np.uint8).tobytes())
              for r in py_tol]
    py_bad = [(b.offset, b.reason, b.raw) for b in py_bad]
    want_batches = timed("python_batch_reads", lambda: _batches_view(bucketing.batch_reads(
        fastx.read_fastx(lane), batch_size=FULL_KNOBS["read_batch_size"], min_len=1)))
    if len(py) != len(full_lib.reads) or len(py_bad) < 3:
        raise AssertionError(f"phase 14: the Python parsers read {len(py)} records of "
                             f"{len(full_lib.reads)}, {len(py_bad)} bad regions")
    out.update(n_reads=len(py), n_bad=len(py_bad), n_batches=len(want_batches))
    if parser == "native":
        whole = timed("native_parse_file", lambda: native.parse_file(lane))
        chunks = timed("native_parse_chunks", lambda: list(native.parse_chunks(lane)))
        small = timed("native_parse_chunks_1M", lambda: list(
            native.parse_chunks(lane, chunk_bases=1 << 20)))
        got = {"parse_file": (_records_view(whole), whole.bad),
               "parse_chunks": _concat(chunks), "parse_chunks_1M": _concat(small)}
        for name, (records, bad) in got.items():
            if records != py or bad:
                raise AssertionError(f"phase 14: native {name} differs from read_fastx on the "
                                     f"full lane ({len(records)} records, {len(bad)} bad)")
        batches = timed("native_batch_parsed_chunks", lambda: _batches_view(
            bucketing.batch_parsed_chunks(native.parse_chunks(lane),
                                          batch_size=FULL_KNOBS["read_batch_size"], min_len=1)))
        if batches != want_batches:
            raise AssertionError("phase 14: batch_parsed_chunks differs from batch_reads")
        tol = timed("native_tolerant_corrupted",
                    lambda: native.parse_file(corrupted, tolerant=True))
        tol_chunks = _concat(list(native.parse_chunks(corrupted, chunk_bases=1 << 20,
                                                      tolerant=True)))
        for name, (records, bad) in (("parse_file", (_records_view(tol), tol.bad)),
                                     ("parse_chunks_1M", tol_chunks)):
            if records != py_tol or bad != py_bad:
                raise AssertionError(f"phase 14: the native tolerant {name} of the corrupted "
                                     f"lane differs from the Python twin: bad {bad[:3]} vs "
                                     f"{py_bad[:3]}")
        out.update(n_chunks=len(chunks), n_chunks_1M=len(small),
                   bad=[(o, r, len(raw)) for o, r, raw in tol.bad])
    out["host_s"] = host_s

    # 2. the load harness on the card, in this process (its daemons run on
    # threads): the stub scenarios, then the real pipeline
    spec = importlib.util.spec_from_file_location(
        "torch_serve_load", os.path.join(ROOT, "scripts", "torch_serve_load.py"))
    load = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(load)
    root = os.path.join(WORK, "serve_load")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ledger = os.path.join(root, "ledger.jsonl")
    reports = {}
    for scenario, extra in (("smoke", []), ("packed", []),
                            ("sustained", ["--tenants", "2", "--ledger", ledger])):
        for k in kernels:
            k.launches = 0
        path = os.path.join(root, f"{scenario}.json")
        t0 = time.perf_counter()
        rc = load.main(["--scenario", scenario, "--workdir", os.path.join(root, scenario),
                        "--out", path, "--timeout-s", "600", *extra])
        with open(path) as fh:
            report = json.load(fh)
        report["_seconds"] = time.perf_counter() - t0
        report["_launches"] = {k.__name__: k.launches for k in kernels}
        reports[scenario] = report
        if not _b3_follows_b2(report["_launches"]):
            raise AssertionError(f"phase 14: {scenario}: B3 did not follow every B2 launch: "
                                 f"{report['_launches']}")
        if rc != 0 or report["invariants"]:
            raise AssertionError(f"phase 14: torch_serve_load --scenario {scenario} exit {rc}: "
                                 f"{report['invariants']}")
    sat = reports["smoke"]["drills"]["saturation"]
    if sat["queue_full_429"] != sat["burst"] - sat["queue_max"]:
        raise AssertionError(f"phase 14: smoke saturation {sat}")
    packed = reports["packed"]["drills"]["packed"]
    if packed["resident_high_water"] < 2 or not packed["disjoint_slices"]:
        raise AssertionError(f"phase 14: packed {packed}")
    sus = reports["sustained"]
    launches = sus["_launches"]
    if (not sus["drills"]["sustained"]["counts_exact"] or sus["steady_compile_count"] != 0
            or not all(launches.values())):
        raise AssertionError(f"phase 14: sustained counts exact "
                             f"{sus['drills']['sustained']['counts_exact']}, steady builds "
                             f"{sus['steady_compile_count']}, launches {launches}")
    out["serve_load"] = {
        name: {k: r.get(k) for k in ("submitted", "accepted", "completed", "poisoned", "failed",
                                     "journaled_remaining", "rejected_by_reason", "wait_s",
                                     "first_stage_s", "reads_per_sec", "n_reads",
                                     "steady_compile_count", "cold_start_s", "_seconds",
                                     "_launches")}
        for name, r in reports.items()}
    out["serve_load"]["smoke"]["saturation"] = sat
    out["serve_load"]["packed"]["packed"] = packed
    out["serve_load"]["sustained"]["drill"] = {
        k: v for k, v in sus["drills"]["sustained"].items() if k != "prewarm"}
    out["launches"] = launches

    # 3. the perf gate over the sustained entry, torch unimportable
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _GATE_PROBE, os.path.join(ROOT, "scripts", "torch_perf_gate.py"),
         ledger, "--json"], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    try:
        verdict = json.loads(proc.stdout)
    except ValueError:
        verdict = None
    if proc.returncode != 0 or verdict is None or verdict["load"]["status"] != "warn":
        raise AssertionError(f"phase 14: perf gate exit {proc.returncode}: {proc.stdout[-1000:]} "
                             f"{proc.stderr[-1000:]}")
    out["perf_gate"] = {"rc": proc.returncode, "status": verdict["status"],
                        "load": verdict["load"]["status"], "reason": verdict["load"]["reason"],
                        "transfer": verdict["transfer"]["status"]}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every number to this JSON file")
    parser.add_argument("--lane-runs", type=int, default=1,
                        help="rounds, on the small lane, of runs without the QC "
                             "error profiles, with them on the main thread, under executor "
                             "imperative, as it is and without telemetry, after the full "
                             "lane's run (the main path's); one poa run follows them")
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
        from ont_tcrconsensus_tpu_torch.ops import (_build, cs_kernel, dovetail_kernel,
                                                    fuzzy_kernel, pileup_kernel, sw_kernel,
                                                    traceback_kernel)
    except ImportError as exc:
        return _fail(f"the port is not beside this script ({exc})")
    if any(m in ("jax", "flax", "ont_tcrconsensus_tpu")
           or m.startswith(("jax.", "flax.", "ont_tcrconsensus_tpu."))
           for m in sys.modules):
        return _fail("the port imported JAX or the JAX package")

    report: dict = {}
    t_start = time.perf_counter()
    starts = report["phase_start_s"] = {}

    def phase(name: str) -> None:
        starts[name] = time.perf_counter() - t_start
        print(f"phase {name}: starts at {starts[name]:.1f} s", flush=True)

    # 1. device
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {smi}", flush=True)
    report["device"] = {"kind": kind, "nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    # the host's parser: the native one where g++ and zlib's header are
    # there (built now, into build/torch_native/), else the Python parsers
    from ont_tcrconsensus_tpu_torch.io import native

    gxx = shutil.which("g++")
    gxx_version = (subprocess.run([gxx, "--version"], capture_output=True, text=True)
                   .stdout.splitlines() or [""])[0] if gxx else None
    zlib_h = os.path.exists("/usr/include/zlib.h")
    ingest = report["ingest_parser"] = {
        "parser": "native" if native.available() else "python",
        "native_build_s": native.build_seconds(), "build_error": native.build_error(),
        "gxx": gxx_version, "zlib_h": zlib_h}
    print(json.dumps({k: ingest[k] for k in ("parser", "native_build_s", "build_error")}),
          flush=True)
    print(f"host toolchain: g++ {gxx_version or 'missing'}; /usr/include/zlib.h "
          f"{'present' if zlib_h else 'missing'}", flush=True)
    if ingest["parser"] == "python":
        if gxx and zlib_h:
            return _fail(f"g++ and zlib.h are here but the native parser does not load: "
                         f"{ingest['build_error']}")
        print("native parser: not built, "
              + " and ".join(w for w, ok in (("g++ is missing", gxx), ("zlib.h is missing",
                                                                        zlib_h)) if not ok)
              + "; every ingest runs the Python parsers", flush=True)
    parser = ingest["parser"]

    phase("2 build")
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

    phase("3 kernel parity")
    # 3. kernel parity at main-path shapes
    # (batch, L, W): the read passes' buckets at band 128, the
    # self-homology pass's band 512; polish at band 64, and at band 128 for
    # the 3072-wide bucket (stages.polish_clusters_all)
    report["sw"] = [check_sw(dev, seed, B, L, W) for seed, (B, L, W) in
                    enumerate(((2048, 2048, 128), (2048, 3072, 128), (256, 2560, 512)))]
    report["pileup"] = [check_pileup(dev, 10 + seed, N, L, W)
                        for seed, (N, L, W) in
                        enumerate(((1024, 2048, 64), (1024, 3072, 64), (1024, 3072, 128)))]
    step_ns = report["staged_step_ns"] = staged_step_ns(dev)
    report["traceback"] = [check_traceback(dev, 10 + seed, N, L, W, step_ns)
                           for seed, (N, L, W) in
                           enumerate(((1024, 2048, 64), (1024, 3072, 64), (1024, 3072, 128)))]
    report["traceback_random"] = [row for seed, W in enumerate((64, 128))
                                  for row in check_traceback_random(dev, 30 + seed, 128, 2048, W)]
    for key in ("sw", "pileup"):
        for r in report[key]:
            print(f"parity {key} L={r['L']} W={r['W']}: exact; kernel {r['ms']:.3f} ms (a call "
                  f"{r['call_ms']:.3f} ms), plain "
                  f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
                  f"{r['fn_ops_per_cell']} ops a cell); design floor {r['design_bound_ms']:.3f} ms "
                  f"({r['design_ops_per_cell']} ops, {r['design_shuffles_per_cell']:.2f} "
                  f"shuffles a cell)", flush=True)
    print(f"B3 staged step (one lane, cold planes, L=3072, W=64): {step_ns:.1f} ns a step",
          flush=True)
    for r in report["traceback"]:
        print(f"parity traceback N={r['N']} L={r['L']} W={r['W']} (out_len L, B2's planes): "
              f"exact; kernel {r['ms']:.3f} ms (a call {r['call_ms']:.3f} ms), plain "
              f"{r['plain_ms']:.1f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['steps']} steps at least, 32 B a "
              f"step); design floor {r['design_floor_ms']:.3f} ms (staged {r['staged_bytes']} B "
              f"= {r['staged_bytes_ms']:.3f} ms; longest walk {r['longest_walk']} steps x "
              f"{r['step_ns']:.1f} ns = {r['walk_floor_ms']:.3f} ms)", flush=True)
    for r in report["traceback_random"]:
        print(f"parity traceback on random planes N={r['N']} L={r['L']} W={r['W']} out_len "
              f"{r['out_len']}: every output equal to the plain steps' (longest walk "
              f"{r['longest_walk']} steps, {r['insertion_columns']} insertion and "
              f"{r['deletion_columns']} deletion columns)", flush=True)
    from ont_tcrconsensus_tpu_torch.io import dp_cases

    b5_ptxas, b6_ptxas = _ptxas(logs.get("fuzzy_match", "")), _ptxas(logs.get("dovetail", ""))
    report["fuzzy"] = [check_fuzzy(dev, 50 + seed, *shape, b5_ptxas)
                       for seed, shape in enumerate(FUZZY_SHAPES)]
    report["dovetail"] = [check_dovetail(dev, 60 + seed, k, grid, b6_ptxas) for seed, (k, grid)
                          in enumerate(((8, False), (16, False), (8, True)))]
    # past one word, small batches: the word edges, a multi-word shape, the limits
    report["fuzzy_wide"] = [
        check_fuzzy(dev, 55 + seed, *shape, b5_ptxas, plens=plens) for seed, (shape, plens) in
        enumerate(((FUZZY_WIDE[0], dp_cases.WORD_EDGES), (dp_cases.FUZZY_MULTIWORD, None),
                   (FUZZY_WIDE[1], None)))]
    edge_a_lens = [n for n in dp_cases.WORD_EDGES for _ in dp_cases.DOVETAIL_KINDS]
    report["dovetail_wide"] = [
        check_dovetail(dev, 65 + seed, k, False, b6_ptxas, n, L, lens or (58, 68),
                       a_lens=None if lens else edge_a_lens)
        for seed, ((n, L, lens), k) in enumerate(
            ((DOVETAIL_WIDE[0], 8), (DOVETAIL_WIDE[0], 16), (dp_cases.DOVETAIL_MULTIWORD, 8),
             (DOVETAIL_WIDE[1], 8)))]
    for key in ("fuzzy", "fuzzy_wide"):
        for r in report[key]:
            print(f"parity fuzzy match B5 P={r['P']} m={r['m']} B={r['B']} Lw={r['Lw']}: exact "
                  f"({r['exact_hits']} exact hits); kernel {r['ms']:.4f} ms (a call "
                  f"{r['call_ms']:.4f} ms), plain "
                  f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{r['word_steps']} word steps, {r['ops']} int32 ops), cell bound "
                  f"{r['cell_bound_ms']:.4f} ms ({r['cells']} cells x {r['fn_ops_per_cell']} "
                  f"ops); {r['warps_an_sm']:.2f} warps an SM", flush=True)
    for key in ("dovetail", "dovetail_wide"):
        for r in report[key]:
            print(f"parity dovetail B6 {r['shape']} L={r['L']} k_end={r['k_end']}: exact; kernel "
                  f"{r['ms']:.4f} ms (a call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.1f} "
                  f"ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {r['word_steps']} word steps, {r['ops']} int32 ops), cell "
                  f"bound {r['cell_bound_ms']:.4f} ms ({r['cells']} cells x "
                  f"{r['fn_ops_per_cell']} ops); {r['warps_an_sm']:.2f} warps an SM",
                  flush=True)
    print(f"ptxas B5 {b5_ptxas['registers']} registers, {b5_ptxas['spill_bytes']} spill bytes; "
          f"B6 {b6_ptxas['registers']} registers, {b6_ptxas['spill_bytes']} spill bytes",
          flush=True)
    split = report["polish_split"] = polish_split(dev, 20)
    print(f"polish round (C={split['C']} S={split['S']} L={split['L']} W={split['W']}): "
          f"B2 forward {split['forward_ms']:.1f} ms, B3 traceback {split['traceback_ms']:.1f} ms "
          f"(the plain host loop {split['plain_traceback_ms']:.1f} ms), "
          f"vote {split['vote_ms']:.1f} ms; whole round {split['round_ms']:.1f} ms, device "
          f"{split['device_ms']:.1f} ms over {split['device_events']} traced events, busy share "
          f"{split['busy_share']}", flush=True)
    print(f"vote round pair at the same tile: fused (one readback) {split['pair_fused_ms']:.1f} "
          f"ms, two unfused rounds (a readback and the host extension each) "
          f"{split['pair_unfused_ms']:.1f} ms; drafts equal, {split['pair_stable']} of "
          f"{split['C']} clusters stable at round 2", flush=True)

    phase("3b band centres and global distance")
    # 3b. B2 and B3 off the diagonal, pileup_columns at band centres, and
    # the global distance on B6 at k_end 0
    report["band_centres"] = [check_band_centres(dev, 70 + seed, N, L, W, step_ns)
                              for seed, (N, L, W) in enumerate(BAND_CENTRE_SHAPES)]
    report["pileup_columns_offsets"] = [check_pileup_columns_offsets(dev, 75, W)
                                        for W in (64, 128)]
    report["nw"] = [check_dovetail(dev, 76 + seed, 0, grid, b6_ptxas, nw=True)
                    for seed, grid in enumerate((False, True))]
    report["band_centres_s"] = time.perf_counter() - t_start - starts[
        "3b band centres and global distance"]
    print(f"phase 3b: {report['band_centres_s']:.1f} s", flush=True)
    for r in report["band_centres"]:
        for key, kernel in (("b2", "B2 forward"), ("b3", "B3 traceback")):
            k = r[key]
            print(f"parity {kernel} with offsets N={r['N']} L={r['L']} W={r['W']} (band "
                  f"centres {r['offsets'][0]}..{r['offsets'][1]}, {r['zero_offsets']} at 0; "
                  f"{r['aligned_lanes']} lanes aligned, {r['lanes_past_the_draft']} of them "
                  f"past the draft's ends): exact; kernel {k['ms']:.3f} ms (a call "
                  f"{k['call_ms']:.3f} ms), plain {k['plain_ms']:.1f} ms, bound "
                  f"{k['bound_ms']:.4f} ms ({k['bound_by']})", flush=True)
    for r in report["pileup_columns_offsets"]:
        print(f"pileup_columns at band centres {r['offsets']} (S={r['S']} L={r['L']} W={r['W']} "
              f"out_len {r['out_len']}): cuda = cpu on every output, one B2 and one B3 launch; "
              f"{r['aligned_lanes']} lanes aligned", flush=True)
    for r in report["nw"]:
        print(f"parity global distance (B6 at k_end 0 through "
              f"{'many_vs_many, identity_matrix' if 'x' in r['shape'] else 'pairwise'}) "
              f"{r['shape']} L={r['L']}: exact; {r['ms']:.4f} ms (a call {r['call_ms']:.4f} "
              f"ms), plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}, {r['word_steps']} word steps), cell bound "
              f"{r['cell_bound_ms']:.4f} ms", flush=True)

    phase("4 polisher")
    # 4. the polisher, cuda vs cpu
    pol = report["polisher"] = polisher_parity(20)
    tile_feats = pol.pop("_feats_cuda")
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

    phase("5 error profile")
    # 5. kernel B4 against the plain core and numpy, the device path
    b4_ptxas = [line.strip() for line in logs.get("error_profile_cs", "").splitlines()
                if "registers" in line or "spill" in line]
    ep = report["error_profile"] = error_profile_phase(step_ns, b4_ptxas)
    lone = ep["lone_read"]
    print(f"parity error profile B4 ({ep['n_reads']} reads of {ep['read_len'][0]}-"
          f"{ep['read_len'][1]} nt; the device path's tile L={ep['L']} N={ep['N']} M={ep['M']} "
          f"w_pad={ep['w_pad']}): every op log equal to the plain core's up to its stop; kernel {ep['ms']:.3f} ms (a call {ep['call_ms']:.3f} ms), plain {ep['plain_ms']:.1f} ms, "
          f"bound {ep['bound_ms']:.4f} ms ({ep['bound_by']}, {ep['cells']} band cells, "
          f"{ep['steps']} walk steps); design floor {ep['design_floor_ms']:.3f} ms (tile column "
          f"{lone['column']} alone, L2 flushed first: {lone['rows']} rows, {lone['steps']} "
          f"steps; its walk x B3's staged step {step_ns:.1f} ns = {lone['walk_x_step_ms']:.3f} "
          f"ms); staged {ep['staged_bytes']} B = {ep['staged_bytes_ms']:.3f} ms; ptxas "
          f"{'; '.join(ep['ptxas']) or 'not rebuilt'}", flush=True)
    for r in ep["tiles"]:
        print(f"parity error profile B4 on the {r['tile']} tile ({r['reads']} reads, w_pad "
              f"{r['w_pad']}, up to {r['rows_max']} rows, {r['walk_steps']} walk steps): every "
              "op log equal to the plain core's up to its stop", flush=True)
    print(f"error profile device path (B4 inside, to strings): "
          + ", ".join(f"{t:.3f}" for t in ep["device_s"])
          + f" s, every cs string equal to numpy's; traced: {ep['device_events']} device "
          f"events, busy {ep['device_busy_ms']:.2f} ms; numpy {ep['numpy_s']:.2f} s",
          flush=True)

    phase("6 small e2e")
    # 6. small e2e, cuda vs cpu, under both polish methods
    small_trees: dict[str, dict[str, bytes]] = {}
    report["small_e2e"] = small_e2e(small_trees)
    for small in report["small_e2e"]:
        imp = (f"; under executor imperative on cuda ({small['imperative_s']:.1f} s) the same "
               "files byte for byte" if small["imperative_s"] is not None else "")
        print(f"small e2e ({small['polish']}): {small['files_compared']} files identical on "
              f"cuda and cpu, stage names equal, counts exact (cuda {small['cuda_s']:.1f} s, "
              f"cpu {small['cpu_s']:.1f} s); telemetry.json and history.jsonl keys equal but "
              f"the card's own, {len(small['obs']['stages'])} stages, dispatch counts "
              f"{small['obs']['dispatch_counts']} equal, fingerprint "
              f"{small['obs']['fingerprint']}{imp}", flush=True)

    phase("7 observation")
    # 7. observation on the card
    obs = report["observation"] = observation_phase()
    print(f"observation (small lane, rnn, telemetry full, profiler, live plane, watchdog): "
          f"{obs['run_s']:.1f} s, counts exact; live " + ", ".join(
              f"{r} {v['status']} ({v['bytes']} B)" for r, v in obs["live"].items())
          + f"; trace.json {obs['trace_events']} events ({obs['trace_bytes']} B), a span for "
          f"each of {len(obs['stages'])} stages on its row; profiler trace "
          f"{obs['profiler_trace_bytes']} B, {obs['profiler_trace_events']} events, names "
          f"the six kernels; --report exit 0 without torch ({obs['report_lines']} lines); no "
          f"watchdog event; kernel builds {obs['compile']['count']}; device high-water "
          f"{obs['hbm_high_water_bytes']} B", flush=True)
    pd = obs["dispatch"].get("polish.dispatch", {})
    print(f"observation polish.dispatch: host {pd.get('host_s')} s, blocked {pd.get('block_s')} "
          f"s over {pd.get('dispatches')} dispatches; the profiler's busy share of a polish "
          f"round (phase 3): {split['busy_share']}", flush=True)

    phase("8 full e2e")
    # 8. full-size e2e (the main path under the default config, then, on
    # the small lane, in turns without the QC profiles, with them serial and
    # overlapped, under the imperative order and without telemetry, then the
    # poa path), and the plants' cost
    kernels = (sw_kernel.align_banded_cuda, pileup_kernel.forward_planes_cuda,
               traceback_kernel.traceback_columns_cuda, cs_kernel.error_profile_cs_cuda,
               fuzzy_kernel.fuzzy_find_multi_cuda, dovetail_kernel.dovetail_cuda)
    full, full_lib = full_e2e(kernels, max(args.lane_runs, 0), step_ns)
    report["full_e2e"] = full
    plants = report["plant_cost_us"] = plant_cost(dev)
    print(f"full e2e: full lane {full['n_reads']} reads, small lane {full['small_n_reads']} "
          "reads; "
          + ", ".join(f"{s:.2f} s ({r:.1f} reads/s, {lane} lane, {m})" for s, r, lane, m in
                      zip(full["seconds"], full["reads_per_s"], full["lane"], full["polish"]))
          + f"; counts_exact={full['counts_exact']}, max memory "
          + ", ".join(f"{gb:.2f}" for gb in full["max_memory_allocated_gb"])
          + f" GB, launches {full['launches']}", flush=True)
    for run, stage_s in enumerate(full["stage_s"]):
        qc = "; ".join(
            f"{r} error profile: worker {stage_s[f'{r}_error_profile_bg']:.2f} s, commit wait "
            f"{stage_s[f'{r}_error_profile']:.3f} s" for r in ("round1", "round2")
            if f"{r}_error_profile_bg" in stage_s)
        print(f"full e2e run {run} ({full['lane'][run]} lane, {full['polish'][run]}): "
              f"{full['reads_per_s'][run]:.1f} "
              f"reads/s; stages (s): "
              + ", ".join(f"{k} {v:.2f}" for k, v in stage_s.items())
              + f"; polisher {full['polisher'][run]['s']:.2f} (peak inside it: "
              f"{full['polisher'][run]['peak_gb']} GB)" + (f"; {qc}" if qc else ""), flush=True)
    tel0, win = full["telemetry"][0]["dispatch"], full["assign_window"]
    print("full e2e run 0 overlaps: consensus.get gets "
          f"{tel0.get('consensus.get', {}).get('gets')}; "
          + ", ".join(f"{site} host {tel0[site]['host_s']} s / blocked {tel0[site]['block_s']} s"
                      for site in ("assign.dispatch", "polish.dispatch") if site in tel0)
          + "; stages (s) " + ", ".join(
              f"{k} {full['stage_s'][0].get(k, 0.0):.3f}"
              for k in ("round1_fused_assign", "round2_fused_assign", "round1_polish"))
          + "; live threads after each run " + ", ".join(
              f"{k} {max(t[k] for t in full['overlap_threads'])}" for k in OVERLAP_THREADS)
          + f"; round1_fused_assign traced (a run of its own): device {win['device_ms']:.1f} ms "
          f"of {win['window_ms']:.1f} ms, {win['events']} events, busy share "
          f"{win['busy_share']:.4f}", flush=True)
    run0 = full["launches"]["rnn"]
    print(f"full e2e run 0 B5/B6: launches B5 {run0['fuzzy_find_multi_cuda']}, B6 "
          f"{run0['dovetail_cuda']} ({full['launches_nw']} of them at k_end 0, the global "
          f"distance's route); B2/B3 launches given band centres {full['launches_with_offsets']} "
          f"(the main path passes none); host seconds assign.dispatch "
          f"{tel0.get('assign.dispatch', {}).get('host_s')}, cluster.batched_dispatch "
          f"{tel0.get('cluster.batched_dispatch', {}).get('host_s')}; stages (s) "
          + ", ".join(f"{k} {full['stage_s'][0].get(k, 0.0):.3f}"
                      for k in ("round1_fused_assign", "round1_umi_cluster"))
          + f"; round1_fused_assign window {win['events']} device events, busy share "
          f"{win['busy_share']:.4f}", flush=True)
    for key, gaps in full["launch_gaps"].items():
        dims = {"traceback": "(batch, L, Lr, W, out_len)",
                "cs": "(L, N, M, w_pad)"}.get(key, "(batch, L, Lr, W)")
        print(f"full e2e run 0 {key} launches by {dims}: " + ", ".join(
              f"{tuple(r['shape'])} x{r['launches']} {r['ms']:.3f} ms (bound {r['bound_ms']:.4f}"
              + (f", design floor {r['design_floor_ms']:.3f}"
                 if "design_floor_ms" in r else "")
              + (f"; every op log equal to the plain core's, plain {r['plain_ms']:.1f} ms"
                 if "plain_ms" in r else "") + ")"
              for r in gaps["shapes"]), flush=True)
        print(f"full e2e run 0 {key}: kernel {gaps['kernel_ms']:.1f} ms in all, launches x "
              f"(time - bound) {gaps['launches_x_gap_ms']:.1f} ms", flush=True)
    mem_off = {}
    for run, tel in full["telemetry"].items():
        print(f"full e2e run {run} telemetry: dispatch (host s / blocked s) " + ", ".join(
              f"{site} {d['host_s']}/{d['block_s']} x{d['dispatches']}+{d['gets']}"
              for site, d in tel["dispatch"].items())
              + f"; kernel builds {tel['compile']['count']} ({tel['compile']['seconds']} s); "
              f"device high-water {tel['hbm_high_water_bytes']} B, max_memory_allocated "
              f"{tel['max_memory_allocated_bytes']} B; roll-up {tel['rollup_s']:.4f} s",
              flush=True)
        print(f"full e2e run {run} graph executor: {len(tel['graph_nodes_run'])} nodes run "
              f"({', '.join(tel['graph_nodes_run'])}); graftcheck {tel['graftcheck']['verdict']}"
              f", static high-water {tel['graftcheck']['hbm_high_water_bytes_est']} B at "
              f"{tel['graftcheck']['hbm_high_water_node']}; donation {tel['donation']}; node "
              "memory (static / measured B): " + ", ".join(
                  f"{n} {r.get('static_bytes')}/{r.get('measured_end_bytes')}"
                  for n, r in tel["memory"]["nodes"].items())
              + f"; --report --memory problems: {tel['memory']['problems']}", flush=True)
        hw, mx = tel["hbm_high_water_bytes"], tel["max_memory_allocated_bytes"]
        if hw is None or abs(hw - mx) > 0.01 * mx:
            mem_off[run] = (hw, mx)
    warm = [r for i, (r, m) in enumerate(zip(full["reads_per_s"], full["polish"]))
            if m == "rnn" and i > 0]
    rps = full["reads_per_s"]
    off = [r for r, m in zip(rps, full["polish"]) if m == "rnn, telemetry off"]
    # each round's default run comes just before its off run
    ratios = [rps[i - 1] / rps[i] for i, m in enumerate(full["polish"])
              if m == "rnn, telemetry off"]
    # the plants' added seconds over the first run's calls, and its roll-up
    first = full["telemetry"][0]
    plants_s = sum(n * plants[k]["added"] * 1e-6 for k, n in first["plant_calls"].items())
    bound_s = plants_s + first["rollup_s"]
    full["telemetry_cost"] = {"on_reads_per_s": warm, "off_reads_per_s": off,
                              "on_over_off": (float(np.median(warm) / np.median(off))
                                              if off else None),
                              "pair_ratios": ratios, "plants_s": plants_s,
                              "bound_s": bound_s, "bound_share": bound_s / full["seconds"][0]}
    print("telemetry plants (us a call, disarmed -> armed): " + ", ".join(
          f"{k} {v['off']:.2f} -> {v['on']:.2f}" for k, v in plants.items())
          + f"; run 0's calls {first['plant_calls']}: {plants_s * 1e3:.3f} ms, roll-up "
          f"{first['rollup_s'] * 1e3:.1f} ms, together {bound_s:.4f} s of "
          f"{full['seconds'][0]:.2f} s ({100 * full['telemetry_cost']['bound_share']:.4f}%)",
          flush=True)
    if off:
        print(f"full e2e telemetry on (warm default runs) "
              + ", ".join(f"{r:.1f}" for r in warm) + " reads/s against off "
              + ", ".join(f"{r:.1f}" for r in off)
              + f": on/off {full['telemetry_cost']['on_over_off']:.4f} (medians); adjacent "
              "pairs " + ", ".join(f"{r:.4f}" for r in ratios), flush=True)
    # each round's imperative run comes just before its graph run
    full["executor_pairs"] = [
        {"imperative_reads_per_s": rps[i], "graph_reads_per_s": rps[i + 1],
         "graph_over_imperative": rps[i + 1] / rps[i],
         "stages": {k: (full["stage_s"][i].get(k), full["stage_s"][i + 1].get(k))
                    for k in dict.fromkeys([*full["stage_s"][i], *full["stage_s"][i + 1]])}}
        for i, m in enumerate(full["polish"]) if m == "rnn, executor imperative"]
    for pair in full["executor_pairs"]:
        print(f"full e2e executors: imperative {pair['imperative_reads_per_s']:.1f} reads/s, "
              f"graph {pair['graph_reads_per_s']:.1f} reads/s (graph/imperative "
              f"{pair['graph_over_imperative']:.4f}); stages (s, imperative/graph): " + ", ".join(
                  f"{k} {'-' if a is None else f'{a:.2f}'}/{'-' if b is None else f'{b:.2f}'}"
                  for k, (a, b) in pair["stages"].items()), flush=True)
    _dump(args.out, report)
    if mem_off:
        return _fail(f"telemetry's device high-water and max_memory_allocated differ by more "
                     f"than 1%: {mem_off}")
    if not full["counts_exact"]:
        return _fail(f"full e2e counts differ from the truth: {full.get('count_diffs')}")
    b4 = {path: n["error_profile_cs_cuda"] for path, n in full["launches"].items()}
    b4_off = full["launches_no_profile"].get("error_profile_cs_cuda")
    print(f"full e2e B4 launches: {b4} (run 0 the full lane), without the QC profiles "
          f"{'not run' if b4_off is None else b4_off}", flush=True)
    if not all(n for path in full["launches"].values() for n in path.values()):
        return _fail(f"a kernel of a path never launched: {full['launches']}")
    if b4_off:
        return _fail(f"B4 launched without the QC profiles: {full['launches_no_profile']}")
    if any(full["launches_with_offsets"].values()):
        return _fail(f"the main path gave B2/B3 band centres {full['launches_with_offsets']}: "
                     "its launches pass none")
    if not all(_b3_follows_b2(path) for path in full["launches"].values()):
        return _fail(f"B3 did not follow every B2 launch: {full['launches']}")
    _check_ingest_path(full["ingest_batches"], parser, "full e2e run 0")
    print(f"full e2e run 0 ingest: {parser} parser, read batches by path "
          f"{full['ingest_batches']}", flush=True)

    phase("9 robustness")
    # 9. robustness on the card
    rob = report["robustness"] = robustness_phase(small_trees["poa"])
    for name, events in rob["drills"].items():
        print(f"drill {name}: events " + (", ".join("/".join(e) for e in events) or "none"),
              flush=True)
    print(f"robustness: {len(rob['drills'])} drills on the small lane ({rob['n_reads']} reads, "
          f"poa), each ending with phase 6's undisturbed counts CSV and merged FASTA; "
          f"{rob['seconds']:.1f} s", flush=True)
    _dump(args.out, report)

    phase("10 ingest")
    # 10. ingest validation on the card: the full lane under quarantine,
    # --validate, the analysis verb
    with _ingest_batches({}) as ingest_10:
        ing = report["ingest"] = ingest_phase(full_lib, full, kernels)
    _check_ingest_path(ingest_10, parser, "ingest (phase 10)")
    print(f"ingest: the quarantine run ingested through the {parser} parser, read batches by "
          f"path {ingest_10}", flush=True)
    print(f"ingest: full lane ({ing['n_reads']} reads) under quarantine, contracts strict, "
          f"three blocks spliced: {ing['run_s']:.2f} s ({ing['reads_per_s']:.1f} reads/s; the "
          f"clean run of phase 8 {ing['clean_s']:.2f} s, {ing['clean_reads_per_s']:.1f} "
          f"reads/s); counts exact; {ing['files_compared']} files byte-identical to the clean "
          f"run's; launches {ing['launches']} (the clean run's); events "
          + ", ".join(f"{o} {r!r} at {off}" for o, r, off in ing["events"])
          + f"; quarantine.fastq.gz holds exactly the spliced blocks ({ing['quarantine_bytes']} "
          f"B); contracts strict, none violated ({ing['contracts_checked']})", flush=True)
    print("ingest stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in ing["stage_s"].items()),
          flush=True)
    print("ingest on the host (s): " + ", ".join(f"{k} {v:.2f}" for k, v in ing["host_s"].items())
          + " (the drill's gzip rewrite of the corrupted lane, the tolerant parse of it, the "
          "strict parse of the clean lane)", flush=True)
    for name, v in ing["validate"].items():
        print(f"ingest --validate ({name} lane): exit {v['rc']} in {v['s']:.2f} s, torch not "
              f"loaded; {v['line']}" + "".join(f"; {p}" for p in v["problems"]), flush=True)
    an = ing["analysis"]
    if an["run"]:
        print(f"ingest analysis verb ({an['s']:.2f} s): summaries " + "; ".join(
              f"{lib_key}: " + ", ".join(f"{k} {v}" for k, v in summ.items())
              for lib_key, summ in an["summary"].items())
              + f"; outs/ {', '.join(an['outs'])}", flush=True)
    else:
        print(f"ingest analysis verb: not run: {an['why']}", flush=True)
    print(f"ingest: {ing['seconds']:.1f} s", flush=True)
    _dump(args.out, report)

    phase("11 mesh")
    # 11. the data mesh: the small lane at data = the host's cards, the
    # kernels split over two slices of one card, the mesh drills, two
    # processes
    ms = report["mesh"] = mesh_phase(report["small_e2e"][0], small_trees["rnn"], kernels)
    print(f"mesh: small lane ({ms['n_reads']} reads) at data={ms['cards']} (this host's cards): "
          f"{ms['run_s']:.2f} s ({ms['reads_per_s']:.1f} reads/s; unsharded cuda run of phase 6 "
          f"{ms['clean_s']:.2f} s, {ms['clean_reads_per_s']:.1f} reads/s); counts exact; "
          f"{ms['files_compared']} files byte-identical to phase 6's cuda run; launches "
          f"{ms['launches']}, by slice {ms['launches_by_slice']} (B1's self-homology "
          f"launches run unsplit, as in JAX); slice gauges "
          f"{ms['mesh_slice_busy']}; history mesh_config {ms['mesh_config']}", flush=True)
    print("mesh stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in ms["stage_s"].items()),
          flush=True)
    for key, r in ms["sharded_kernels"].items():
        print(f"mesh {key} ({r['shape']}) split over a data=2 mesh of two "
              f"slices of ONE card (cuda:0 twice, not two cards): bit-equal to the unsplit "
              f"launch; unsplit {r['whole_ms']:.3f} ms, split {r['split_ms']:.3f} ms", flush=True)
    for name, d in ms["drills"].items():
        print(f"mesh drill {name} (small lane, data=2 over two slices of ONE card, poa): "
              f"{d['seconds']:.2f} s, the unsharded run's counts CSV and merged FASTA; events "
              + (", ".join("/".join(e) for e in d["events"]) or "none")
              + f"; slice gauges {d['mesh_slice_busy']}; launches (all, by slice) "
              f"{d['launches']}", flush=True)
    pr = ms["processes"]
    print(f"mesh two processes (one gloo group, both on cuda:0): exit 0 each, "
          f"{'; '.join(pr['owns'])}; {pr['library_files_compared']} library files equal to "
          f"one process's run ({pr['single_s']:.2f} s); per-process files {pr['files']}; "
          f"seconds " + ", ".join(f"{s:.2f}" for s in pr["process_s"]), flush=True)
    print(f"mesh: {ms['seconds']:.1f} s", flush=True)
    _dump(args.out, report)

    phase("12 serve")
    # 12. the warm-serving daemon: prewarm, the full lane as a served job,
    # drills, a packed pair on two slices of the card
    with _ingest_batches({}) as ingest_12:
        sv = report["serve"] = serve_phase(full_lib, full, kernels)
    _check_ingest_path(ingest_12, parser, "serve (phase 12)")
    print(f"serve: the jobs in this process ingested through the {parser} parser, read "
          f"batches by path {ingest_12}", flush=True)
    pw = sv["prewarm"]
    print(f"serve: daemon started and warm in {sv['start_s']:.2f} s (warmup_s "
          f"{sv['warmup_s']}); prewarm {pw['seconds']} s, {pw['compiled']} ok, {pw['failed']} "
          f"failed, kernel build/load {pw['build_s']} s; entries " + ", ".join(
              f"{e['kind']} w={e['width']} b={e['batch']} {e['seconds']} s "
              + " ".join(f"{k} {n}" for k, n in e["launches"].items())
              for e in pw["entries"]),
          flush=True)
    j1 = sv["job1"]
    print(f"serve job 1 (full lane, {j1['n_reads']} reads, over HTTP): {j1['seconds']:.2f} s "
          f"({j1['reads_per_s']:.1f} reads/s; phase 8 run 0 {j1['run0_s']:.2f} s, "
          f"{j1['run0_reads_per_s']:.1f} reads/s); counts exact; {j1['files_compared']} files "
          f"byte-identical to run 0's, the files of timings by schema; launches "
          f"{j1['launches']}; kernel builds {j1['kernel_builds']}; wait_s {j1['wait_s']}, "
          f"dispatch_first_stage_s {j1['dispatch_first_stage_s']}; peak memory "
          f"{j1['max_memory_allocated_bytes']} B (telemetry {j1['hbm_high_water_bytes']} B) "
          f"against the admission estimate {j1['admission']} ({j1['admission_detail']})",
          flush=True)
    print(f"serve ledger (source serve): {sv['ledger']}", flush=True)
    pk = sv["packed"]
    for name, d in sv["drills"].items():
        print(f"serve drill {name}: " + ", ".join(f"{k} {v}" for k, v in d.items()),
              flush=True)
    print(f"serve packed pair (serve_workers 2, two slices of cuda:0, small lane, poa without "
          f"the QC profiles): {pk['seconds']:.2f} s for both (the transient drill's served "
          f"job {pk['serial_job_s']:.2f} s); resident at once {pk['resident_high_water']} on "
          f"{pk['leases']}; each tenant's {pk['files_compared']} files equal that job's",
          flush=True)
    print(f"serve: {sv['seconds']:.1f} s", flush=True)
    _dump(args.out, report)

    phase("13 training")
    # 13. polisher training and the bf16 gate
    tr = report["training"] = training_phase(tile_feats)
    ex, g, t, b = tr["examples"], tr["grads"], tr["train"], tr["bf16"]
    print(f"training examples ({ex['n']} at width {ex['width']}, template {TRAIN_TEMPLATE}): cuda "
          f"{ex['cuda_s']:.2f} s with {ex['cuda_b2']} B2 launches, cpu {ex['cpu_s']:.2f} s (both "
          f"beside the CLI's process and each other); equal (features within "
          f"{ex['max_abs_feature_diff']:.3g})", flush=True)
    print(f"training gradients (batch {TRAIN_BATCH}, served weights): loss cuda {g['loss_cuda']:.6f}"
          f" cpu {g['loss_cpu']:.6f} (rel {g['loss_rel_diff']:.3g}); largest relative gradient "
          f"difference {g['max_rel_grad_diff']:.3g} ({g['worst_leaf']})", flush=True)
    print(f"training {t['steps']} Adam steps at batch {t['batch']} on the card: "
          f"{t['step_ms_median']:.2f} ms a step (median, CUDA events; first {t['step_ms_first']:.2f} "
          f"ms), loss {t['first_loss']:.4f} -> {t['last_loss']:.4f}; r/z hidden biases nonzero: "
          f"{t['rz_nonzero']}; {TRACE_STEPS}-step trace cuda {tr['trace']['cuda']} cpu "
          f"{tr['trace']['cpu']} (max rel {tr['trace']['max_rel_diff']:.3g})", flush=True)
    print(f"training eval (16 clusters, depth 4, the trained weights read back and served): "
          f"cuda = cpu {tr['eval']['table']}; cuda {tr['eval']['cuda_s']:.2f} s, "
          f"{tr['eval']['cuda_b2']} B2 launches", flush=True)
    print(f"bf16 A/B ({b['n_clusters']} clusters, template 1300): identical {b['identical']}, "
          f"mismatched_clusters {b['mismatched_clusters']}, gate on its artifact "
          f"{b['certified_by_the_temporary_artifact']}; {b['ab_s']:.2f} s, {b['ab_b2']} B2 "
          f"launches; at phase 4's tile {b['tile']}: max |bf16 - fp32 logit| "
          f"{b['max_abs_logit_diff']:.4g}, network bf16 {b['bf16_ms']:.3f} ms, fp32 "
          f"{b['fp32_ms']:.3f} ms; GRU path bf16 {b['bf16_gru_path']}, fp32 {b['fp32_gru_path']}; "
          f"kernels bf16 {dict(list(b['bf16_kernels'].items())[:4])}, fp32 "
          f"{dict(list(b['fp32_kernels'].items())[:4])}", flush=True)
    print(f"training CLI on the card: exit {tr['cli']['rc']} in {tr['cli']['seconds']:.1f} s; "
          f"B2 launches of the phase (in this process) {tr['b2_launches']}, B3 "
          f"{tr['b3_launches']}, B1 "
          f"{tr['b1_launches']}, B4 {tr['b4_launches']}, B5 {tr['b5_launches']}, B6 "
          f"{tr['b6_launches']}; models/weights/ unchanged; phase {tr['seconds']:.1f} s",
          flush=True)
    _dump(args.out, report)

    phase("14 ingest and load")
    # 14. the native parser against the Python parsers on the full lane, the
    # load harness's scenarios on the card, the perf gate on its ledger
    il = report["ingest_load"] = ingest_serve_phase(full_lib, parser, kernels)
    hs = il["host_s"]
    if parser == "native":
        print(f"parsers on the full lane ({il['n_reads']} reads): native parse_file, "
              f"parse_chunks ({il['n_chunks']} chunk(s); {il['n_chunks_1M']} at 1M bases) and "
              f"read_fastx give the same records; batch_parsed_chunks gives batch_reads' "
              f"{il['n_batches']} batches one for one; on phase 10's corrupted copy the native "
              f"tolerant parse (whole and in 1M-base chunks) gives the Python twin's records "
              f"and {il['n_bad']} bad regions (offset, reason, bytes): "
              + ", ".join(f"{r!r} at {o} ({n} B)" for o, r, n in il["bad"]), flush=True)
    else:
        print(f"parsers on the full lane ({il['n_reads']} reads): the Python parsers only "
              f"(no native parser on this host)", flush=True)
    print("parse host seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in hs.items()), flush=True)
    for name, r in il["serve_load"].items():
        print(f"serve_load {name} on cuda ({r['_seconds']:.1f} s): submitted {r['submitted']} = "
              f"accepted {r['accepted']} + rejected {r['rejected_by_reason']}; accepted = "
              f"completed {r['completed']} + poisoned {r['poisoned']} + failed {r['failed']} + "
              f"journaled {r['journaled_remaining']}; launches {r['_launches']}", flush=True)
    sl = il["serve_load"]
    print(f"serve_load smoke: saturation burst {sl['smoke']['saturation']['burst']} over "
          f"queue_max {sl['smoke']['saturation']['queue_max']}: "
          f"{sl['smoke']['saturation']['queue_full_429']} queue_full 429s; packed on "
          f"{sl['packed']['packed']['overlap_observed']}: resident high-water "
          f"{sl['packed']['packed']['resident_high_water']}, disjoint "
          f"{sl['packed']['packed']['disjoint_slices']}", flush=True)
    su = sl["sustained"]
    print(f"serve_load sustained (2 tenants, {su['n_reads']} reads, poa): {su['reads_per_sec']} "
          f"reads/s over the busy window {su['drill']['busy_window_s']} s; wait p50/p99 "
          f"{su['wait_s']['p50']}/{su['wait_s']['p99']} s; first stage p50/p99 "
          f"{su['first_stage_s']['p50']}/{su['first_stage_s']['p99']} s; cold_start_s "
          f"{su['cold_start_s']}; steady_compile_count {su['steady_compile_count']}; counts "
          f"exact {su['drill']['counts_exact']}; launches {il['launches']}", flush=True)
    pg = il["perf_gate"]
    print(f"perf gate (torch unimportable) on the sustained ledger: exit {pg['rc']}, verdict "
          f"{pg['status']}, load {pg['load']} ({pg['reason']}), transfer {pg['transfer']}; "
          f"phase {il['seconds']:.1f} s", flush=True)
    _dump(args.out, report)

    phase("15 lane scale")
    # 15. the lane-scale path in a process of its own
    lsr = report["lane_scale"] = lane_scale_phase()
    art = lsr["artifact"]
    print(f"lane scale ({art['n_reads']} reads, heavy region {art['heavy_region_molecules']} "
          f"molecules at depth 3, {art['round2_assign']} round 2, on {art['device_kind']}): "
          f"{art['wall_seconds']:.2f} s, {art['reads_per_sec']:.1f} reads/s; heavy region "
          f"{art['heavy_region_count'][0]}/{art['heavy_region_count'][1]} (>= 0.96, no "
          f"overcount), every other region exact; peak device memory "
          f"{art['peak_device_mem_gb']:.3f} GB, host RSS {art['peak_host_rss_gb']:.3f} GB; "
          f"launches {art['kernel_launches']}; exit {lsr['rc']}; dataset and run "
          f"{lsr['seconds']:.1f} s", flush=True)
    print("lane scale stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in art["stage_timing_sec"].items())
        + f"; precision at depth {art['precision_at_depth']}", flush=True)
    _dump(args.out, report)

    phase("16 kernels line")
    # 16. kernels line
    entries = []
    for k, key, name, src, replaces, training in (
        (sw_kernel.align_banded_cuda, "sw", "sw_banded",
         "ont_tcrconsensus_tpu_torch/csrc/sw_banded.cu", "ont_tcrconsensus_tpu/ops/sw_pallas.py:56",
         tr["b1_launches"]),
        (pileup_kernel.forward_planes_cuda, "pileup", "pileup_forward",
         "ont_tcrconsensus_tpu_torch/csrc/pileup_forward.cu",
         "ont_tcrconsensus_tpu/ops/pileup_pallas.py:61", tr["b2_launches"]),
        (traceback_kernel.traceback_columns_cuda, "traceback", "pileup_traceback",
         "ont_tcrconsensus_tpu_torch/csrc/pileup_traceback.cu",
         "ont_tcrconsensus_tpu/ops/pileup.py:297", tr["b3_launches"]),
    ):
        r = report[key][1]  # L=3072: the read passes' band 128, the polish band 64
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": full["launches"]["rnn"][k.__name__],
            "launches_training": training,
            "launches_serve_load": il["launches"][k.__name__],
            "launches_lane_scale": art["kernel_launches"][{"sw": "B1", "pileup": "B2",
                                                           "traceback": "B3"}[key]],
            "max_abs_err": max(x["max_abs_err"] for x in report[key]),
            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            **({"design_floor_ms": r["design_floor_ms"], "staged_bytes": r["staged_bytes"]}
               if key == "traceback" else {}),
        })
        if key != "sw":  # B2 and B3 with every lane off the diagonal (phase 3b)
            off = report["band_centres"][0]["b2" if key == "pileup" else "b3"]
            entries[-1]["offsets"] = {
                "shape": {k: report["band_centres"][0][k] for k in ("N", "L", "W")},
                "launches": full["launches_with_offsets"][f"{k.__name__}.launches_offs"],
                **{k: off[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                                       "bound_by")}}
    # B4's training and lane-scale counts are read in phases 13 and 15 (no
    # training step and no lane-scale run computes a QC profile: 0 there)
    entries.append({
        "name": "error_profile_cs", "route": "cuda",
        "source": "ont_tcrconsensus_tpu_torch/csrc/error_profile_cs.cu",
        "replaces": "ont_tcrconsensus_tpu/qc/error_profile.py:294",
        "launches": full["launches"]["rnn"][cs_kernel.error_profile_cs_cuda.__name__],
        "launches_training": tr["b4_launches"],
        "launches_serve_load": il["launches"][cs_kernel.error_profile_cs_cuda.__name__],
        "launches_lane_scale": art["kernel_launches"]["B4"],
        "max_abs_err": ep["max_abs_err"], "ms": ep["ms"], "call_ms": ep["call_ms"],
        "plain_ms": ep["plain_ms"],
        "bound_ms": ep["bound_ms"], "bound_by": ep["bound_by"], "library_ms": None,
        "design_floor_ms": ep["design_floor_ms"], "staged_bytes": ep["staged_bytes"],
    })
    for k, key, name, replaces, training in (
        (fuzzy_kernel.fuzzy_find_multi_cuda, "fuzzy", "fuzzy_match",
         "ont_tcrconsensus_tpu/ops/fuzzy_match.py:52", tr["b5_launches"]),
        (dovetail_kernel.dovetail_cuda, "dovetail", "dovetail",
         "ont_tcrconsensus_tpu/ops/edit_distance.py:96", tr["b6_launches"]),
    ):
        r = report[key][0]  # the primer trim's shape; the shortlist's 8192 pairs at k_end 8
        entries.append({
            "name": name, "route": "cuda", "source": f"ont_tcrconsensus_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": full["launches"]["rnn"][k.__name__],
            "launches_training": training,
            "launches_serve_load": il["launches"][k.__name__],
            "launches_lane_scale": art["kernel_launches"]["B5" if key == "fuzzy" else "B6"],
            "max_abs_err": max(x["max_abs_err"] for x in report[key]),
            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "cell_bound_ms": r["cell_bound_ms"],
        })
    # the global distance's route through B6 (k_end 0; no main path calls it)
    entries[-1]["routes"] = [{
        "name": "nw", "replaces": "ont_tcrconsensus_tpu/ops/edit_distance.py:34",
        "k_end": 0, "shape": r["shape"],
        "launches": full["launches_nw"], **{k: r[k] for k in (
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None} for r in report["nw"]]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    shutil.rmtree(WORK, ignore_errors=True)
    return 0


# ---------------------------------------------------------------------------
# phase 15: the lane-scale path (scripts/torch_lane_scale_proof.py)

LANE_SCALE_READS = 3_000  # the JAX medium tier's shape (tests/test_lane_scale.py)
LANE_SCALE_MIN_HEAVY = 600  # the JAX medium tier's floor, past the shortlist's 256


def lane_scale_phase() -> dict:
    """``scripts/torch_lane_scale_proof.py`` on ``cuda`` in a process of its
    own at the JAX package's medium tier (``tests/test_lane_scale.py``),
    held to its assertions: the heavy region >= 0.96 of the truth and never
    over it, every other region exact; each B2 launch followed by B3. The script exits 1
    when a count differs from the truth (at depth 3 the heavy region may
    lose molecules), which the assertions judge."""
    t0 = time.perf_counter()
    root = os.path.join(WORK, "lane_scale")
    out_path = os.path.join(WORK, "lane_scale.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_lane_scale_proof.py"),
         "--reads", str(LANE_SCALE_READS), "--min-heavy", str(LANE_SCALE_MIN_HEAVY),
         "--root", root, "--out", out_path], cwd=ROOT, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode not in (0, 1) or not os.path.exists(out_path):
        raise AssertionError(f"lane scale: exit {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out_path) as fh:
        art = json.load(fh)
    heavy = art["heavy_region_molecules"]
    heavy_got, heavy_want = art["heavy_region_count"]
    rest = {k: v for k, v in art["count_diffs"].items() if k != "TCR0000"}
    b = art["kernel_launches"]
    problems = [what for what, bad in (
        ("backend not cuda", art["backend"] != "cuda"),
        (f"heavy region {heavy} < {LANE_SCALE_MIN_HEAVY}", heavy < LANE_SCALE_MIN_HEAVY),
        (f"heavy {heavy_got} < 0.96 x {heavy_want}", heavy_got < 0.96 * heavy_want),
        (f"heavy {heavy_got} > {heavy_want}: overcount", heavy_got > heavy_want),
        (f"other regions differ: {rest}", bool(rest)),
        (f"exit {proc.returncode} with counts_exact {art['counts_exact']}",
         proc.returncode != (0 if art["counts_exact"] else 1)),
        (f"launches {b}", not all(b[k] for k in ("B1", "B2", "B3", "B5", "B6"))
         or b["B3"] != b["B2"]),
        # the twin runs with error_profile_sample 0: no QC profile, no B4
        (f"B4 launched {b['B4']} times without a QC profile", b["B4"] != 0),
    ) if bad]
    if problems:
        raise AssertionError(f"lane scale: {'; '.join(problems)}")
    return {"rc": proc.returncode, "seconds": seconds, "artifact": art}


def _b3_follows_b2(launches: dict) -> bool:
    """Each forward (B2) is followed by its traceback (B3)."""
    return launches["traceback_columns_cuda"] == launches["forward_planes_cuda"]


def _dump(path, report) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)


if __name__ == "__main__":
    sys.exit(main())
