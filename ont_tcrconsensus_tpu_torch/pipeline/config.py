"""Validated run configuration (a copy of the JAX package's
``pipeline/config.py``: the same keys, defaults and checks, so one run
config drives either package).

The reference reads one flat JSON eagerly into locals with no defaults and no
validation (ont_tcr_consensus/tcr_consensus.py:38-71). Here the same knobs
live on a typed dataclass with defaults, type/range checks and a clear error
message per key. Unknown keys are rejected so typos fail fast. Knobs this
slice of the port does not implement are accepted here and refused (or
ignored, for observation-only knobs) by :mod:`.run`.

Derived values mirror the reference exactly:
- ``cluster_identity = 1 - max_ee_rate_base`` (tcr_consensus.py:68)
- ``blast_id_threshold`` / ``minimal_region_overlap_consensus`` default to the
  measured max reference self-homology (tcr_consensus.py:99-102), resolved at
  pipeline time, not config-load time.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

# Keys accepted for compatibility with the reference config but unused here
# (they configure external binaries this framework replaces).
_COMPAT_IGNORED = {
    "dorado_excutable",  # sic — reference's own spelling (run_config.json:30)
    "dorado_executable",
    "medaka_model",
    "medaka_memory_gb_per_umi_cluster",
    "medaka_memory_gb_task_overhead",
    "max_cap_medaka_memory_gb",
}

# packaged primer set (dorado trim analogue input; the reference ships the
# same four GSP/UVP primers at ont_tcr_consensus/primers/primers.fasta)
DEFAULT_PRIMERS_FASTA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "primers", "primers.fasta",
)

# the band widths kernel B1 (csrc/sw_banded.cu) is instantiated for; the
# plain CPU version takes the same set, so both devices accept one config
SW_BAND_WIDTHS = (128, 256, 384, 512)


@dataclasses.dataclass
class RunConfig:
    """All pipeline knobs. Field names match the reference JSON keys."""

    # --- inputs ---
    reference_file: str
    fastq_pass_dir: str

    # --- flow control ---
    only_run_reference_self_homology: bool = False
    delete_tmp_files: bool = True

    # --- read preprocessing (trim + EE filter; preprocessing.py:7-159) ---
    trim_primers: bool = True
    nanopore_tcr_seq_primers_fasta: str | None = None  # None -> packaged set
    primer_max_dist_frac: float = 0.15   # edits allowed per primer length
    #   (0.15 separates true primer hits, ~0-3 edits at ONT error rates,
    #   from adapter-remnant-anchored partial matches at ~10+ edits)
    trim_window: int = 150               # nt searched at each read end
    dorado_trim_subsample_fastq: int | None = None
    minimal_length: int = 1470
    max_ee_rate_base: float = 0.07

    # --- alignment / region split (minimap2_align.py, region_split.py) ---
    minimal_region_overlap: float = 0.95
    max_softclip_5_end: int = 81
    max_softclip_3_end: int = 76
    sw_band_width: int = 128
    #   banded-SW lanes around the length-centered diagonal. Same-read drift
    #   is a random indel walk: std ≈ sqrt(L * indel_rate) ≈ 11 nt over 2 kb
    #   at ONT rates, so ±64 is >5 sigma; halving from 256 halves the
    #   dominant fused-pass kernel's per-row work (bench exactness and
    #   assignment accuracy are the guard)

    # --- UMI extraction (extract_umis.py:19-107) ---
    umi_fwd: str = "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT"
    umi_rev: str = "AAABBBBAABBBBAABBBBAABBBBAABBAAA"
    max_pattern_dist: int = 3
    min_umi_length: int = 58
    max_umi_length: int = 68

    # --- UMI clustering round 1 (vsearch_umi_cluster.py:21-54) ---
    vsearch_identity: float = 0.93
    min_reads_per_cluster: int = 4
    max_reads_per_cluster: int = 60
    balance_strands: bool = False

    # --- UMI cross-region audit (extract_umis.py:345-369) ---
    compare_umi_overlap_between_regions: bool = False
    overlapping_umi_edit_threshold: int = 1

    # --- consensus round 2 (tcr_consensus.py:356-444) ---
    minimal_region_overlap_consensus: float | None = None
    blast_id_threshold: float | None = None
    vsearch_identity_consensus: float = 0.97

    # --- polishing ---
    # "poa" = draft consensus only; "rnn" = draft + Flax polisher pass.
    # Default is "rnn", matching the reference's medaka precision stage.
    # The v3 polisher trains on a randomized family of systematic ONT
    # error regimes and is evaluated on HELD-OUT regimes so the eval can
    # fail off-distribution (models/weights/polisher_v3_eval.json,
    # n=250/depth/regime on 1.6 kb templates): in-family 8.4%->33% exact
    # at depth 4, 43%->79% at 6, 84%->90% at 10; on the held-out
    # homopolymer-shifted regime 31%->78% at depth 10 where voting
    # collapses; at iid depth 10, where voting is already optimal, the
    # gate fires 0%. At SERVED depths (>= min_polish_depth) broke <= 9/250
    # in every regime; the eval's depth-3 rows (measured at eval gate 3,
    # see the JSON's _meta) are NET-NEGATIVE on held-out regimes (up to
    # 20/250 broke on iid) — that is the evidence for keeping the serving
    # gate at 4. Regenerate via
    # `python -m ont_tcrconsensus_tpu.models.train --v3`.
    polish_method: str = "rnn"
    min_polish_depth: int = 4  # clusters with fewer subreads keep the vote
    #   consensus; the per-regime depth-3 tradeoff (fixed vs broke) is
    #   measured in models/weights/polisher_v3_eval.json — lower to 3 when
    #   the bundled weights' eval shows fixed >> broke there
    # Depth-2 polish pass below the gate: exactly-2-subread clusters' vote
    # consensus fails the round-2 blast-id bar ~99% of the time and the
    # v4-family weights recover a measured fraction (evidence:
    # models/weights/polisher_depth_gate_blastid.json); cannot touch any
    # other cluster. Structurally inert unless min_reads_per_cluster <= 2
    # (selection never emits 2-member clusters otherwise), and run.py only
    # pays its costs when it can actually fire.
    low_depth_polish: bool = True

    # --- TPU execution (new; no reference analogue) ---
    hbm_budget_gb: float | None = None  # None -> detect chip HBM (the one
    #   scheduler knob; batch sizes derive from it — parallel/budget.py,
    #   replacing the reference's medaka memory model)
    read_batch_size: int | None = None  # None -> derived from hbm_budget_gb
    cluster_batch_size: int | None = None  # None -> derived per tile shape
    umi_batch_size: int = 4096        # UMIs per distance-matrix tile
    max_read_length: int = 4096       # padded read width cap
    round2_targeted_assign: bool = True  # align consensus only against its
    #   round-1 region cluster's refs (skip sketch/strand re-derivation);
    #   False restores the full fused pass for round 2
    round1_fast_assign: bool = True   # SW only the needy quarter of each
    #   round-1 batch (sketch-confident reads synthesize their filter
    #   inputs — assign.py fast path, DIVERGENCES #12); False restores
    #   full-batch SW in round 1
    mesh_shape: dict[str, int] | None = None  # e.g. {"data": 8}
    distributed: bool = False         # multi-host: jax.distributed init +
    #   shard-by-barcode across processes (parallel/distributed.py)
    resume: bool = False              # stage-level resume from manifest
    write_intermediate_fastas: bool = True  # per-stage fasta artifacts
    profile_trace_dir: str | None = None
    #   when set, the whole run is wrapped in a jax.profiler trace written
    #   there (one subdir per process) — open with TensorBoard/Perfetto to
    #   see per-kernel device time, HBM traffic and host gaps; the
    #   device-level complement of logs/stage_timing.tsv
    telemetry: str = "on"  # unified telemetry layer (obs/): "off" disarms
    #   everything (planted sites are one module-attr check); "on"
    #   (default) arms the cheap counters, the per-dispatch-site host-gap/
    #   block split, the XLA recompile audit and the memory high-water
    #   one-shot, rolled up into a per-run nano_tcr/telemetry.json; "full"
    #   additionally records the Chrome-trace timeline (logs/trace.json —
    #   stage spans per thread + instant events for every robustness
    #   occurrence) and runs the periodic HBM/RSS sampler. Render with
    #   `tcr-consensus-tpu --report <workdir>`
    live_port: int | None = None  # live observability plane (obs/live.py):
    #   when set, the run serves read-only GET endpoints on
    #   127.0.0.1:<live_port> for its duration — /healthz (liveness +
    #   watchdog heartbeat-staleness verdict), /metrics (Prometheus text
    #   exposition of the armed registry + live per-stage heartbeat ages)
    #   and /progress (current library/node, nodes done/total, ETA from
    #   history-ledger priors) — and arms the crash flight recorder (a
    #   bounded span/robustness/heartbeat ring flushed atomically to
    #   nano_tcr/logs/flight_recorder.json on crash, SIGTERM drain,
    #   watchdog hard expiry, or SIGUSR1). 0 binds an OS-chosen ephemeral
    #   port (tests). null (default) disarms the whole plane: the planted
    #   sites are one module-attr check and nothing ever listens. Binds
    #   loopback only and serves no mutating route; excluded from the
    #   config fingerprint (observation, not workload)
    compile_cache_dir: str | None = None  # persistent XLA compilation cache
    #   (jax_compilation_cache_dir): null (default) uses
    #   ~/.cache/ont_tcrconsensus_tpu_xla, any other string is used as the
    #   cache directory, and "off" disables the persistent cache entirely.
    #   A warm-serving daemon (serve/) points this at durable storage so a
    #   restarted daemon reloads executables instead of recompiling.
    #   Excluded from the config fingerprint (an executable cache location,
    #   not a workload knob)
    serve_queue_max: int = 8  # daemon mode only (serve/queue.py): bounded
    #   tenant job queue depth; a submit beyond this is rejected with
    #   reason "queue_full" instead of queued unboundedly. Ignored by
    #   one-shot runs; excluded from the config fingerprint
    serve_workers: int = 1  # daemon mode only (serve/daemon.py +
    #   serve/slices.py): runner-pool width. 1 (default) keeps the serial
    #   one-job-at-a-time loop; >1 packs up to this many concurrent tenant
    #   jobs onto disjoint pow2 device slices, each under its own mesh and
    #   fault-isolation scope. Ignored by one-shot runs; excluded from the
    #   config fingerprint
    serve_prewarm: bool = True  # daemon mode only (serve/prewarm.py): AOT
    #   lower+compile the fused-assign (and polisher, when weights are
    #   bundled) entry points for the declared width buckets at daemon
    #   start, so the first job pays no compile latency. False skips the
    #   prewarm (first job compiles lazily). Ignored by one-shot runs;
    #   excluded from the config fingerprint
    history_ledger: str | None = None  # opt-in CROSS-run ledger path (e.g.
    #   a repo-level BENCH_HISTORY.jsonl): every telemetry-armed run
    #   appends its history entry there in addition to the per-run
    #   nano_tcr/history.jsonl (obs/history.py) — the baseline pool
    #   scripts/perf_gate.py gates new runs against. Excluded from the
    #   config fingerprint (it is a location, not a workload knob)
    error_profile_sample: int = 512  # reads/library profiled for the cs-tag
    #   error artifact (qc/error_profile.py); 0 disables. 512 resolves any
    #   motif above ~1% of reads in the top-40 dump; raise for deeper audits
    overlap_qc: bool = True  # run the error-profile passes on worker
    #   threads overlapped with round-1 polish / round-2 clustering
    #   (pipeline/overlap.py); artifacts stay byte-identical — False
    #   restores the fully serial stage order. Under executor="graph" this
    #   only gates the worker pool: WHICH stages overlap is derived from
    #   edge consumption in the stage graph (graph/pipeline.py)
    executor: str = "graph"  # per-library scheduler: "graph" (default)
    #   or "imperative". The JAX package pins the two byte-identical; the
    #   port has no graph executor yet and runs the imperative stage order
    #   (pipeline/run.py) for either value
    # --- robustness (robustness/; new, no reference analogue) ---
    retry_max_attempts: int = 3  # total attempts per dispatch site for
    #   TRANSIENT-classified failures (device/transport faults): 3 = one
    #   dispatch + two backoff retries. Deterministic bugs never retry;
    #   HBM OOM instead re-derives a shrunken batch from parallel/budget.py
    #   and requeues (stages.polish_clusters_all)
    retry_base_delay_s: float = 0.1  # first backoff delay; doubles per
    #   attempt (jittered, capped at 5 s — robustness/retry.RetryPolicy)
    chaos: list | None = None  # fault-injection plan: list of spec dicts
    #   ({"site": ..., "kind": ..., "skip": ..., "times": ...};
    #   robustness/faults.py) armed at run start. The TCR_CHAOS env var
    #   arms the same way when this key is null. None/[] = chaos off
    #   (injection points are a single global check)
    chaos_seed: int = 0  # seed for probabilistic ("p") chaos specs
    on_bad_record: str = "fail"  # data-fault policy for malformed input
    #   records (io/validate.py): "fail" keeps the legacy first-bad-record-
    #   raises behavior; "quarantine" resynchronizes at the next record and
    #   lands the bad bytes in a per-library quarantine.fastq.gz with
    #   machine-readable reasons in robustness_report.json; "drop" counts +
    #   reports without keeping the bytes. Truncated gzip and truncated
    #   final records become quarantine events instead of tracebacks.
    stage_timeout_s: float | None = None  # liveness watchdog
    #   (robustness/watchdog.py): base HARD deadline per pipeline stage,
    #   measured from the stage's last heartbeat and auto-scaled by
    #   workload size (base covers 1000 work units; larger workloads scale
    #   linearly — watchdog.scaled_timeout). At half the hard deadline a
    #   stall event + all-thread stack dump land in the robustness report /
    #   library log; at the hard deadline the stalled stage is cancelled
    #   with a StageTimeout, which retries as a transient fault. None
    #   (default) disarms the watchdog entirely (heartbeats are one global
    #   check). Size for the SLOWEST legitimate single dispatch including
    #   cold compiles — e.g. 600 for production lanes
    verify_resume: str = "fast"  # resume integrity checking against the
    #   v2 stage manifest's recorded artifact checksums (io/layout.py):
    #   "off" trusts the manifest mark alone (legacy blind-trust), "fast"
    #   (default) checks artifact byte sizes (catches truncation/missing
    #   files, ~free), "full" re-hashes sha256 (catches any bit rot). A
    #   failed/unverifiable stage (v1 manifest) warns and re-runs instead
    #   of resuming from garbage
    contracts: str = "warn"  # stage-boundary conservation contracts
    #   (robustness/contracts.py): "off" skips the checks, "warn" (default)
    #   logs + records violations in robustness_report.json, "strict"
    #   additionally fails the run on the first violation
    polish_bf16: bool = True  # allow bf16 polisher serving WHEN the
    #   per-backend exactness A/B artifact certifies identical consensus
    #   output (models/polisher.py bf16_serving_certified; generate with
    #   scripts/torch_bf16_ab.py). Without a certifying artifact for this
    #   kind of card — or on the CPU — serving stays fp32 regardless of
    #   this flag; False forces fp32 everywhere

    @property
    def cluster_identity(self) -> float:
        """Region-cluster threshold; reference tcr_consensus.py:68."""
        return 1.0 - self.max_ee_rate_base

    def primer_sequences(self) -> list[str]:
        """Primer set for the trim stage; [] when trimming is disabled."""
        if not self.trim_primers:
            return []
        from ont_tcrconsensus_tpu_torch.io import fastx

        path = self.nanopore_tcr_seq_primers_fasta or DEFAULT_PRIMERS_FASTA
        return [rec.sequence for rec in fastx.read_fastx(path)]

    def validate(self) -> None:
        if not self.reference_file:
            raise ValueError("reference_file is required")
        if not self.fastq_pass_dir:
            raise ValueError("fastq_pass_dir is required")
        for name, lo, hi in (
            ("max_ee_rate_base", 0.0, 1.0),
            ("minimal_region_overlap", 0.0, 1.0),
            ("vsearch_identity", 0.0, 1.0),
            ("vsearch_identity_consensus", 0.0, 1.0),
            ("blast_id_threshold", 0.0, 1.0),                # nullable
            ("minimal_region_overlap_consensus", 0.0, 1.0),  # nullable
        ):
            v = getattr(self, name)
            if v is not None and not (lo <= v <= hi):
                raise ValueError(f"{name}={v} outside [{lo}, {hi}]")
        for name in ("dorado_trim_subsample_fastq",):  # nullable int
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise ValueError(f"{name}={v!r} must be a positive int or null")
        if not isinstance(self.overlapping_umi_edit_threshold, int) or (
            self.overlapping_umi_edit_threshold < 0
        ):
            raise ValueError("overlapping_umi_edit_threshold must be a non-negative int")
        for name in (
            "minimal_length", "max_pattern_dist", "min_umi_length",
            "max_umi_length", "min_reads_per_cluster", "max_reads_per_cluster",
            "min_polish_depth",
            "umi_batch_size", "max_read_length",
            "max_softclip_5_end", "max_softclip_3_end",
        ):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"{name}={v!r} must be a non-negative int")
        if not isinstance(self.error_profile_sample, int) or self.error_profile_sample < 0:
            raise ValueError(
                f"error_profile_sample={self.error_profile_sample!r} must be a "
                "non-negative int"
            )
        for name in ("read_batch_size", "cluster_batch_size"):  # nullable int
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise ValueError(f"{name}={v!r} must be a positive int or null")
        if self.hbm_budget_gb is not None and not (
            isinstance(self.hbm_budget_gb, (int, float)) and self.hbm_budget_gb > 0
        ):
            raise ValueError(
                f"hbm_budget_gb={self.hbm_budget_gb!r} must be a positive number or null"
            )
        if not (0.0 <= self.primer_max_dist_frac <= 1.0):
            raise ValueError(
                f"primer_max_dist_frac={self.primer_max_dist_frac} outside [0, 1]"
            )
        if not isinstance(self.trim_window, int) or self.trim_window <= 0:
            raise ValueError(f"trim_window={self.trim_window!r} must be a positive int")
        if not isinstance(self.sw_band_width, int) or self.sw_band_width not in SW_BAND_WIDTHS:
            raise ValueError(
                f"sw_band_width={self.sw_band_width!r} must be one of "
                f"{SW_BAND_WIDTHS}: the band widths the port's SW kernel "
                "(csrc/sw_banded.cu) is built for"
            )
        if self.trim_primers and self.nanopore_tcr_seq_primers_fasta:
            if not os.path.exists(self.nanopore_tcr_seq_primers_fasta):
                raise ValueError(
                    f"primers fasta not found: {self.nanopore_tcr_seq_primers_fasta}"
                )
        if self.min_umi_length > self.max_umi_length:
            raise ValueError("min_umi_length > max_umi_length")
        if self.min_reads_per_cluster > self.max_reads_per_cluster:
            raise ValueError("min_reads_per_cluster > max_reads_per_cluster")
        if not isinstance(self.retry_max_attempts, int) or self.retry_max_attempts < 1:
            raise ValueError(
                f"retry_max_attempts={self.retry_max_attempts!r} must be a "
                "positive int (1 = no retries)"
            )
        if not isinstance(self.retry_base_delay_s, (int, float)) or (
            self.retry_base_delay_s < 0
        ):
            raise ValueError(
                f"retry_base_delay_s={self.retry_base_delay_s!r} must be a "
                "non-negative number"
            )
        if self.chaos is not None:
            if not isinstance(self.chaos, list) or not all(
                isinstance(s, dict) for s in self.chaos
            ):
                raise ValueError("chaos must be null or a list of fault-spec dicts")
        if self.polish_method not in ("poa", "rnn"):
            raise ValueError(f"polish_method={self.polish_method!r} not in ('poa', 'rnn')")
        if self.on_bad_record not in ("fail", "quarantine", "drop"):
            raise ValueError(
                f"on_bad_record={self.on_bad_record!r} not in "
                "('fail', 'quarantine', 'drop')"
            )
        if self.contracts not in ("off", "warn", "strict"):
            raise ValueError(
                f"contracts={self.contracts!r} not in ('off', 'warn', 'strict')"
            )
        if self.stage_timeout_s is not None and not (
            isinstance(self.stage_timeout_s, (int, float))
            and self.stage_timeout_s > 0
        ):
            raise ValueError(
                f"stage_timeout_s={self.stage_timeout_s!r} must be a "
                "positive number or null (null = watchdog disarmed)"
            )
        if self.verify_resume not in ("off", "fast", "full"):
            raise ValueError(
                f"verify_resume={self.verify_resume!r} not in "
                "('off', 'fast', 'full')"
            )
        if self.executor not in ("graph", "imperative"):
            raise ValueError(
                f"executor={self.executor!r} not in ('graph', 'imperative')"
            )
        if self.telemetry not in ("off", "on", "full"):
            raise ValueError(
                f"telemetry={self.telemetry!r} not in ('off', 'on', 'full')"
            )
        if self.live_port is not None and (
            not isinstance(self.live_port, int)
            or isinstance(self.live_port, bool)
            or not (0 <= self.live_port <= 65535)
        ):
            raise ValueError(
                f"live_port={self.live_port!r} must be an int in [0, 65535] "
                "(0 = ephemeral) or null (null = live plane disarmed)"
            )
        if self.history_ledger is not None and (
            not isinstance(self.history_ledger, str) or not self.history_ledger
        ):
            raise ValueError(
                f"history_ledger={self.history_ledger!r} must be a non-empty "
                "path string or null"
            )
        if self.compile_cache_dir is not None and (
            not isinstance(self.compile_cache_dir, str)
            or not self.compile_cache_dir
        ):
            raise ValueError(
                f"compile_cache_dir={self.compile_cache_dir!r} must be a "
                "non-empty path string, \"off\" (cache disabled) or null "
                "(null = the default ~/.cache path)"
            )
        if not isinstance(self.serve_queue_max, int) or (
            isinstance(self.serve_queue_max, bool) or self.serve_queue_max < 1
        ):
            raise ValueError(
                f"serve_queue_max={self.serve_queue_max!r} must be a "
                "positive int"
            )
        if not isinstance(self.serve_workers, int) or (
            isinstance(self.serve_workers, bool) or self.serve_workers < 1
        ):
            raise ValueError(
                f"serve_workers={self.serve_workers!r} must be a "
                "positive int"
            )
        for pat_name in ("umi_fwd", "umi_rev"):
            pat = getattr(self, pat_name)
            if not pat or any(c not in "ACGTUNRYSWKMBDHV" for c in pat.upper()):
                raise ValueError(f"{pat_name}={pat!r} contains non-IUPAC characters")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RunConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        clean: dict[str, Any] = {}
        for k, v in d.items():
            if k in _COMPAT_IGNORED:
                continue
            if k not in known:
                raise ValueError(f"unknown config key: {k!r}")
            clean[k] = v
        cfg = cls(**clean)
        cfg.validate()
        return cfg

    @classmethod
    def from_json(cls, path: str | os.PathLike[str]) -> "RunConfig":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
