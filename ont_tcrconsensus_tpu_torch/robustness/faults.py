"""Deterministic, seeded fault injection (chaos mode).

A copy of the JAX package's ``robustness/faults.py``: a test, or an
operator through the ``TCR_CHAOS`` environment variable or the ``chaos``
config key, arms named faults at named injection points, and the
pipeline's retry, degradation and resume paths run for real.

========================== ==================================================
site                       planted at
========================== ==================================================
``assign.dispatch``        the fused pass's batch loop (pipeline/assign.py,
                           ``run_assign``)
``polish.dispatch``        the consensus/polish chunk dispatch
                           (pipeline/stages.py, ``polish_clusters_all``)
``cluster.batched_round1`` the library-wide batched UMI clustering pass,
``cluster.batched_round2`` rounds 1 / 2 (pipeline/run.py, graph/nodes.py)
``overlap.worker``         the background stage's worker body
                           (pipeline/overlap.py)
``layout.manifest_write``  the stage-manifest write (io/layout.py); the
                           ``torn`` kind tears the file mid-write
``run.round1_checkpoint``  right after the round-1 consensus checkpoint
                           commits: the mid-stage ``kill``/``preempt`` site
``ingest.library_fastq``   the library's input file (file-level kinds)
``resume.verify``          a completed artifact before resume verifies it
``graph.node``             every critical-path node body under the graph
                           executor (graph/executor.py)
``mesh.dispatch``          the sharded dispatch boundary: shard placement
                           (parallel/mesh.py, ``shard_batch``) and the
                           engines' sharded passes (pipeline/assign.py); a
                           ``transient`` rides the bounded-retry ladder
``mesh.device_lost``       before each polish chunk under a mesh
                           (pipeline/stages.py): a ``device-lost`` escalates
                           to the graph executor's degraded-mesh re-run
``mesh.slice_oom``         the same place: an ``oom`` takes the chunk's
                           shrink-and-requeue path, the mesh kept whole
``serve.job_run``          the daemon's per-job dispatch, just before the
                           pipeline runs (serve/daemon.py): the entry of
                           the retry/poison ladder
``serve.job_slow``         a slow tenant job: a ``stall`` inside a
                           serve-level watchdog guard (serve/daemon.py),
                           cancelled into a transient retry
``serve.daemon_loop``      the accept loop between pop and dispatch
                           (serve/daemon.py): an ``error`` escapes the loop,
                           whose drain still journals the popped job and
                           flushes the flight recorder
``serve.journal_write``    the drain-journal commit (serve/queue.py);
                           ``torn`` tears the journal mid-write
``serve.prewarm``          the warm-up launches (serve/daemon.py): a failed
                           prewarm is a report line, never a dead daemon
``serve.slice_assign``     the slice allocator's carve, before any pool
                           mutation (serve/slices.py)
``serve.slice_lost``       the packed worker between slice assignment and
                           dispatch (serve/daemon.py): ``device-lost``
                           quarantines the tenant's slice and requeues it
``serve.pack``             the allocator's release, after the devices are
                           back in the pool (serve/slices.py)
========================== ==================================================

:data:`UNPLANTED` names the site families a later slice of the port
plants (none now): arming one raises ``NotImplementedError``.

Kinds: ``transient`` (:class:`TransientChaosError`, classified retryable),
``oom`` (:class:`OomChaosError`: shrink and retry), ``device-lost``
(:class:`DeviceLostChaosError`), ``error`` (a plain ``RuntimeError``: a
deterministic bug, never retried), ``kill`` (``os._exit(137)``, no
flushes), ``preempt`` (requests the active shutdown coordinator's stop),
``torn`` (a half-written file at :func:`tear_write` sites), the file-level
``corrupt-input`` / ``truncate-file`` (:func:`mutate_input`), the liveness
kinds ``stall`` (a sliced Python sleep the watchdog cancels promptly) and
``hang`` (one long C-level sleep, cancelled when it returns), and
``corrupt-artifact`` (:func:`corrupt_artifact`).

A spec fires on exact hit counts (``skip`` pass-throughs, then ``times``
fires) or with probability ``p`` from a generator seeded by ``(plan seed,
site)``, so a plan replays identically. Disarmed, :func:`inject` is one
global check. Every firing is a ``chaos.inject`` trace instant.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import threading
import time

from ont_tcrconsensus_tpu_torch.obs import trace as obs_trace
from ont_tcrconsensus_tpu_torch.robustness import jobscope

ENV_VAR = "TCR_CHAOS"

#: ``corrupt-input`` / ``truncate-file`` are FILE-level data faults: they
#: fire through :func:`mutate_input` at ingest sites (the pipeline reads a
#: seeded-mutated sibling copy of the input file; the original is never
#: touched), exercising the record-quarantine path end to end.
#: ``corrupt-input`` splices malformed records BETWEEN the real ones, so
#: with ``on_bad_record=quarantine`` the clean-read subset — and therefore
#: every downstream artifact — must stay byte-identical to an uncorrupted
#: run. ``truncate-file`` cuts the file mid-stream (for ``.gz`` inputs:
#: mid gzip stream), losing the tail.
#: ``stall`` / ``hang`` are LIVENESS faults: the injection point stops
#: making progress instead of raising, and only the stage watchdog
#: (robustness/watchdog.py, config ``stage_timeout_s``) can end it.
#: ``stall`` wedges in an interruptible Python loop (the watchdog's
#: hard-deadline cancel lands promptly); ``hang`` wedges in ONE long
#: C-level call, like a hung device call — detected and stack-dumped on
#: time, cancelled only when the call returns. ``corrupt-artifact`` is a
#: RESUME-integrity fault: it flips a byte of a completed stage's artifact
#: in place (size-preserving, so only ``verify_resume=full`` checksums can
#: catch it) through :func:`corrupt_artifact` at ``resume.verify``.
KINDS = ("transient", "oom", "device-lost", "error", "kill", "preempt",
         "torn", "corrupt-input", "truncate-file", "stall", "hang",
         "corrupt-artifact")

#: every injection point planted in the pipeline; arming an unknown site is
#: an error so chaos-plan typos fail fast instead of silently never firing
KNOWN_SITES = frozenset({
    "assign.dispatch",
    "polish.dispatch",
    "cluster.batched_round1",
    "cluster.batched_round2",
    "overlap.worker",
    "layout.manifest_write",
    "run.round1_checkpoint",
    "ingest.library_fastq",
    "resume.verify",
    "graph.node",
    "serve.job_run",
    "serve.job_slow",
    "serve.daemon_loop",
    "serve.journal_write",
    "serve.prewarm",
    "serve.slice_assign",
    "serve.slice_lost",
    "serve.pack",
    "mesh.dispatch",
    "mesh.device_lost",
    "mesh.slice_oom",
})

#: sites of the JAX package that later slices of the port plant, and the
#: slice that brings each family (every family is planted)
UNPLANTED: dict[str, str] = {}

KILL_EXIT_CODE = 137


class TransientChaosError(RuntimeError):
    """Injected transient device/transport fault (retryable)."""


class OomChaosError(RuntimeError):
    """Injected HBM exhaustion (degradable: shrink the batch and retry)."""


class DeviceLostChaosError(RuntimeError):
    """Injected mesh-slice loss (degradable: shrink the data axis to the
    surviving slices and re-dispatch — retrying the dead mesh cannot
    succeed, and no smaller batch fits a device that is gone)."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fire ``times`` times at ``site`` after ``skip``
    pass-through hits (or i.i.d. with probability ``p`` when set)."""

    site: str
    kind: str = "transient"
    skip: int = 0
    times: int = 1
    p: float | None = None
    message: str = ""

    def __post_init__(self):
        if self.site not in KNOWN_SITES:
            raise ValueError(
                f"unknown chaos site {self.site!r}; known: {sorted(KNOWN_SITES)}"
            )
        for prefix, slice_name in UNPLANTED.items():
            if self.site.startswith(prefix):
                raise NotImplementedError(
                    f"chaos site {self.site!r} is planted by {slice_name}"
                )
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; known: {KINDS}")
        if self.p is not None and not (0.0 <= self.p <= 1.0):
            raise ValueError(f"chaos p={self.p} outside [0, 1]")


class FaultPlan:
    """Armed specs + per-site hit/fire counters (thread-safe: injection
    points sit on worker threads too)."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._spec_fired: dict[int, int] = {}
        self._rng: dict[str, random.Random] = {}

    def hit(self, site: str) -> FaultSpec | None:
        """Count one arrival at ``site``; return the spec to fire, if any."""
        with self._lock:
            n = self._hits.get(site, 0)
            self._hits[site] = n + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                fired = self._spec_fired.get(i, 0)
                if spec.times > 0 and fired >= spec.times:
                    continue
                if spec.p is not None:
                    rng = self._rng.setdefault(
                        site, random.Random(f"{self.seed}:{site}")
                    )
                    if rng.random() >= spec.p:
                        continue
                elif n < spec.skip:
                    continue
                self._spec_fired[i] = fired + 1
                self._fired[site] = self._fired.get(site, 0) + 1
                return spec
            return None

    def describe(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs],
                "hits": dict(self._hits),
                "fired": dict(self._fired),
            }


# process-wide plan; under a jobscope (the slice-packed runner pool)
# each tenant job's run arms/disarms a THREAD-SCOPED plan instead, so
# tenant A's chaos declaration can never fire inside (or be disarmed by)
# tenant B's concurrent run. The scope stores a 1-tuple so an explicit
# in-scope disarm (a job declaring "no chaos") tombstones rather than
# falling back to the daemon's serve-scope plan.
_PLAN: FaultPlan | None = None


def _current_plan() -> FaultPlan | None:
    entry = jobscope.get("faults")
    if entry is not None:
        return entry[0]
    return _PLAN


def active() -> bool:
    return _current_plan() is not None


def arm(specs, seed: int = 0) -> FaultPlan:
    """Arm a chaos plan from a list of spec dicts (or FaultSpecs)."""
    global _PLAN
    parsed = [
        s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs
    ]
    plan = FaultPlan(parsed, seed=seed)
    if jobscope.active():
        jobscope.set("faults", (plan,))
    else:
        _PLAN = plan
    return plan


def arm_from_env() -> FaultPlan | None:
    """Arm a FRESH plan from the ``TCR_CHAOS`` env JSON (a spec list, or
    ``{"seed": n, "faults": [...]}``); returns None — leaving any current
    plan untouched — when the variable is unset. Each pipeline run
    re-declares its chaos state (run.py), so an env-armed plan fires anew
    per run and never silently bleeds exhausted counters across runs."""
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    data = json.loads(raw)
    if isinstance(data, dict):
        return arm(data.get("faults", []), seed=int(data.get("seed", 0)))
    return arm(data)


def disarm() -> None:
    global _PLAN
    if jobscope.active():
        jobscope.set("faults", (None,))
        return
    _PLAN = None


def describe() -> dict | None:
    plan = _current_plan()
    return plan.describe() if plan is not None else None


def fired(site: str) -> int:
    """How many times any spec fired at ``site`` (0 when disarmed)."""
    plan = _current_plan()
    if plan is None:
        return 0
    with plan._lock:
        return plan._fired.get(site, 0)


def _note_fire(site: str, kind: str) -> None:
    """Chaos firings become trace instants (no-op below telemetry=full),
    so an injected fault sits on the same timeline as the stage spans and
    the retry/stall events it provokes."""
    obs_trace.instant("chaos.inject", args={"site": site, "kind": kind})


def _fire(spec: FaultSpec, site: str) -> None:
    _note_fire(site, spec.kind)
    msg = spec.message or f"injected {spec.kind} fault at {site}"
    if spec.kind == "transient":
        raise TransientChaosError(f"UNAVAILABLE: {msg}")
    if spec.kind == "oom":
        raise OomChaosError(f"RESOURCE_EXHAUSTED: {msg}")
    if spec.kind == "device-lost":
        raise DeviceLostChaosError(f"DEVICE_LOST: {msg}")
    if spec.kind == "error":
        raise RuntimeError(msg)
    if spec.kind == "kill":
        # a preempted VM does not flush buffers or run atexit hooks;
        # os._exit is the honest simulation of that
        sys.stderr.write(f"CHAOS: killing process at {site}\n")
        sys.stderr.flush()
        os._exit(KILL_EXIT_CODE)
    if spec.kind == "preempt":
        from ont_tcrconsensus_tpu_torch.robustness import shutdown

        shutdown.request(reason=f"chaos preempt at {site}")
        return
    if spec.kind in ("stall", "hang"):
        _stall_until_cancelled(spec.kind, site)
    raise AssertionError(f"unhandled chaos kind {spec.kind!r}")  # pragma: no cover


#: safety cap on an injected stall/hang: if the watchdog is disarmed or
#: dead, the wedge self-reports instead of hanging the test suite forever
STALL_CAP_S = 60.0


def _stall_until_cancelled(kind: str, site: str) -> None:
    """Stop making progress until the watchdog cancels this thread.

    ``stall``: an interruptible Python sleep loop — the watchdog's
    hard-deadline ``StageTimeout`` (PyThreadState_SetAsyncExc) is
    delivered between the slices, promptly. ``hang``: ONE long C-level
    ``time.sleep`` sized past the active hard deadline, like a wedged device
    call — the cancel is queued on time but only lands when the call
    returns. Either way the pending StageTimeout raises at the next
    bytecode after the sleep, so the code below the sleeps is reached
    only when the watchdog never cancelled us.
    """
    from ont_tcrconsensus_tpu_torch.robustness import watchdog

    sys.stderr.write(f"CHAOS: injected {kind} at {site} "
                     "(progress stops; only the watchdog can end this)\n")
    sys.stderr.flush()
    hard = watchdog.active_deadline_s()
    if hard is not None and hard + 2.0 > STALL_CAP_S:
        # the wedge would end BEFORE the watchdog's hard deadline and the
        # fallthrough below would wrongly diagnose a disarmed watchdog —
        # refuse the drill loudly instead
        raise RuntimeError(
            f"injected {kind} at {site}: active hard deadline {hard:.0f}s "
            f"exceeds the {STALL_CAP_S:.0f}s stall safety cap — shrink "
            "stage_timeout_s for this chaos drill"
        )
    if kind == "hang":
        time.sleep((hard or 5.0) + 2.0)
    else:
        deadline = time.monotonic() + STALL_CAP_S
        while time.monotonic() < deadline:
            time.sleep(0.02)
    raise RuntimeError(
        f"injected {kind} at {site} was never cancelled — is the stage "
        f"watchdog armed (stage_timeout_s) and the site inside a guard?"
    )


def inject(site: str) -> None:
    """Raise/kill/preempt per the armed plan; free no-op when disarmed."""
    plan = _current_plan()
    if plan is None:
        return
    spec = plan.hit(site)
    if spec is not None:
        _fire(spec, site)


#: malformed blocks spliced between records by ``corrupt-input``. Each is
#: self-contained damage the tolerant parser quarantines WITHOUT eating a
#: neighboring real record: the junk line resyncs at the next record, the
#: length-mismatch and sub-Phred records consume exactly their own four
#: lines, and the headerless fragment resyncs at the following '@' header.
_CORRUPT_BLOCKS = (
    b"THIS IS NOT A FASTQ LINE \xff\xfe\x00 chaos\n",
    b"@chaos_len_mismatch\nACGTACGT\n+\nIII\n",
    b"@chaos_bad_qual\nACGT\n+\n\x05\x05\x05\x05\n",
    b"@chaos_headerless_fragment\nACGTACGTACGT\n",
)


def _read_file_bytes(path: str) -> tuple[bytes, bool]:
    """(decoded text bytes, was_gzip) — gzip-transparent like the parsers."""
    import gzip

    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw), True
    return raw, False


def _chaos_sibling_path(path: str, tag: str) -> str:
    """Mutated-copy path next to ``path``: '<stem>.<tag>[.gz]'. The name
    must NOT contain 'fastq' — input discovery globs '*fastq*'
    (pipeline/run.py), and a leftover chaos copy must never be picked up
    as an extra library on a later resume."""
    d, base = os.path.split(path)
    # ONT's standard naming puts 'fastq' in the STEM too (fastq_runid_*),
    # so the stem itself must be scrubbed, not just the extensions
    stem = base.split(".")[0].replace("fastq", "fq")
    suffix = ".gz" if path.endswith(".gz") else ""
    return os.path.join(d, f"{stem}.{tag}{suffix}")


def mutate_input(site: str, path: str) -> str:
    """File-level chaos for ingest sites: returns the path to read.

    When a ``corrupt-input`` / ``truncate-file`` spec fires at ``site``, a
    mutated sibling copy is written next to ``path`` (named without
    'fastq' so input discovery never globs it on a resume) and its path is
    returned; the original file is never modified. Other armed kinds fire
    through :func:`_fire` as usual. No-op (returns ``path``) when
    disarmed.
    """
    plan = _current_plan()
    if plan is None:
        return path
    spec = plan.hit(site)
    if spec is None:
        return path
    if spec.kind not in ("corrupt-input", "truncate-file"):
        _fire(spec, site)
        return path
    _note_fire(site, spec.kind)
    import gzip

    rng = random.Random(f"{plan.seed}:{site}:{spec.kind}")
    if spec.kind == "truncate-file":
        # cut the RAW file bytes mid-stream: for .gz inputs this truncates
        # the gzip stream itself (the BadGzipFile/gzread-error path)
        with open(path, "rb") as fh:
            raw = fh.read()
        cut = max(1, int(len(raw) * (0.5 + 0.3 * rng.random())))
        out_path = _chaos_sibling_path(path, "chaos-trunc")
        with open(out_path, "wb") as fh:
            fh.write(raw[:cut])
        sys.stderr.write(f"CHAOS: truncated input copy {out_path} "
                         f"({cut}/{len(raw)} bytes) at {site}\n")
        return out_path
    data, was_gz = _read_file_bytes(path)
    lines = data.splitlines(keepends=True)
    # record boundaries every 4 lines (chaos stages well-formed FASTQ)
    n_rec = len(lines) // 4
    slots = sorted(rng.sample(range(n_rec + 1), k=min(3, n_rec + 1)))
    parts: list[bytes] = []
    prev = 0
    for k, slot in enumerate(slots):
        parts.append(b"".join(lines[prev * 4:slot * 4]))
        parts.append(_CORRUPT_BLOCKS[(k + rng.randrange(len(_CORRUPT_BLOCKS)))
                                     % len(_CORRUPT_BLOCKS)])
        prev = slot
    parts.append(b"".join(lines[prev * 4:]))
    mutated = b"".join(parts)
    out_path = _chaos_sibling_path(path, "chaos-corrupt")
    with open(out_path, "wb") as fh:
        fh.write(gzip.compress(mutated) if was_gz else mutated)
    sys.stderr.write(f"CHAOS: corrupted input copy {out_path} "
                     f"({len(slots)} bad blocks) at {site}\n")
    return out_path


def corrupt_artifact(site: str, path: str) -> bool:
    """Resume-integrity chaos for verification sites: mutate a COMPLETED
    artifact in place, simulating disk/firmware corruption between a run
    and its resume.

    When a ``corrupt-artifact`` spec fires at ``site``, the middle byte of
    ``path`` is flipped to an ASCII digit. Size-preserving on purpose:
    ``verify_resume=fast`` (size check) must MISS it and only ``full``
    (sha256) may catch it — and a digit keeps a counts CSV parseable, so
    ``verify_resume=off`` demonstrates true blind trust (valid-looking
    garbage flows through) instead of a parse crash. Returns True when it
    fired; other armed kinds at the site fire through :func:`_fire`.
    """
    plan = _current_plan()
    if plan is None:
        return False
    spec = plan.hit(site)
    if spec is None:
        return False
    if spec.kind != "corrupt-artifact":
        _fire(spec, site)
        return False
    _note_fire(site, spec.kind)
    if not os.path.exists(path):
        sys.stderr.write(f"CHAOS: corrupt-artifact at {site}: {path} "
                         "does not exist; nothing to corrupt\n")
        return False
    with open(path, "r+b") as fh:
        data = fh.read()
        if not data:
            sys.stderr.write(f"CHAOS: corrupt-artifact at {site}: {path} "
                             "is empty; nothing to corrupt\n")
            return False
        pos = len(data) // 2
        new = b"7" if data[pos:pos + 1] != b"7" else b"8"
        fh.seek(pos)
        fh.write(new)
    sys.stderr.write(f"CHAOS: corrupted artifact {path} "
                     f"(byte {pos} -> {new!r}) at {site}\n")
    return True


def tear_write(site: str, path: str, payload: str) -> bool:
    """Torn-write injection for file-commit sites.

    Returns True when a ``torn`` fault fired: the first half of ``payload``
    was written DIRECTLY to ``path`` (no tmp + rename), simulating a crash
    mid-write — the caller must skip its own atomic write. Other armed
    kinds at the site fire through :func:`_fire` as usual.
    """
    plan = _current_plan()
    if plan is None:
        return False
    spec = plan.hit(site)
    if spec is None:
        return False
    if spec.kind != "torn":
        _fire(spec, site)
        return False
    _note_fire(site, spec.kind)
    with open(path, "w") as fh:
        fh.write(payload[: max(1, len(payload) // 2)])
    sys.stderr.write(f"CHAOS: tore write of {path} at {site}\n")
    return True
