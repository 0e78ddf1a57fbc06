"""Bounded tenant job queue with device-memory admission control.

A copy of the JAX package's ``serve/queue.py``. FIFO order (tenants share
the card, fairness is arrival order), a hard depth bound, and admission
from the same :class:`~..parallel.budget.BudgetModel` arithmetic the
pipeline sizes its batches with: a job whose requested shapes cannot fit
the budget even at the minimum batch is refused at submit time with a
machine-readable reason, not accepted and run out of memory later. The
arithmetic is the JAX package's byte model, kept as it is so that both
packages take the same decisions; it leaves out the ``rnn`` polisher's
own peak, which the card's measured peak shows beside the estimate.

Queue state is observable two ways: counters, gauges and histograms in
the armed metrics registry (``serve.submitted``, ``serve.rejected``,
``serve.queue_depth``, ``serve.wait_s``: the live plane's ``/metrics``
shows them between and during jobs), and the drain journal
(:func:`write_journal` / :func:`load_journal`): queued and requeued jobs
survive the process and a restarted daemon resumes them. A job that
exhausts its retries, or fails fatally, is recorded in the poison file
(:func:`append_poison`).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import threading
import time

from ont_tcrconsensus_tpu_torch.io import bucketing
from ont_tcrconsensus_tpu_torch.obs import metrics
from ont_tcrconsensus_tpu_torch.parallel.budget import BudgetModel
from ont_tcrconsensus_tpu_torch.robustness import faults
from ont_tcrconsensus_tpu_torch.robustness import lockcheck

JOURNAL_SCHEMA = 1
JOURNAL_BASENAME = "serve_journal.json"
POISON_SCHEMA = 1
POISON_BASENAME = "serve_poison.json"

#: jobs remembered after they leave the queue (done/failed/rejected) so
#: ``GET /jobs/<id>`` keeps answering; oldest-first eviction past this
MAX_FINISHED_REMEMBERED = 64


class AdmissionError(Exception):
    """A job the queue refuses to accept; ``reason`` is machine-readable
    (``queue_full`` / ``invalid_config`` / ``over_budget`` / ...)."""

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}: {detail}")


@dataclasses.dataclass
class Job:
    """One tenant submission: raw config overrides plus lifecycle state.

    ``raw`` is the tenant's JSON object as submitted (merged over the
    daemon's template config at run time); lifecycle timestamps are wall
    seconds. States: queued -> running -> done | failed | poisoned;
    requeued (drain journaled the job mid-queue; resumes with
    ``resume=true`` forced). ``attempts`` counts executions for the
    retry/poison ladder; ``not_before`` (monotonic seconds) is the retry
    backoff gate the pop side respects — neither survives the drain
    journal, so a restart retries a carried job from attempt 0.
    """

    id: str
    raw: dict
    state: str = "queued"
    submitted_t: float = 0.0
    started_t: float | None = None
    finished_t: float | None = None
    error: str | None = None
    result: dict | None = None
    wait_s: float | None = None
    first_stage_s: float | None = None
    attempts: int = 0
    not_before: float = 0.0

    def snapshot(self) -> dict:
        return {
            "id": self.id,
            "state": self.state,
            "submitted_t": round(self.submitted_t, 3),
            "started_t": (round(self.started_t, 3)
                          if self.started_t is not None else None),
            "finished_t": (round(self.finished_t, 3)
                           if self.finished_t is not None else None),
            "wait_s": (round(self.wait_s, 3)
                       if self.wait_s is not None else None),
            "first_stage_s": (round(self.first_stage_s, 3)
                              if self.first_stage_s is not None else None),
            "error": self.error,
            "result": self.result,
        }


def estimate_admission(cfg, budget: BudgetModel) -> tuple[bool, str]:
    """(admissible, detail) for a validated config against the budget.

    Mirrors the shapes :func:`~..pipeline.run.resolve_batching` and the
    polish tiler actually allocate: the fused read pass at the requested
    (or minimum derivable) read batch, and one polish cluster tile at the
    config's subread bucket. Estimation only — the run still sizes its
    real batches from the same model, so an admitted job cannot exceed
    what admission measured.
    """
    # bucket_width is None past the largest declared width: batches of
    # longer reads pad to max_read_length itself
    width = bucketing.bucket_width(cfg.max_read_length) or cfg.max_read_length
    per_read = budget.read_bytes(width, band_width=cfg.sw_band_width)
    if cfg.read_batch_size is not None:
        need = per_read * cfg.read_batch_size
        if need > budget.budget_bytes:
            return False, (
                f"read_batch_size={cfg.read_batch_size} at width {width} "
                f"needs ~{need / 1e9:.2f} GB > working budget "
                f"{budget.budget_bytes / 1e9:.2f} GB"
            )
    elif per_read * 128 > budget.budget_bytes:
        return False, (
            f"max_read_length={cfg.max_read_length} (width {width}) cannot "
            f"fit even the minimum 128-read batch in the working budget "
            f"{budget.budget_bytes / 1e9:.2f} GB"
        )
    s_bucket = bucketing.pow2_ceil(max(cfg.max_reads_per_cluster, 1))
    if budget.cluster_bytes(s_bucket, width) > budget.budget_bytes:
        return False, (
            f"one polish tile of {s_bucket} subreads x width {width} "
            f"exceeds the working budget {budget.budget_bytes / 1e9:.2f} GB"
        )
    return True, "fits"


class JobQueue:
    """Bounded FIFO with admission control and a drain journal.

    Thread contract: the HTTP handler threads submit and snapshot; the
    daemon loop pops and mutates job state through :meth:`mark`. One lock
    guards every structure (declared in robustness/locks.py for the lock
    analyzers); the condition wakes the pop side on submit/requeue.
    """

    def __init__(self, max_depth: int, budget: BudgetModel):
        self.max_depth = int(max_depth)
        self.budget = budget
        self._lock = lockcheck.make_lock()
        self._nonempty = threading.Condition(self._lock)
        self.pending: list[Job] = []
        self.jobs: dict[str, Job] = {}
        self.finished_order: list[str] = []
        self._seq = itertools.count(1)

    # --- submit side (HTTP handler threads) -------------------------------

    def submit(self, raw: dict, cfg) -> Job:
        """Admit ``raw`` (already merged + validated into ``cfg``) or
        raise :class:`AdmissionError`. Plants the queue metrics either
        way — a rejection storm must be visible on /metrics."""
        ok, detail = estimate_admission(cfg, self.budget)
        with self._lock:
            if not ok:
                metrics.counter_add("serve.rejected")
                metrics.reject_add("over_budget")
                raise AdmissionError("over_budget", detail)
            if len(self.pending) >= self.max_depth:
                metrics.counter_add("serve.rejected")
                metrics.reject_add("queue_full")
                raise AdmissionError(
                    "queue_full",
                    f"queue depth {len(self.pending)} at serve_queue_max="
                    f"{self.max_depth}",
                )
            job = Job(id=f"job-{next(self._seq):04d}", raw=dict(raw),
                      submitted_t=time.time())
            self.pending.append(job)
            self.jobs[job.id] = job
            metrics.counter_add("serve.submitted")
            metrics.gauge_set("serve.queue_depth", len(self.pending))
            self._nonempty.notify()
            return job

    def reject(self, reason: str, detail: str) -> AdmissionError:
        """Count + build an admission error for daemon-side rejections
        (invalid config, draining) so every refusal path meters alike."""
        metrics.counter_add("serve.rejected")
        metrics.reject_add(reason)
        return AdmissionError(reason, detail)

    # --- pop side (daemon loop) -------------------------------------------

    def pop(self, timeout: float | None = None) -> Job | None:
        """Next ELIGIBLE job in FIFO order (state -> running), or None on
        timeout. A job whose retry backoff (``not_before``) has not
        elapsed is skipped — later arrivals run ahead of it, so one
        backing-off job never stalls the loop; among eligible jobs order
        stays strictly FIFO."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                now = time.monotonic()
                idx = next((i for i, j in enumerate(self.pending)
                            if j.not_before <= now), None)
                if idx is not None:
                    job = self.pending.pop(idx)
                    job.state = "running"
                    job.started_t = time.time()
                    job.wait_s = job.started_t - job.submitted_t
                    metrics.observe("serve.wait_s", job.wait_s)
                    metrics.gauge_set("serve.queue_depth", len(self.pending))
                    return job
                wait = None if deadline is None else deadline - now
                if wait is not None and wait <= 0:
                    return None
                if self.pending:
                    # everything queued is backing off: sleep only until
                    # the earliest gate opens (or the caller's timeout)
                    gate = min(j.not_before for j in self.pending) - now
                    gate = max(gate, 0.005)
                    wait = gate if wait is None else min(wait, gate)
                self._nonempty.wait(wait)

    def requeue_front(self, job: Job) -> None:
        """Put a drained in-flight job back at the head (state ->
        requeued; the journal writes it first so restart order is FIFO)."""
        with self._lock:
            job.state = "requeued"
            metrics.counter_add("serve.requeued")
            self.pending.insert(0, job)
            metrics.gauge_set("serve.queue_depth", len(self.pending))
            self._nonempty.notify()

    def requeue_back(self, job: Job, *, delay_s: float = 0.0) -> None:
        """Put a transiently-failed job back at the tail with a retry
        backoff (state -> queued); the pop side skips it until
        ``not_before`` so other tenants' jobs run in the meantime."""
        with self._lock:
            job.state = "queued"
            job.not_before = time.monotonic() + max(float(delay_s), 0.0)
            metrics.counter_add("serve.retried")
            self.pending.append(job)
            metrics.gauge_set("serve.queue_depth", len(self.pending))
            self._nonempty.notify()

    def mark(self, job: Job, state: str, *, error: str | None = None,
             result: dict | None = None) -> None:
        """Terminal transition (done/failed/poisoned) + bounded finished
        memory."""
        with self._lock:
            job.state = state
            job.finished_t = time.time()
            job.error = error
            job.result = result
            if state == "done":
                metrics.counter_add("serve.done")
            elif state == "poisoned":
                metrics.counter_add("serve.poisoned")
            else:
                metrics.counter_add("serve.failed")
            self.finished_order.append(job.id)
            while len(self.finished_order) > MAX_FINISHED_REMEMBERED:
                dead = self.finished_order.pop(0)
                self.jobs.pop(dead, None)

    # --- observation -------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return len(self.pending)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [j.snapshot() for j in self.jobs.values()]

    def job(self, job_id: str) -> Job | None:
        with self._lock:
            return self.jobs.get(job_id)

    def drain_jobs(self) -> list[Job]:
        """Every not-yet-terminal job in resume order (requeued in-flight
        first, then FIFO pending) for the drain journal."""
        with self._lock:
            return list(self.pending)


# Every table of JobQueue is guarded by its _lock (the port's lock table,
# robustness/locks.py, which lockcheck reads).


# --- drain journal ------------------------------------------------------------


def journal_path(state_dir: str) -> str:
    return os.path.join(state_dir, JOURNAL_BASENAME)


def write_journal(state_dir: str, jobs: list[Job]) -> str | None:
    """Atomically journal ``jobs`` for a restarted daemon; removes any
    stale journal (and returns None) when there is nothing to carry."""
    path = journal_path(state_dir)
    if not jobs:
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    os.makedirs(state_dir, exist_ok=True)
    payload = {
        "schema": JOURNAL_SCHEMA,
        "t_wall": round(time.time(), 3),
        "jobs": [
            {"id": j.id, "raw": j.raw, "state": j.state,
             "submitted_t": round(j.submitted_t, 3)}
            for j in jobs
        ],
    }
    payload_s = json.dumps(payload, indent=1)
    if faults.tear_write("serve.journal_write", path, payload_s):
        return path  # chaos: half the payload hit the final path directly
    # tmp + fsync + rename (io/layout.py manifest discipline): a crash
    # mid-write must leave either the old journal or the new one, never
    # a torn file — these are accepted tenant jobs
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(payload_s)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def _quarantine_torn(path: str, why: str) -> None:
    """Named degradation for an unreadable drain journal: warn once on
    stderr with a greppable prefix and move the file aside (``.bad``) so
    the evidence survives but the next restart doesn't re-trip."""
    print(f"serve: WARNING: torn/unreadable drain journal {path}: {why}; "
          f"quarantined to {os.path.basename(path)}.bad — starting with "
          "an empty queue", file=sys.stderr)
    try:
        os.replace(path, path + ".bad")
    except OSError:
        pass


def load_journal(state_dir: str) -> list[dict]:
    """Read + consume the drain journal: entries in resume order, the
    file removed (its content now lives in the daemon's queue). Torn or
    garbage payloads degrade to a named warning + empty list with the
    file quarantined to ``*.bad`` — a torn journal must not wedge
    restarts."""
    path = journal_path(state_dir)
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except FileNotFoundError:
        return []
    except (OSError, ValueError) as exc:
        _quarantine_torn(path, repr(exc))
        return []
    jobs = payload.get("jobs") if isinstance(payload, dict) else None
    if not isinstance(jobs, list):
        _quarantine_torn(path, "payload is not {schema, jobs: [...]}")
        return []
    try:
        os.remove(path)
    except OSError:
        pass
    return [j for j in jobs if isinstance(j, dict) and isinstance(
        j.get("raw"), dict)]


# --- poison quarantine --------------------------------------------------------


def poison_path(state_dir: str) -> str:
    return os.path.join(state_dir, POISON_BASENAME)


def append_poison(state_dir: str, job: Job, *, classification: str,
                  error: str) -> str:
    """Quarantine a job that exhausted its retries (or failed fatally) to
    ``serve_poison.json`` with a machine-readable reason. Atomic
    read-modify-replace under the daemon loop (single writer), so one
    bad tenant job is recorded durably and never re-enters the queue."""
    path = poison_path(state_dir)
    os.makedirs(state_dir, exist_ok=True)
    entries = load_poison(state_dir)
    entries.append({
        "id": job.id,
        "raw": job.raw,
        "classification": classification,
        "error": error,
        "attempts": int(job.attempts),
        "submitted_t": round(job.submitted_t, 3),
        "t_wall": round(time.time(), 3),
    })
    payload_s = json.dumps({"schema": POISON_SCHEMA, "jobs": entries},
                           indent=1)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(payload_s)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def load_poison(state_dir: str) -> list[dict]:
    """Poison-quarantine entries (non-consuming — the file is the durable
    record); garbage degrades to an empty list."""
    try:
        with open(poison_path(state_dir)) as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return []
    jobs = payload.get("jobs") if isinstance(payload, dict) else None
    if not isinstance(jobs, list):
        return []
    return [j for j in jobs if isinstance(j, dict)]
