#!/usr/bin/env python
"""Seeded, deterministic load generator for the PyTorch port's warm-serving
daemon (``python -m ont_tcrconsensus_tpu_torch serve``).

Hammers ``POST /jobs`` with a configurable tenant mix and emits a
machine-readable ``load_report.json`` whose rejection ledger is EXACT:

    submitted == accepted + sum(rejected_by_reason)
    accepted  == completed + poisoned + failed + journaled_remaining

Four scenarios, all seeded (same ``--seed`` + ``--mix`` => the same
submission kinds at the same offsets):

- ``smoke``     — in-process daemon, stub runner by default: a seeded
  mix burst (202/400/409/413 accounting), a gated saturation burst with
  EXACT queue_full 429 counts, one mid-drain 503, drain with jobs still
  queued -> journal -> restarted daemon resumes -> every accepted job
  completes. Seconds-fast; the tier-1 load-smoke stage runs this.
- ``packed``    — in-process daemon, stub runner, ``--workers`` slice-
  packed runner pool: a gate holds every stub job mid-run until >= 2
  tenants are provably resident AT ONCE on pairwise-disjoint device
  slices (concurrency high-water + disjointness land in the report as
  invariants), then completes everything under the same exact ledger.
  The tier-1 slice-pack smoke runs this.
- ``sustained`` — in-process daemon, real pipeline: N tenants served
  back-to-back through one warm process; p50/p99 job wait,
  dispatch-to-first-stage latency, reads/s over the busy window,
  steady-state compile count from the LAST tenant's telemetry.json, and
  measured cold-start seconds. ``--ledger`` appends the
  ``source:"serve_load"`` entry `evaluate_load_gate` regresses against.
- ``drain``     — subprocess daemon, SIGTERM under load: mid-drain
  submissions 503, exit 143, journal carries the queue, a restarted
  daemon completes everything with counts CSV + consensus FASTA
  byte-identical to an uninterrupted run.
- ``crash``     — subprocess daemon with a ``TCR_CHAOS`` plan that
  raises in the serve loop itself: flight recorder flushed under
  ``serve_crash:<Type>``, every accepted job journaled, a clean restart
  completes them byte-identically.

The stub runner (smoke default) replaces ``run_with_config`` with a
short sleep: it exercises the CONTROL plane (admission, queue, journal,
metrics, drain) without pipeline work — the real-runner scenarios and
the slow e2e tests cover the data plane. Exit code is nonzero whenever
an invariant, drill verification, or report-schema check fails.

The daemons run on the CUDA card; ``--cpu`` puts them on the CPU, and
without it a host with no card raises (``no CUDA device``). ``packed``
packs its tenants onto slices of the run's platform: eight CPU slices
under ``--cpu``, else the host's cards, one card split into as many
slices as ``--workers`` where there are fewer cards. The same seed and
arguments give the JAX package's ``scripts/serve_load.py`` reports but for
timings and paths.

Usage:
    python scripts/torch_serve_load.py --scenario smoke --cpu --out load_report.json
    python scripts/torch_serve_load.py --scenario sustained --tenants 4 \
        --reads-per-molecule 12 --ledger history.jsonl
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPORT_SCHEMA = 1

#: submission kinds a schedule can carry and the refusal each provokes
MIX_KINDS = ("ok", "over_budget", "invalid_config", "oversized_body")

#: fallback HTTP-status -> reason mapping for rejection bodies without a
#: machine-readable ``error`` field (413 fires in the live plane)
STATUS_REASONS = {
    429: "queue_full", 409: "over_budget", 400: "invalid_config",
    413: "body_too_large", 503: "draining",
}

TERMINAL_STATES = ("done", "failed", "poisoned")


# --- deterministic schedule ---------------------------------------------------


def parse_mix(spec: str) -> dict[str, int]:
    """``"ok=6,over_budget=2"`` -> ``{"ok": 6, "over_budget": 2}``."""
    out: dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        kind, _, n = part.partition("=")
        if kind not in MIX_KINDS:
            raise ValueError(f"unknown mix kind {kind!r} (known: {MIX_KINDS})")
        count = int(n)
        if count < 0:
            raise ValueError(f"negative count for mix kind {kind!r}")
        out[kind] = out.get(kind, 0) + count
    if sum(out.values()) <= 0:
        raise ValueError(f"mix {spec!r} schedules no submissions")
    return out


def build_schedule(seed: int, mix: dict[str, int],
                   period_s: float) -> list[dict]:
    """Open-loop schedule: kinds are a seeded shuffle of the mix
    multiset, offsets a seeded sorted uniform draw over [0, period_s).
    Pure function of (seed, mix, period_s) — replayable by construction."""
    rng = random.Random(seed)
    kinds = [k for k, n in sorted(mix.items()) for _ in range(n)]
    rng.shuffle(kinds)
    offsets = sorted(rng.uniform(0.0, period_s) for _ in kinds)
    return [{"i": i, "t": round(t, 4), "kind": kind}
            for i, (t, kind) in enumerate(zip(offsets, kinds))]


def payload_for(kind: str, base: dict) -> tuple[dict | None, bytes | None]:
    """(json_object, raw_bytes) for one submission kind."""
    if kind == "ok":
        return dict(base), None
    if kind == "over_budget":
        return {**base, "read_batch_size": 1 << 24}, None
    if kind == "invalid_config":
        return {**base, "no_such_knob_from_serve_load": 1}, None
    if kind == "oversized_body":
        return None, b'{"pad": "' + b"x" * (1 << 20) + b'"}'
    raise ValueError(f"unknown kind {kind!r}")


# --- HTTP ---------------------------------------------------------------------


def _get(url: str, timeout: float = 30.0) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as err:
        body = err.read().decode()
        return err.code, (json.loads(body) if body.startswith("{") else {})


def _post(url: str, obj=None, data: bytes | None = None,
          timeout: float = 30.0) -> tuple[int, dict]:
    payload = json.dumps(obj).encode() if data is None else data
    req = urllib.request.Request(
        url, data=payload, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as err:
        body = err.read().decode()
        return err.code, (json.loads(body) if body.startswith("{") else {})


# --- the rejection ledger -----------------------------------------------------


class Ledger:
    """Every submission's outcome, counted the moment the response lands
    — the accounting invariants are checked against THIS, not against
    daemon-side telemetry, so a dropped response is a visible hole."""

    def __init__(self) -> None:
        self.submitted = 0
        self.accepted = 0
        self.rejected_by_reason: dict[str, int] = {}
        self.accepted_ids: list[str] = []
        self.records: list[dict] = []

    def record(self, spec_kind: str, status: int, body: dict) -> None:
        self.submitted += 1
        if status == 202:
            self.accepted += 1
            self.accepted_ids.append(body["id"])
        else:
            reason = (body.get("error") if isinstance(body, dict) else None) \
                or STATUS_REASONS.get(status, f"http_{status}")
            self.rejected_by_reason[reason] = (
                self.rejected_by_reason.get(reason, 0) + 1)
        self.records.append(
            {"kind": spec_kind, "status": status,
             "id": body.get("id") if isinstance(body, dict) else None})


def run_schedule(jobs_url: str, schedule: list[dict], base: dict,
                 ledger: Ledger) -> None:
    """Submit the schedule open-loop: each POST fires at its offset
    regardless of earlier responses (the generator never self-throttles
    — that is the point of a saturation drill)."""
    t0 = time.monotonic()
    for spec in schedule:
        delay = spec["t"] - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        obj, data = payload_for(spec["kind"], base)
        status, body = _post(jobs_url, obj, data)
        ledger.record(spec["kind"], status, body)


def wait_terminal(jobs_url: str, job_ids: list[str],
                  timeout_s: float, poll_s: float = 0.1) -> dict[str, dict]:
    """Job id -> terminal snapshot; raises on timeout (a wedged loop is
    exactly what this harness exists to catch)."""
    states: dict[str, dict] = {}
    deadline = time.monotonic() + timeout_s
    while len(states) < len(job_ids):
        if time.monotonic() > deadline:
            missing = [j for j in job_ids if j not in states]
            raise RuntimeError(
                f"{len(missing)} job(s) not terminal after {timeout_s}s: "
                f"{missing[:8]}")
        for jid in job_ids:
            if jid in states:
                continue
            st, cur = _get(f"{jobs_url}/{jid}")
            if st == 200 and cur.get("state") in TERMINAL_STATES:
                states[jid] = cur
        time.sleep(poll_s)
    return states


# --- report -------------------------------------------------------------------


def percentile(values: list[float], p: float) -> float | None:
    """Nearest-rank percentile (exact for the small-N SLO tables)."""
    if not values:
        return None
    s = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(s)))
    return s[k - 1]


def summarize_waits(snaps: list[dict]) -> dict:
    waits = [s["wait_s"] for s in snaps if s.get("wait_s") is not None]
    stages = [s["first_stage_s"] for s in snaps
              if s.get("first_stage_s") is not None]
    rnd = lambda v: round(v, 4) if v is not None else None  # noqa: E731
    return {
        "wait_s": {"p50": rnd(percentile(waits, 50)),
                   "p99": rnd(percentile(waits, 99))},
        "first_stage_s": {"p50": rnd(percentile(stages, 50)),
                          "p99": rnd(percentile(stages, 99))},
    }


def check_invariants(report: dict) -> list[str]:
    """The exact-accounting contract; every violation is a returned
    string (empty == sound)."""
    problems = []
    rej = sum(report.get("rejected_by_reason", {}).values())
    if report["submitted"] != report["accepted"] + rej:
        problems.append(
            f"submitted ({report['submitted']}) != accepted "
            f"({report['accepted']}) + rejected ({rej})")
    terminal = (report["completed"] + report["poisoned"] + report["failed"]
                + report.get("journaled_remaining", 0))
    if report["accepted"] != terminal:
        problems.append(
            f"accepted ({report['accepted']}) != completed "
            f"({report['completed']}) + poisoned ({report['poisoned']}) + "
            f"failed ({report['failed']}) + journaled_remaining "
            f"({report.get('journaled_remaining', 0)})")
    return problems


_REQUIRED = {
    "schema": int, "source": str, "scenario": str, "seed": int,
    "submitted": int, "accepted": int, "completed": int, "poisoned": int,
    "failed": int, "rejected_by_reason": dict, "wait_s": dict,
    "first_stage_s": dict, "invariants": list,
}


def validate_report(report: dict) -> list[str]:
    """Schema problems (empty == valid); additive keys are fine."""
    problems = []
    for key, typ in _REQUIRED.items():
        if key not in report:
            problems.append(f"missing required key {key!r}")
        elif not isinstance(report[key], typ):
            problems.append(
                f"key {key!r} is {type(report[key]).__name__}, "
                f"want {typ.__name__}")
    if report.get("source") != "serve_load":
        problems.append('source must be "serve_load"')
    for sub in ("wait_s", "first_stage_s"):
        d = report.get(sub)
        if isinstance(d, dict):
            for pk in ("p50", "p99"):
                if pk not in d:
                    problems.append(f"{sub} missing {pk!r}")
    return problems


def base_report(args, scenario: str) -> dict:
    return {
        "schema": REPORT_SCHEMA,
        "source": "serve_load",
        "scenario": scenario,
        "seed": args.seed,
        "t_wall": round(time.time(), 3),
        "submitted": 0, "accepted": 0, "completed": 0,
        "poisoned": 0, "failed": 0, "journaled_remaining": 0,
        "rejected_by_reason": {},
        "wait_s": {"p50": None, "p99": None},
        "first_stage_s": {"p50": None, "p99": None},
        "reads_per_sec": None, "n_reads": None,
        "steady_compile_count": None, "cold_start_s": None,
        "drills": {}, "invariants": [],
    }


# --- in-process daemon plumbing ----------------------------------------------


#: the CPU slices the packed pool is cut from under ``--cpu``
CPU_SLICES = 8


def slice_devices(args) -> list[str]:
    """The devices the packed scenario's pool is cut from: eight CPU
    slices under ``--cpu``; else every card, or one card repeated into
    ``--workers`` slices where the host has fewer cards."""
    if args.device == "cpu":
        return ["cpu"] * CPU_SLICES
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: the packed scenario on the card needs one "
                           "(--cpu runs it on the CPU)")
    return [f"cuda:{i % n}" for i in range(max(args.workers, n))]


def _start_daemon_thread(daemon):
    out = {"exit": None, "error": None}

    def _run():
        try:
            out["exit"] = daemon.serve_forever()
        except BaseException as exc:  # crash drills land here
            out["error"] = repr(exc)

    th = threading.Thread(target=_run, name="serve-load-daemon", daemon=True)
    th.start()
    return th, out


def _wait_live_server(timeout_s: float = 120.0):
    from ont_tcrconsensus_tpu_torch.obs import live as obs_live

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        srv = obs_live.server()
        if srv is not None:
            return srv
        time.sleep(0.05)
    raise RuntimeError("daemon never armed its live plane")


def _terminal_counts(snapshots: list[dict]) -> dict[str, int]:
    counts = {"done": 0, "failed": 0, "poisoned": 0}
    for snap in snapshots:
        if snap.get("state") in counts:
            counts[snap["state"]] += 1
    return counts


# --- scenario: smoke ----------------------------------------------------------


def scenario_smoke(args) -> dict:
    """Control-plane proof in seconds: mix accounting, exact saturation
    429s, one mid-drain 503, journal -> restart -> resume-to-done."""
    from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod
    from ont_tcrconsensus_tpu_torch.serve import queue as queue_mod
    from ont_tcrconsensus_tpu_torch.serve.daemon import Daemon

    report = base_report(args, "smoke")
    state_dir = os.path.join(args.workdir, "state")
    # fastq_pass_dir must be workdir-rooted even under the stub runner:
    # the daemon's success path appends a serve history entry beneath it
    template = {"reference_file": os.path.join(args.workdir, "r.fa"),
                "fastq_pass_dir": os.path.join(args.workdir, "fq")}
    gate = threading.Event()
    gate.set()

    def stub_run(cfg, device=None):
        gate.wait(timeout=60.0)
        time.sleep(args.stub_job_s)
        return {"barcode01": {"region0": 1}}

    real_run = run_mod.run_with_config
    if args.runner == "stub":
        run_mod.run_with_config = stub_run
    ledger = Ledger()
    try:
        daemon = Daemon(template, port=0, state_dir=state_dir,
                        queue_max=args.queue_max, do_prewarm=False,
                        device=args.device)
        th, out = _start_daemon_thread(daemon)
        srv = _wait_live_server()
        jobs_url = f"http://127.0.0.1:{srv.port}/jobs"

        # phase A: the seeded mix — every refusal reason metered exactly
        schedule = build_schedule(args.seed, parse_mix(args.mix),
                                  args.period_s)
        run_schedule(jobs_url, schedule, template, ledger)
        wait_terminal(jobs_url, list(ledger.accepted_ids), args.timeout_s)

        # phase B: gated saturation — one job running (held on the gate),
        # queue filled to the brim, overflow gets EXACTLY counted 429s
        gate.clear()
        burst = args.burst or (args.queue_max + 2)
        st, body = _post(jobs_url, template)
        ledger.record("ok", st, body)
        deadline = time.monotonic() + 30.0
        while daemon.queue.depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)  # the held job must be POPPED, not queued
        before_429 = ledger.rejected_by_reason.get("queue_full", 0)
        for _ in range(burst):
            st, body = _post(jobs_url, template)
            ledger.record("ok", st, body)
        exact_429 = (ledger.rejected_by_reason.get("queue_full", 0)
                     - before_429)
        report["drills"]["saturation"] = {
            "burst": burst, "queue_max": args.queue_max,
            "queue_full_429": exact_429,
            "expected_429": burst - args.queue_max,
        }

        # metrics satellite evidence: live depth gauge + per-reason family
        st, _ = _get(f"http://127.0.0.1:{srv.port}/healthz")
        metrics_txt = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read().decode()
        report["drills"]["metrics"] = {
            "serve_rejected_total": sum(
                1 for line in metrics_txt.splitlines()
                if line.startswith("tcr_serve_rejected_total{")),
            "live_queue_depth_gauge": any(
                line.startswith('tcr_gauge_current{site="serve.queue_depth"')
                for line in metrics_txt.splitlines()),
        }

        # phase C: drain under load — stop while the gate still holds the
        # running job and the queue is full; one more submit must 503
        daemon.request_stop()
        st, body = _post(jobs_url, template)
        ledger.record("ok", st, body)
        report["drills"]["mid_drain_503"] = int(st == 503)
        gate.set()
        th.join(timeout=120.0)
        if th.is_alive():
            raise RuntimeError("daemon did not drain after request_stop")
        gen1 = daemon.queue.snapshot()
        gen1_counts = _terminal_counts(gen1)
        journal_file = queue_mod.journal_path(state_dir)
        with open(journal_file) as fh:
            journaled = len(json.load(fh)["jobs"])
        report["drills"]["drain"] = {
            "exit_code": out["exit"], "error": out["error"],
            "journaled": journaled,
        }

        # phase D: restart — the journal resumes, everything completes
        daemon2 = Daemon(template, port=0, state_dir=state_dir,
                         queue_max=max(args.queue_max, journaled),
                         do_prewarm=False, device=args.device)
        th2, out2 = _start_daemon_thread(daemon2)
        srv2 = _wait_live_server()
        jobs_url2 = f"http://127.0.0.1:{srv2.port}/jobs"
        deadline = time.monotonic() + args.timeout_s
        listing: dict = {}
        while time.monotonic() < deadline:
            st, listing = _get(jobs_url2)
            if st == 200 and listing.get("jobs_done", 0) >= journaled:
                break
            time.sleep(0.05)
        daemon2.request_stop()
        th2.join(timeout=120.0)
        gen2 = daemon2.queue.snapshot()
        gen2_counts = _terminal_counts(gen2)
        report["drills"]["resume"] = {
            "resumed": len(gen2), "completed_after_restart":
            gen2_counts["done"], "journal_consumed":
            not os.path.exists(journal_file), "exit_code": out2["exit"],
        }

        report.update({
            "submitted": ledger.submitted,
            "accepted": ledger.accepted,
            "rejected_by_reason": dict(sorted(
                ledger.rejected_by_reason.items())),
            "completed": gen1_counts["done"] + gen2_counts["done"],
            "failed": gen1_counts["failed"] + gen2_counts["failed"],
            "poisoned": gen1_counts["poisoned"] + gen2_counts["poisoned"],
            "journaled_remaining": journaled - len(gen2),
            "runner": args.runner,
        })
        report.update(summarize_waits(gen1 + gen2))
        if exact_429 != burst - args.queue_max:
            report["invariants"].append(
                f"saturation burst of {burst} over queue_max="
                f"{args.queue_max} produced {exact_429} queue_full 429s, "
                f"want exactly {burst - args.queue_max}")
        if report["drills"]["mid_drain_503"] != 1:
            report["invariants"].append("mid-drain submission was not 503")
        if gen2_counts["done"] != journaled:
            report["invariants"].append(
                f"{journaled} journaled but only {gen2_counts['done']} "
                "completed after restart")
    finally:
        run_mod.run_with_config = real_run
    return report


# --- scenario: packed ---------------------------------------------------------


def scenario_packed(args) -> dict:
    """Slice-packed runner pool under load, stub runner: ``--workers``
    jobs resident AT ONCE on disjoint device slices. A gate holds every
    stub job mid-run until the concurrency high-water has provably
    reached the pool width, and the packed invariants ride the same
    exact ledger as every other scenario:

        submitted == accepted + sum(rejected_by_reason)
        resident high-water >= 2
        concurrent leases pairwise disjoint
    """
    from ont_tcrconsensus_tpu_torch.pipeline import run as run_mod
    from ont_tcrconsensus_tpu_torch.robustness import shutdown
    from ont_tcrconsensus_tpu_torch.serve.daemon import Daemon

    report = base_report(args, "packed")
    state_dir = os.path.join(args.workdir, "state")
    template = {"reference_file": os.path.join(args.workdir, "r.fa"),
                "fastq_pass_dir": os.path.join(args.workdir, "fq")}
    gate = threading.Event()

    def stub_run(cfg, device=None):
        deadline = time.monotonic() + 60.0
        while not gate.is_set() and time.monotonic() < deadline:
            # the daemon's drain must be able to preempt a gated stub
            # exactly like a real run at a stage boundary
            shutdown.checkpoint("stub.run")
            time.sleep(0.01)
        time.sleep(args.stub_job_s)
        return {"barcode01": {"region0": 1}}

    real_run = run_mod.run_with_config
    run_mod.run_with_config = stub_run
    ledger = Ledger()
    high_water = 0
    disjoint_ok = True
    overlap_seen: list[str] = []
    try:
        daemon = Daemon(template, port=0, state_dir=state_dir,
                        queue_max=max(args.queue_max, args.tenants),
                        do_prewarm=False, workers=args.workers,
                        device=args.device, devices=slice_devices(args))
        if daemon.allocator is None:
            raise RuntimeError(
                f"packed scenario needs a runner pool (workers="
                f"{args.workers} gave no allocator)")
        th, out = _start_daemon_thread(daemon)
        srv = _wait_live_server()
        jobs_url = f"http://127.0.0.1:{srv.port}/jobs"

        # the seeded mix, same as smoke: refusals stay exactly metered
        # while the accepted jobs pile onto the pool behind the gate
        schedule = build_schedule(args.seed, parse_mix(args.mix),
                                  args.period_s)
        run_schedule(jobs_url, schedule, template, ledger)

        # hold the gate until the pool is provably packed: >= 2 tenants
        # resident at once on pairwise-disjoint slices
        deadline = time.monotonic() + args.timeout_s
        while time.monotonic() < deadline:
            snap = daemon.jobs_snapshot()
            leases = snap.get("slices", {}).get("leases", {})
            high_water = max(high_water, snap.get("resident_jobs", 0))
            claimed: set[str] = set()
            for job_id, lease in sorted(leases.items()):
                devs = set(lease["devices"])
                if claimed & devs:
                    disjoint_ok = False
                claimed |= devs
            if len(leases) >= 2 and not overlap_seen:
                overlap_seen = sorted(
                    f"{jid}@{lease['slice']}"
                    for jid, lease in leases.items())
            if high_water >= min(2, args.workers):
                break
            time.sleep(0.02)
        # scrape /metrics while the pool is still packed: the tenant
        # labels on tcr_mesh_slice_busy only exist while leases are live
        metrics_txt = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read().decode()
        report["drills"]["metrics"] = {
            "resident_jobs_gauge": any(
                line.startswith("tcr_serve_resident_jobs")
                for line in metrics_txt.splitlines()),
            "slice_busy_tenant_labels": sum(
                1 for line in metrics_txt.splitlines()
                if line.startswith("tcr_mesh_slice_busy{") and
                "tenant=" in line),
        }
        gate.set()
        snaps = wait_terminal(jobs_url, list(ledger.accepted_ids),
                              args.timeout_s)
        pool = daemon.allocator.snapshot()
        daemon.request_stop()
        th.join(timeout=120.0)
        if th.is_alive():
            raise RuntimeError("packed daemon did not drain")
        counts = _terminal_counts(list(snaps.values()))
        report["drills"]["packed"] = {
            "workers": args.workers,
            "resident_high_water": high_water,
            "disjoint_slices": disjoint_ok,
            "overlap_observed": overlap_seen,
            "quarantined": pool["quarantined"],
            "exit_code": out["exit"],
        }
        report.update({
            "submitted": ledger.submitted,
            "accepted": ledger.accepted,
            "rejected_by_reason": dict(sorted(
                ledger.rejected_by_reason.items())),
            "completed": counts["done"],
            "failed": counts["failed"],
            "poisoned": counts["poisoned"],
            "journaled_remaining": 0,
            "runner": "stub",
        })
        report.update(summarize_waits(list(snaps.values())))
        if high_water < min(2, args.workers):
            report["invariants"].append(
                f"resident high-water {high_water} never reached "
                f"{min(2, args.workers)} — the pool never packed")
        if not disjoint_ok:
            report["invariants"].append(
                "concurrent leases shared a device — slice isolation "
                "is broken")
        if not report["drills"]["metrics"]["resident_jobs_gauge"]:
            report["invariants"].append(
                "/metrics has no tcr_serve_resident_jobs gauge")
        if report["drills"]["metrics"]["slice_busy_tenant_labels"] < 2:
            report["invariants"].append(
                "/metrics showed fewer than 2 tenant-labelled "
                "tcr_mesh_slice_busy slices while the pool was packed")
        if args.ledger:
            from ont_tcrconsensus_tpu_torch.obs import history as obs_history
            from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig

            # stub runner: no reads/s — the entry still carries the
            # packed-residency evidence and the wait SLOs, and the load
            # gate accepts it (reads_per_sec simply isn't gated)
            cfg = RunConfig.from_dict(dict(template))
            entry = obs_history.build_entry(
                "serve_load",
                fingerprint=obs_history.config_fingerprint(cfg),
                sha=obs_history.git_sha(),
                backend=obs_history.detect_backend(),
                extra={
                    "scenario": "packed",
                    "p50_wait_s": report["wait_s"]["p50"],
                    "p99_wait_s": report["wait_s"]["p99"],
                    "workers": args.workers,
                    "resident_high_water": high_water,
                    "submitted": ledger.submitted,
                    "accepted": ledger.accepted,
                    "completed": counts["done"],
                    "poisoned": counts["poisoned"],
                    "rejected_by_reason": dict(ledger.rejected_by_reason),
                },
            )
            obs_history.append_entry(args.ledger, entry)
            report["drills"]["ledger_entry"] = {
                "path": args.ledger, "fingerprint": entry["fingerprint"]}
    finally:
        run_mod.run_with_config = real_run
    return report


# --- scenario: sustained ------------------------------------------------------


def _build_library(args):
    from ont_tcrconsensus_tpu_torch.io import fastx, simulator

    lib = simulator.simulate_library(
        seed=args.seed + 29,
        num_regions=args.regions,
        molecules_per_region=(args.molecules, args.molecules + 1),
        reads_per_molecule=(args.reads_per_molecule,
                            args.reads_per_molecule + 2),
        sub_rate=0.006, ins_rate=0.003, del_rate=0.003,
        region_len=(700, 850),
    )
    src = os.path.join(args.workdir, "dataset")
    os.makedirs(src, exist_ok=True)
    fastx.write_fasta(os.path.join(src, "reference.fa"),
                      lib.reference.items())
    fq_dir = os.path.join(src, "fastq_pass", "barcode01")
    os.makedirs(fq_dir, exist_ok=True)
    fastx.write_fastq(os.path.join(fq_dir, "barcode01.fastq.gz"), lib.reads)
    return src, lib


def _stage_tenant(src: str, root: str) -> dict:
    os.makedirs(root, exist_ok=True)
    shutil.copy(os.path.join(src, "reference.fa"),
                os.path.join(root, "reference.fa"))
    shutil.copytree(os.path.join(src, "fastq_pass"),
                    os.path.join(root, "fastq_pass"))
    return {
        "reference_file": os.path.join(root, "reference.fa"),
        "fastq_pass_dir": os.path.join(root, "fastq_pass"),
        "minimal_length": 600,
        "min_reads_per_cluster": 4,
        "read_batch_size": 96,
        "polish_method": "poa",
        "delete_tmp_files": False,
        # no compile_cache_dir: run.enable_build_cache resolves it to the
        # package's kernel build directory, shared by every tenant and the
        # daemon's prewarm, so a warm tenant builds nothing
    }


def scenario_sustained(args) -> dict:
    """N tenants through one warm daemon, real pipeline: the SLO numbers
    (p50/p99 wait, first-stage latency, reads/s, steady compiles, cold
    start) plus the ledger entry the load gate regresses against."""
    from ont_tcrconsensus_tpu_torch.obs import history as obs_history
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import _read_counts_csv
    from ont_tcrconsensus_tpu_torch.serve.daemon import Daemon

    report = base_report(args, "sustained")
    src, lib = _build_library(args)
    n_reads = len(lib.reads)
    tenants = [
        _stage_tenant(src, os.path.join(args.workdir, f"tenant{i}"))
        for i in range(args.tenants)
    ]
    state_dir = os.path.join(args.workdir, "state")
    daemon = Daemon(dict(tenants[0]), port=0, state_dir=state_dir,
                    queue_max=max(args.queue_max, args.tenants),
                    prewarm_widths=[1024], device=args.device)
    th, out = _start_daemon_thread(daemon)
    srv = _wait_live_server()
    jobs_url = f"http://127.0.0.1:{srv.port}/jobs"
    ledger = Ledger()
    try:
        for raw in tenants:  # open-loop up-front burst: the queue absorbs
            st, body = _post(jobs_url, raw)
            ledger.record("ok", st, body)
        snaps = wait_terminal(jobs_url, list(ledger.accepted_ids),
                              args.timeout_s)
    finally:
        daemon.request_stop()
        th.join(timeout=300.0)
    done = [s for s in snaps.values() if s["state"] == "done"]
    counts = _terminal_counts(list(snaps.values()))
    started = [s["started_t"] for s in done if s.get("started_t")]
    finished = [s["finished_t"] for s in done if s.get("finished_t")]
    busy_s = (max(finished) - min(started)) if started and finished else None
    total_reads = n_reads * len(done)
    reads_per_sec = (round(total_reads / busy_s, 2)
                     if busy_s and busy_s > 0 else None)

    counts_exact = True
    for raw in tenants:
        path = os.path.join(raw["fastq_pass_dir"], "nano_tcr", "barcode01",
                            "counts", "umi_consensus_counts.csv")
        try:
            counts_exact &= _read_counts_csv(path) == lib.true_counts
        except OSError:
            counts_exact = False
    tele_path = os.path.join(tenants[-1]["fastq_pass_dir"], "nano_tcr",
                             "telemetry.json")
    steady_compiles = None
    try:
        with open(tele_path) as fh:
            steady_compiles = json.load(fh)["compile"]["count"]
    except (OSError, ValueError, KeyError):
        pass

    report.update({
        "submitted": ledger.submitted,
        "accepted": ledger.accepted,
        "rejected_by_reason": dict(sorted(ledger.rejected_by_reason.items())),
        "completed": counts["done"],
        "failed": counts["failed"],
        "poisoned": counts["poisoned"],
        "journaled_remaining": 0,
        "n_reads": total_reads,
        "reads_per_sec": reads_per_sec,
        "steady_compile_count": steady_compiles,
        "cold_start_s": daemon.warmup_s,
        "runner": "real",
    })
    report.update(summarize_waits(list(snaps.values())))
    report["drills"]["sustained"] = {
        "tenants": args.tenants, "reads_per_tenant": n_reads,
        "busy_window_s": round(busy_s, 3) if busy_s else None,
        "counts_exact": counts_exact, "exit_code": out["exit"],
        "prewarm": daemon.prewarm_report,
    }
    if not counts_exact:
        report["invariants"].append(
            "tenant counts CSVs do not match the simulator ground truth")
    if args.ledger:
        cfg = RunConfig.from_dict(dict(tenants[0]))
        entry = obs_history.build_entry(
            "serve_load",
            fingerprint=obs_history.config_fingerprint(cfg),
            sha=obs_history.git_sha(),
            backend=obs_history.detect_backend(),
            n_reads=total_reads,
            reads_per_sec=reads_per_sec,
            warmup_s=daemon.warmup_s,
            steady_s=busy_s,
            extra={
                "scenario": "sustained",
                "p50_wait_s": report["wait_s"]["p50"],
                "p99_wait_s": report["wait_s"]["p99"],
                "p50_first_stage_s": report["first_stage_s"]["p50"],
                "p99_first_stage_s": report["first_stage_s"]["p99"],
                "steady_compile_count": steady_compiles,
                "cold_start_s": daemon.warmup_s,
                "submitted": ledger.submitted,
                "accepted": ledger.accepted,
                "completed": counts["done"],
                "poisoned": counts["poisoned"],
                "rejected_by_reason": dict(ledger.rejected_by_reason),
            },
        )
        obs_history.append_entry(args.ledger, entry)
        report["drills"]["ledger_entry"] = {
            "path": args.ledger, "fingerprint": entry["fingerprint"]}
    return report


# --- scenarios: drain / crash (subprocess daemon) -----------------------------


def _spawn_daemon(template_path: str, state_dir: str, log_path: str,
                  env_extra: dict | None = None,
                  prewarm: bool = False, cpu: bool = False) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(env_extra or {})
    # the port runs from the repository, not from an installed package
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    log = open(log_path, "ab")
    cmd = [sys.executable, "-m", "ont_tcrconsensus_tpu_torch",
           "serve", template_path, "--port", "0", "--state-dir", state_dir]
    if cpu:
        cmd.append("--cpu")
    if not prewarm:
        cmd.append("--no-prewarm")
    return subprocess.Popen(cmd, env=env, stdout=log, stderr=log)


def _wait_serve_info(state_dir: str, pid: int,
                     timeout_s: float = 300.0) -> int:
    path = os.path.join(state_dir, "serve_info.json")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as fh:
                info = json.load(fh)
            if info.get("pid") == pid:
                return int(info["port"])
        except (OSError, ValueError):
            pass
        time.sleep(0.1)
    raise RuntimeError(f"daemon (pid {pid}) never wrote {path}")


def _artifact_bytes(fastq_pass_dir: str) -> dict[str, bytes]:
    nano = os.path.join(fastq_pass_dir, "nano_tcr")
    out = {}
    for rel in (("barcode01", "counts", "umi_consensus_counts.csv"),
                ("barcode01", "fasta", "merged_consensus.fasta")):
        with open(os.path.join(nano, *rel), "rb") as fh:
            out["/".join(rel)] = fh.read()
    return out


def _subprocess_disruption(args, scenario: str) -> dict:
    """Shared drain/crash harness: uninterrupted baseline run, disrupted
    daemon generation 1, clean restart generation 2, byte-identity."""
    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import run_with_config
    from ont_tcrconsensus_tpu_torch.serve import queue as queue_mod

    report = base_report(args, scenario)
    src, lib = _build_library(args)
    # uninterrupted baseline in-process (same config the tenants get)
    baseline_root = os.path.join(args.workdir, "baseline")
    baseline_raw = _stage_tenant(src, baseline_root)
    run_with_config(RunConfig.from_dict(dict(baseline_raw)), device=args.device)
    want = _artifact_bytes(baseline_raw["fastq_pass_dir"])

    tenants = [
        _stage_tenant(src, os.path.join(args.workdir, f"tenant{i}"))
        for i in range(args.tenants)
    ]
    state_dir = os.path.join(args.workdir, "state")
    template_path = os.path.join(args.workdir, "template.json")
    with open(template_path, "w") as fh:
        json.dump(tenants[0], fh)
    log_path = os.path.join(args.workdir, "daemon.log")

    env_extra = {}
    if scenario == "crash":
        env_extra["TCR_CHAOS"] = json.dumps({
            "seed": args.seed,
            "faults": [{"site": "serve.daemon_loop", "kind": "error",
                        "message": "induced serve-loop crash"}],
        })
    # generation 1 prewarms: submissions land while the AOT prewarm still
    # holds the accept loop, so the disruption hits with EVERY job queued
    # (mid-load by construction, not by racing the loop)
    proc = _spawn_daemon(template_path, state_dir, log_path, env_extra,
                         prewarm=True, cpu=args.cpu)
    ledger = Ledger()
    accepted_tenants: list[dict] = []
    try:
        port = _wait_serve_info(state_dir, proc.pid)
        jobs_url = f"http://127.0.0.1:{port}/jobs"
        for raw in tenants:
            # a crash drill can kill the daemon between submits — a
            # refused connection is a LEDGERED outcome, not a harness
            # error (the accounting invariant must stay exact)
            try:
                st, body = _post(jobs_url, raw)
            except (urllib.error.URLError, ConnectionError, OSError):
                st, body = 0, {"error": "connection_refused"}
            ledger.record("ok", st, body)
            if st == 202:
                accepted_tenants.append(raw)
        if scenario == "drain":
            # pull the plug only once a job is actually IN FLIGHT, so the
            # drain exercises the stage-boundary handoff, not an idle stop
            deadline = time.monotonic() + args.timeout_s
            while time.monotonic() < deadline:
                st, listing = _get(jobs_url)
                if st == 200 and any(j.get("state") == "running"
                                     for j in listing.get("jobs", [])):
                    break
                time.sleep(0.2)
            time.sleep(args.drain_after_s)
            proc.send_signal(signal.SIGTERM)
            # mid-drain arrivals must get a machine-readable 503. Signal
            # delivery is asynchronous (the handler waits for the main
            # thread's next bytecode boundary), so probe until the drain
            # window is visible. The probe payload is OVER BUDGET on
            # purpose: before the flag lands it bounces as a cheap 409
            # (never queued, still ledgered); the draining check precedes
            # admission, so the first probe inside the window gets 503.
            report["drills"]["mid_drain_503"] = 0
            probe, _ = payload_for("over_budget", tenants[0])
            probe_deadline = time.monotonic() + 60.0
            while time.monotonic() < probe_deadline:
                try:
                    st, body = _post(jobs_url, probe)
                except (urllib.error.URLError, ConnectionError, OSError):
                    report["drills"]["mid_drain_503"] = "daemon_already_down"
                    break
                ledger.record("over_budget", st, body)
                if st == 503:
                    report["drills"]["mid_drain_503"] = 1
                    break
                time.sleep(0.2)
        rc = proc.wait(timeout=args.timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60.0)
    report["drills"]["disruption"] = {"exit_code": rc}
    if scenario == "drain" and rc != 143:
        report["invariants"].append(f"SIGTERM drain exited {rc}, want 143")
    if scenario == "crash" and rc == 0:
        report["invariants"].append("induced crash exited 0")

    # flight recorder flushed (crash-aware reason on the crash path)
    flight_path = os.path.join(state_dir, "logs", "flight_recorder.json")
    try:
        with open(flight_path) as fh:
            flight = json.load(fh)
        report["drills"]["flight_recorder"] = {
            "reason": flight.get("reason"), "events": len(
                flight.get("events", []))}
        if scenario == "crash" and not str(
                flight.get("reason", "")).startswith("serve_crash:"):
            report["invariants"].append(
                f"crash flush reason {flight.get('reason')!r} does not "
                "carry serve_crash:<Type>")
    except (OSError, ValueError):
        report["invariants"].append(
            f"flight recorder was not flushed to {flight_path}")

    journal_file = queue_mod.journal_path(state_dir)
    try:
        with open(journal_file) as fh:
            journaled = len(json.load(fh)["jobs"])
    except (OSError, ValueError):
        journaled = 0
        report["invariants"].append("no drain journal after disruption")
    gen1_done = ledger.accepted - journaled
    report["drills"]["journal"] = {"journaled": journaled}

    # generation 2: clean restart (no chaos), resume and complete
    proc2 = _spawn_daemon(template_path, state_dir, log_path, cpu=args.cpu)
    try:
        port2 = _wait_serve_info(state_dir, proc2.pid)
        jobs_url2 = f"http://127.0.0.1:{port2}/jobs"
        deadline = time.monotonic() + args.timeout_s
        listing: dict = {}
        while time.monotonic() < deadline:
            try:
                st, listing = _get(jobs_url2)
            except (urllib.error.URLError, ConnectionError, OSError):
                st, listing = 0, {}
            if st == 200 and listing.get("jobs_done", 0) >= journaled:
                break
            time.sleep(0.25)
        snaps = listing.get("jobs", [])
        proc2.send_signal(signal.SIGTERM)
        rc2 = proc2.wait(timeout=300.0)
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait(timeout=60.0)
    gen2_counts = _terminal_counts(snaps)
    report["drills"]["resume"] = {
        "resumed": len(snaps), "completed_after_restart":
        gen2_counts["done"], "exit_code": rc2,
        "journal_consumed": not os.path.exists(journal_file)}

    identical = True
    for raw in accepted_tenants:
        try:
            got = _artifact_bytes(raw["fastq_pass_dir"])
        except OSError:
            identical = False
            report["invariants"].append(
                f"missing output artifacts under {raw['fastq_pass_dir']}")
            continue
        for rel, blob in want.items():
            if got.get(rel) != blob:
                identical = False
                report["invariants"].append(
                    f"{raw['fastq_pass_dir']}: {rel} differs from the "
                    "uninterrupted baseline")
    report["drills"]["byte_identity"] = identical

    report.update({
        "submitted": ledger.submitted,
        "accepted": ledger.accepted,
        "rejected_by_reason": dict(sorted(ledger.rejected_by_reason.items())),
        "completed": gen1_done + gen2_counts["done"],
        "failed": gen2_counts["failed"],
        "poisoned": gen2_counts["poisoned"],
        "journaled_remaining": journaled - len(snaps),
        "runner": "real",
    })
    report.update(summarize_waits(snaps))
    return report


# --- CLI ----------------------------------------------------------------------


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Seeded load + chaos harness for the warm-serving "
                    "daemon; emits a machine-readable load_report.json "
                    "with an exact rejection ledger.")
    ap.add_argument("--scenario", default="smoke",
                    choices=("smoke", "packed", "sustained", "drain",
                             "crash"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mix",
                    default="ok=5,over_budget=2,invalid_config=2,"
                            "oversized_body=1",
                    help="seeded submission mix, e.g. 'ok=5,over_budget=1'")
    ap.add_argument("--period-s", type=float, default=1.5,
                    help="window the mix's offsets are drawn over")
    ap.add_argument("--queue-max", type=int, default=3)
    ap.add_argument("--burst", type=int, default=None,
                    help="saturation burst size (default queue_max + 2)")
    ap.add_argument("--runner", default=None, choices=("stub", "real"),
                    help="smoke only: 'stub' (default) replaces the "
                         "pipeline with a short sleep — control-plane "
                         "coverage in seconds")
    ap.add_argument("--stub-job-s", type=float, default=0.05)
    ap.add_argument("--workers", type=int, default=2,
                    help="packed scenario: runner-pool width (resident "
                         "jobs packed onto disjoint device slices)")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--regions", type=int, default=3)
    ap.add_argument("--molecules", type=int, default=2,
                    help="molecules per region (sustained dataset size)")
    ap.add_argument("--reads-per-molecule", type=int, default=5,
                    help="reads per molecule (scale this for big "
                         "sustained runs; counts stay exact)")
    ap.add_argument("--drain-after-s", type=float, default=5.0,
                    help="drain scenario: seconds of load before SIGTERM")
    ap.add_argument("--timeout-s", type=float, default=3600.0)
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--out", default="load_report.json")
    ap.add_argument("--ledger", default=None,
                    help="history ledger to append the source:serve_load "
                         "entry to (sustained scenario)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the daemons on the CPU (without it they run on "
                         "the CUDA card, and a host without one raises)")
    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else "cuda"
    if args.runner is None:
        args.runner = ("stub" if args.scenario in ("smoke", "packed")
                       else "real")
    if args.runner == "stub" and args.scenario not in ("smoke", "packed"):
        ap.error("--runner stub is only meaningful for --scenario "
                 "smoke/packed")
    if args.runner == "real" and args.scenario == "packed":
        ap.error("--scenario packed is a control-plane drill; the real "
                 "data plane is covered by the slow packed e2e tests")
    if args.scenario == "packed" and args.workers < 2:
        ap.error("--scenario packed needs --workers >= 2")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.workdir is None:
        import tempfile

        args.workdir = tempfile.mkdtemp(prefix="serve_load_")
    os.makedirs(args.workdir, exist_ok=True)

    runner = {
        "smoke": scenario_smoke,
        "packed": scenario_packed,
        "sustained": scenario_sustained,
        "drain": lambda a: _subprocess_disruption(a, "drain"),
        "crash": lambda a: _subprocess_disruption(a, "crash"),
    }[args.scenario]
    report = runner(args)

    report["invariants"] = (check_invariants(report)
                            + list(report.get("invariants", [])))
    schema_problems = validate_report(report)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"serve_load: {args.scenario} report -> {args.out}",
          file=sys.stderr)
    print(json.dumps({k: report[k] for k in (
        "scenario", "submitted", "accepted", "completed", "poisoned",
        "failed", "rejected_by_reason", "wait_s", "reads_per_sec",
        "cold_start_s", "steady_compile_count")}, sort_keys=True))
    rc = 0
    for problem in report["invariants"]:
        print(f"serve_load: INVARIANT VIOLATED: {problem}", file=sys.stderr)
        rc = 1
    for problem in schema_problems:
        print(f"serve_load: REPORT SCHEMA: {problem}", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
