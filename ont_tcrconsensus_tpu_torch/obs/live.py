"""Live observability plane: /healthz /metrics /progress + flight recorder.

A copy of the JAX package's ``obs/live.py``. ``telemetry.json``, the
history ledger and the critical-path analyzer explain a run after it
exits. This module answers "what is this process doing right now?" while
a run is in flight, and "what was it doing right before it died?" when it
never exits cleanly:

- **HTTP endpoint** (:class:`LiveServer`): a read-only, stdlib-only
  ``ThreadingHTTPServer`` bound to ``127.0.0.1:<live_port>`` for the
  run's duration. ``/healthz`` reports liveness plus a watchdog
  heartbeat-staleness verdict (any guarded stage past its soft deadline
  -> ``"stalled"``); ``/metrics`` renders the armed
  :class:`~ont_tcrconsensus_tpu_torch.obs.metrics.MetricsRegistry` as
  Prometheus text exposition (counters, high-water gauges, histograms,
  per-site dispatch host-gap/blocked seconds, overlap-pool busy/idle,
  per-node graph seconds) plus live per-stage watchdog heartbeat ages;
  ``/progress`` is a JSON view of the current library / graph node /
  nodes done vs total, with an ETA from history-ledger per-node priors
  matching the run's config fingerprint (``eta_basis: history_priors``),
  falling back to this run's own measured node seconds
  (``measured_pace``) — the current node's prior is rescaled by its
  declared ``units`` when both are known.
- **Flight recorder** (:class:`FlightRecorder`): a bounded in-memory
  ring of the last N spans / robustness instants / watchdog heartbeats,
  fed from ``trace.py``'s span-exit and instant paths and from
  ``watchdog.heartbeat`` — i.e. populated even at ``telemetry: on``,
  where the full trace collector is NOT armed. It is flushed atomically
  to ``nano_tcr/logs/flight_recorder.json`` on crash, SIGTERM drain,
  watchdog hard expiry, and on demand via SIGUSR1 — post-mortem context
  for a process that died without writing trace.json.

Arming follows the one-module-attribute-check discipline
(``watchdog.heartbeat`` / ``metrics.counter_add``):
the config knob ``live_port`` defaults to null and every planted site
below (``ring_event``, ``progress_node_start`` /...) reduces to one
module-attribute check when disarmed — nothing listens, nothing buffers.
Security posture: the server binds 127.0.0.1 ONLY; remote scrapes go
through an operator's own port-forward, never a config knob. One-shot
runs serve GET only. Under a serving daemon (a later slice of the port)
the same loopback-only server also accepts ``POST /jobs`` and serves
``GET /jobs`` / ``GET /jobs/<id>`` — the single mutating route exists
only while a daemon has armed a jobs controller
(:func:`set_jobs_controller`); without one, POST answers 503 and the
plane stays read-only.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ont_tcrconsensus_tpu_torch.obs import history, metrics, trace
from ont_tcrconsensus_tpu_torch.robustness import jobscope, lockcheck, watchdog

#: flight-recorder ring capacity. Sized for "the last few minutes of a
#: wedged run": heartbeats are per-batch/per-chunk (not per-read), so 512
#: events cover far more context than a post-mortem needs while bounding
#: the ring's RSS to a few hundred KB.
MAX_RING_EVENTS = 512

#: flight_recorder.json schema version (bump on breaking shape changes;
#: the --report reader degrades unknown shapes, never crashes)
FLIGHT_SCHEMA = 1


class FlightRecorder:
    """Bounded ring of recent spans / instants / heartbeats.

    Fed from three always-cheap taps — ``trace.Span.__exit__``,
    ``trace.instant`` (which robustness/retry.RobustnessRecorder.record
    funnels through, so retries / stalls / chaos injections land here
    too) and ``watchdog.heartbeat`` — and snapshotted on flush. The ring
    drops oldest-first at capacity; the drop count is reported in the
    flushed artifact so truncation is never silent.
    """

    def __init__(self, max_events: int = MAX_RING_EVENTS):
        self._lock = lockcheck.make_lock()
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self.max_events = max_events
        self.events: deque = deque(maxlen=max_events)
        self.total = 0
        self.flush_path: str | None = None
        self.last_flush: dict | None = None

    def _add_locked(self, ev: dict) -> None:
        lockcheck.assert_owner(self, "FlightRecorder._add_locked")
        ev["thread"] = threading.current_thread().name
        self.events.append(ev)
        self.total += 1

    def add_span(self, sp: trace.Span) -> None:
        with self._lock:
            self._add_locked({
                "kind": "span", "name": sp.name,
                "t_s": round(sp.t0 - self.t0_mono, 6),
                "dur_s": round(sp.dur_s, 6),
            })

    def add_instant(self, name: str, args: dict | None = None) -> None:
        ev = {
            "kind": "instant", "name": name,
            "t_s": round(time.monotonic() - self.t0_mono, 6),
        }
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._add_locked(ev)

    def add_beat(self, site: str) -> None:
        with self._lock:
            self._add_locked({
                "kind": "heartbeat", "name": site,
                "t_s": round(time.monotonic() - self.t0_mono, 6),
            })

    def set_flush_path(self, path: str | None) -> None:
        with self._lock:
            self.flush_path = path

    def stats(self) -> dict:
        with self._lock:
            return {
                "buffered": len(self.events),
                "total": self.total,
                "capacity": self.max_events,
                "dropped": max(self.total - len(self.events), 0),
                "last_flush": dict(self.last_flush) if self.last_flush
                else None,
            }

    def flush(self, reason: str) -> str | None:
        """Atomic dump of the ring to ``flush_path`` (tmp + os.replace, so
        a crash mid-flush never leaves a torn artifact). Returns the path
        written, or None when no flush path is configured yet (a crash
        before the output tree exists has nowhere durable to write)."""
        with self._lock:
            path = self.flush_path
            events = list(self.events)
            dropped = max(self.total - len(events), 0)
        if path is None:
            return None
        payload = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "t_wall": round(time.time(), 3),
            "t0_wall": round(self.t0_wall, 3),
            "t0_mono": round(self.t0_mono, 6),
            "pid": os.getpid(),
            "dropped": dropped,
            "events": events,
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        with self._lock:
            self.last_flush = {"reason": reason, "path": path,
                               "t_wall": payload["t_wall"]}
        return path


class ProgressTracker:
    """Current library / graph node position + the /progress ETA.

    Fed by the library loop (pipeline/run.py) and the graph executor
    (graph/executor.py node start/finish/skip). The ETA estimate for each
    plan node comes from, in order: the history-ledger prior matching
    this run's config fingerprint (``load_node_priors``), this run's own
    measured seconds for that node (a later library reuses the earlier
    library's pace), or the mean of whatever estimates exist. The
    in-flight node subtracts its elapsed time (clamped at 0) and, when
    both its declared ``units`` and the prior's are known, rescales the
    prior linearly — the declared-units fallback for workloads whose
    libraries differ in size.
    """

    def __init__(self):
        self._lock = lockcheck.make_lock()
        self.t0_mono = time.monotonic()
        self.libraries_total = 0
        self.libraries_done = 0
        self.library: str | None = None
        self.plan: list[str] = []
        self.done: set[str] = set()
        self.node: str | None = None
        self.node_units: int = 0
        self.node_t0: float | None = None
        # this run's measured pace: node -> {"s": seconds, "units": n}
        self.node_seconds: dict[str, dict] = {}
        # ledger priors (per-execution seconds), same shape
        self.priors: dict[str, dict] = {}

    def set_totals(self, n_libraries: int) -> None:
        with self._lock:
            self.libraries_total = int(n_libraries)

    def set_priors(self, priors: dict[str, dict]) -> None:
        with self._lock:
            self.priors = dict(priors)

    def start_library(self, name: str) -> None:
        with self._lock:
            self.library = name
            self.plan = []
            self.done = set()
            self.node = None
            self.node_t0 = None
            self.node_units = 0

    def finish_library(self) -> None:
        with self._lock:
            if self.library is not None:
                self.libraries_done += 1
            self.library = None
            self.plan = []
            self.done = set()
            self.node = None
            self.node_t0 = None
            self.node_units = 0

    def set_plan(self, names: list[str]) -> None:
        with self._lock:
            self.plan = list(names)
            self.done = set()

    def node_start(self, name: str, units: int | None = None) -> None:
        with self._lock:
            self.node = name
            self.node_units = int(units or 0)
            self.node_t0 = time.monotonic()

    def node_finish(self, name: str, seconds: float,
                    units: int | None = None) -> None:
        with self._lock:
            self.done.add(name)
            self.node_seconds[name] = {"s": float(seconds),
                                       "units": int(units or 0)}
            if self.node == name:
                self.node = None
                self.node_t0 = None
                self.node_units = 0

    def node_skip(self, name: str) -> None:
        with self._lock:
            self.done.add(name)

    def _node_est_locked(self, name: str, est: dict, avg: float) -> float:
        lockcheck.assert_owner(self, "ProgressTracker._node_est_locked")
        v = est.get(name)
        if v is None:
            return avg
        s = float(v.get("s", avg))
        # declared-units rescale for the in-flight node: a prior measured
        # on a differently sized library scales linearly with its units
        if (name == self.node and self.node_units
                and float(v.get("units") or 0) > 0):
            s = s * (self.node_units / float(v["units"]))
        return s

    def snapshot(self) -> dict:
        """The /progress JSON body (one lock hold, no I/O)."""
        now = time.monotonic()
        with self._lock:
            est = dict(self.priors)
            est.update(self.node_seconds)
            eta = None
            basis = None
            if est:
                avg = sum(float(v.get("s", 0.0)) for v in est.values()) / len(est)
                plan = self.plan or sorted(est)
                eta = 0.0
                for name in plan:
                    if name in self.done:
                        continue
                    s = self._node_est_locked(name, est, avg)
                    if name == self.node and self.node_t0 is not None:
                        s = max(s - (now - self.node_t0), 0.0)
                    eta += s
                per_lib = sum(self._node_est_locked(n, est, avg)
                              for n in plan)
                in_flight = 1 if self.library is not None else 0
                libs_left = max(
                    self.libraries_total - self.libraries_done - in_flight, 0
                )
                eta = round(eta + libs_left * per_lib, 3)
                basis = "history_priors" if self.priors else "measured_pace"
            return {
                "uptime_s": round(now - self.t0_mono, 3),
                "library": self.library,
                "libraries_done": self.libraries_done,
                "libraries_total": self.libraries_total,
                "node": self.node,
                "node_units": self.node_units,
                "node_elapsed_s": (round(now - self.node_t0, 3)
                                   if self.node_t0 is not None else None),
                "nodes_done": len(self.done),
                "nodes_total": len(self.plan),
                "eta_s": eta,
                "eta_basis": basis,
            }


# Lock ownership for FlightRecorder / ProgressTracker is declared in the
# port's lock table (robustness/locks.py), which lockcheck reads.


def load_node_priors(ledger_paths: list[str],
                     fingerprint: str) -> dict[str, dict]:
    """Per-node {"s": seconds, "units": n} priors from history ledgers.

    Reads every existing ledger in ``ledger_paths`` through the
    never-crash ``history.read_entries`` reader, keeps entries whose
    config fingerprint matches this run's (so a 10k-read bench never
    predicts a 70M-read capture), and takes the per-execution median:
    ledger entries record a node's seconds/units SUMMED over the run's
    libraries plus the run count, so each sample is sum/runs.
    """
    samples: dict[str, list[tuple[float, float]]] = {}
    for path in ledger_paths:
        if not path or not os.path.exists(path):
            continue
        entries, _problems = history.read_entries(path)
        for entry in entries:
            if entry.get("fingerprint") != fingerprint:
                continue
            nodes = entry.get("nodes")
            if not isinstance(nodes, dict):
                continue
            for name, v in nodes.items():
                if not isinstance(v, dict):
                    continue
                s = v.get("s")
                runs = v.get("runs", 1)
                if not (isinstance(s, (int, float))
                        and not isinstance(s, bool) and s >= 0):
                    continue
                if not (isinstance(runs, int) and runs > 0):
                    runs = 1
                units = v.get("units", 0)
                if not isinstance(units, (int, float)) or units < 0:
                    units = 0
                samples.setdefault(str(name), []).append(
                    (float(s) / runs, float(units) / runs)
                )
    return {
        name: {
            "s": statistics.median(s for s, _ in pairs),
            "units": statistics.median(u for _, u in pairs),
        }
        for name, pairs in samples.items()
    }


# --- Prometheus /metrics rendering ------------------------------------------


def _metrics_text() -> str:
    """The /metrics body: registry families + live watchdog ages.

    Always begins with ``tcr_up 1`` so a scrape of a telemetry-off run
    (registry disarmed) is still a valid, non-empty exposition."""
    lines = [
        "# HELP tcr_up Live plane liveness (1 while the endpoint serves).",
        "# TYPE tcr_up gauge",
        "tcr_up 1",
    ]
    reg = metrics.registry()
    if reg is not None:
        lines.extend(reg.prometheus_lines())
    entries = watchdog.snapshot()
    if entries:
        lines.append("# HELP tcr_watchdog_heartbeat_age_seconds Seconds "
                     "since the stage's last heartbeat.")
        lines.append("# TYPE tcr_watchdog_heartbeat_age_seconds gauge")
        for e in entries:
            stage = metrics.prom_label(e["stage"])
            lines.append(
                f'tcr_watchdog_heartbeat_age_seconds{{stage="{stage}"}} '
                f'{e["heartbeat_age_s"]}'
            )
        lines.append("# TYPE tcr_watchdog_hard_deadline_seconds gauge")
        for e in entries:
            stage = metrics.prom_label(e["stage"])
            lines.append(
                f'tcr_watchdog_hard_deadline_seconds{{stage="{stage}"}} '
                f'{e["hard_deadline_s"]}'
            )
    return "\n".join(lines) + "\n"


def _healthz_payload() -> dict:
    """The /healthz JSON body: liveness + watchdog staleness verdict."""
    entries = watchdog.snapshot()
    stalled = [e["stage"] for e in entries or ()
               if e["heartbeat_age_s"] >= e["soft_deadline_s"]]
    srv = _SERVER
    ring = _RING
    return {
        "status": "stalled" if stalled else "ok",
        "pid": os.getpid(),
        "uptime_s": (round(time.monotonic() - srv.t0_mono, 3)
                     if srv is not None else None),
        "watchdog": {
            "armed": entries is not None,
            "stalled_stages": stalled,
            "stages": entries or [],
        },
        "flight_recorder": ring.stats() if ring is not None else None,
    }


#: request-body cap for POST /jobs — a job submission is a small JSON
#: config-overrides object; anything larger is a client bug, not a job
MAX_JOB_BODY_BYTES = 1 << 20


class _Handler(BaseHTTPRequestHandler):
    """Read-only GET routes, plus POST /jobs when a daemon armed a jobs
    controller; access logging silenced (the endpoint is scraped every
    few seconds — stderr noise would drown run logs)."""

    server_version = "tcr-live/1"

    def log_message(self, fmt, *log_args):  # noqa: A003 - stdlib signature
        pass

    def _send(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: dict) -> None:
        self._send(status, "application/json", json.dumps(payload).encode())

    def do_GET(self) -> None:  # noqa: N802 - stdlib handler name
        metrics.counter_add("live.requests")
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                body = json.dumps(_healthz_payload()).encode()
                self._send(200, "application/json", body)
            elif path == "/metrics":
                self._send(
                    200, "text/plain; version=0.0.4; charset=utf-8",
                    _metrics_text().encode(),
                )
            elif path == "/progress":
                tracker = _PROGRESS
                payload = tracker.snapshot() if tracker is not None else {}
                self._send(200, "application/json",
                           json.dumps(payload).encode())
            elif path == "/jobs" or path.startswith("/jobs/"):
                self._get_jobs(path)
            else:
                self._send(404, "text/plain; charset=utf-8",
                           b"unknown route; try /healthz /metrics /progress"
                           b" /jobs\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-write; nothing to serve

    def _get_jobs(self, path: str) -> None:
        ctl = _JOBS
        if ctl is None:
            self._send_json(503, {
                "error": "no jobs controller armed — /jobs exists only "
                         "under the serve daemon (tcr-consensus-tpu serve)",
            })
            return
        if path == "/jobs":
            self._send_json(200, ctl.jobs_snapshot())
            return
        snap = ctl.job_snapshot(path[len("/jobs/"):])
        if snap is None:
            self._send_json(404, {"error": "unknown job id"})
        else:
            self._send_json(200, snap)

    def do_POST(self) -> None:  # noqa: N802 - stdlib handler name
        """The plane's single mutating route: submit a job to the armed
        daemon controller. Loopback bind remains the security boundary;
        without a controller (every one-shot run) this answers 503 and
        the plane is exactly as read-only as before."""
        metrics.counter_add("live.requests")
        path = self.path.split("?", 1)[0]
        try:
            if path != "/jobs":
                self._send_json(404, {"error": "POST supports /jobs only"})
                return
            ctl = _JOBS
            if ctl is None:
                self._send_json(503, {
                    "error": "no jobs controller armed — POST /jobs exists "
                             "only under the serve daemon",
                })
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = -1
            if length <= 0:
                self._send_json(400, {"error": "missing request body"})
                return
            if length > MAX_JOB_BODY_BYTES:
                metrics.counter_add("serve.rejected")
                metrics.reject_add("body_too_large")
                # drain the declared body before answering: responding
                # while the client is still streaming resets the
                # connection (EPIPE client-side) and the machine-readable
                # 413 would be lost to a transport error
                remaining = length
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self._send_json(413, {
                    "error": "body_too_large",
                    "detail": f"job body over {MAX_JOB_BODY_BYTES} bytes",
                })
                return
            try:
                obj = json.loads(self.rfile.read(length))
            except ValueError:
                self._send_json(400, {"error": "body is not valid JSON"})
                return
            if not isinstance(obj, dict):
                self._send_json(400, {
                    "error": "body must be a JSON object of config overrides",
                })
                return
            status, payload = ctl.submit(obj)
            self._send_json(status, payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-write; nothing to serve


class LiveServer:
    """The 127.0.0.1-only endpoint thread; ``port`` is resolved after
    bind (``live_port: 0`` asks the OS for an ephemeral port — tests)."""

    def __init__(self, port: int):
        self.t0_mono = time.monotonic()
        # loopback bind is the security boundary: the plane is readable
        # by local operators/scrapers only, never the network
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="live-endpoint",
            daemon=True, kwargs={"poll_interval": 0.2},
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# --- process-wide armed plane (same discipline as metrics/trace) ------------

_RING: FlightRecorder | None = None
_PROGRESS: ProgressTracker | None = None
_SERVER: LiveServer | None = None
# daemon-mode jobs controller (serve/daemon.py duck type: submit(dict) ->
# (status, payload), jobs_snapshot() -> dict, job_snapshot(id) -> dict|None)
_JOBS = None
# one-shot observer of graph-node starts (the daemon's dispatch-to-first-
# stage latency tap); called OUTSIDE the tracker lock, exceptions swallowed
_NODE_START_HOOK = None


def _flush_on_expiry(stage: str) -> None:
    flush_armed(f"watchdog_hard_expiry:{stage}")


def arm(port: int) -> LiveServer:
    """Arm the plane: ring + trace/watchdog taps + the HTTP endpoint."""
    global _RING, _PROGRESS, _SERVER
    ring = FlightRecorder()
    _RING = ring
    _PROGRESS = ProgressTracker()
    trace.set_ring(ring)
    watchdog.set_beat_sink(ring.add_beat)
    watchdog.set_expiry_sink(_flush_on_expiry)
    srv = LiveServer(port)
    srv.start()
    _SERVER = srv
    ring_event("live.serve", {"port": srv.port})
    return srv


def disarm() -> None:
    """Tear the plane down (run.py calls this in its finally): unwire the
    taps FIRST so in-flight spans stop feeding a dead ring, then stop the
    server so the port is released for the next run in-process."""
    global _RING, _PROGRESS, _SERVER, _JOBS, _NODE_START_HOOK
    srv = _SERVER
    _SERVER = None
    _RING = None
    _PROGRESS = None
    _JOBS = None
    _NODE_START_HOOK = None
    trace.set_ring(None)
    watchdog.set_beat_sink(None)
    watchdog.set_expiry_sink(None)
    if srv is not None:
        srv.stop()


def server() -> LiveServer | None:
    return _SERVER


def set_jobs_controller(ctl) -> None:
    """Arm (or with None, disarm) the daemon jobs controller behind
    POST/GET ``/jobs``. Owned by serve/daemon.py; one-shot runs never
    call this, so their plane serves no mutating route."""
    global _JOBS
    _JOBS = ctl


def set_node_start_hook(fn) -> None:
    """Arm (or with None, disarm) a graph-node-start observer. The serve
    daemon uses this as its dispatch-to-first-stage latency tap: armed at
    job dequeue, self-disarming at the first node.

    Under a jobscope (the slice-packed runner pool) the hook binds
    thread-locally — each resident tenant job taps its OWN first node;
    stored as a ``(fn,)`` 1-tuple so the in-scope self-disarm tombstones
    instead of falling back to a neighbor's hook."""
    global _NODE_START_HOOK
    if jobscope.active():
        jobscope.set("node_start_hook", (fn,))
        return
    _NODE_START_HOOK = fn


def ring_event(site: str, args: dict | None = None) -> None:
    """Record an instant into the flight ring; free no-op when disarmed."""
    ring = _RING
    if ring is not None:
        ring.add_instant(site, args)


def set_flush_path(path: str) -> None:
    """Point crash/SIGUSR1 flushes at the run's output tree.

    Under a jobscope this is a no-op on the shared ring: the flight
    recorder is ONE process-wide black box owned by the daemon, and two
    resident tenant jobs re-pointing it at their own output trees would
    race — the daemon's state-dir path stays authoritative."""
    if jobscope.active():
        jobscope.set("flush_path", path)
        return
    ring = _RING
    if ring is not None:
        ring.set_flush_path(path)


def flush_armed(reason: str) -> str | None:
    """Flush the armed flight recorder; no-op when disarmed, and NEVER
    raises — every caller is a failure path (crash handler, signal
    handler, watchdog monitor) where a flush error must not mask the
    original fault."""
    ring = _RING
    if ring is None:
        return None
    ring_event("flight.flush", {"reason": reason})
    try:
        return ring.flush(reason)
    except Exception as exc:
        sys.stderr.write(f"live: flight-recorder flush failed: {exc!r}\n")
        return None


def progress_totals(n_libraries: int) -> None:
    tracker = _PROGRESS
    if tracker is not None:
        tracker.set_totals(n_libraries)


def progress_library(name: str) -> None:
    tracker = _PROGRESS
    if tracker is not None:
        tracker.start_library(name)


def progress_library_done() -> None:
    tracker = _PROGRESS
    if tracker is not None:
        tracker.finish_library()


def progress_plan(names: list[str]) -> None:
    """Declare the library's scheduled node names (graph executor)."""
    tracker = _PROGRESS
    if tracker is not None:
        tracker.set_plan(names)


def progress_node_start(name: str, units: int | None = None) -> None:
    tracker = _PROGRESS
    if tracker is not None:
        tracker.node_start(name, units)
    entry = jobscope.get("node_start_hook")
    hook = entry[0] if entry is not None else _NODE_START_HOOK
    if hook is not None:
        try:
            hook(name)
        except Exception:
            pass  # an observer must never fail the stage it observes


def progress_node_finish(name: str, seconds: float,
                         units: int | None = None) -> None:
    tracker = _PROGRESS
    if tracker is not None:
        tracker.node_finish(name, seconds, units)


def progress_node_skip(name: str) -> None:
    tracker = _PROGRESS
    if tracker is not None:
        tracker.node_skip(name)


def configure_eta_priors(ledger_paths: list[str], fingerprint: str) -> None:
    """Load /progress ETA priors from the run's ledgers; the ledger I/O
    only happens when the plane is armed (progress tracker present)."""
    tracker = _PROGRESS
    if tracker is None:
        return
    tracker.set_priors(load_node_priors(ledger_paths, fingerprint))


class Sigusr1Hook:
    """Per-run SIGUSR1 -> on-demand flight-recorder flush.

    Installed by run.py only when the plane is armed; restores the
    previous disposition in the run's finally. ``signal.signal`` is
    main-thread-only — an embedder driving the pipeline from a worker
    thread just loses the on-demand flush (ValueError swallowed), every
    other flush trigger still works.
    """

    def __init__(self):
        self.installed = False
        self.prev = None

    def install(self) -> None:
        if not hasattr(signal, "SIGUSR1"):
            return  # non-POSIX platform
        try:
            self.prev = signal.signal(signal.SIGUSR1, _on_sigusr1)
        except ValueError:
            return
        self.installed = True

    def restore(self) -> None:
        if not self.installed:
            return
        try:
            signal.signal(
                signal.SIGUSR1,
                self.prev if self.prev is not None else signal.SIG_DFL,
            )
        except (ValueError, TypeError, OSError):
            pass  # restoring a disposition is best-effort cleanup
        self.installed = False
        self.prev = None


def _on_sigusr1(signum, frame) -> None:
    flush_armed("sigusr1")
