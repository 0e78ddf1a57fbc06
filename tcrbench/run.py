"""The benchmark of ``ont_tcrconsensus_tpu_torch`` on NVIDIA cards: one
cell, run once.

    python3 tcrbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``tcrbench/configs/<name>.json``: the run's knobs
and what the reference needs) and a traffic mix
(``tcrbench/traffic/<name>.json``: the generator's parameters).

Set-up: start-up, the kernels (built into ``build/torch_kernels/`` on a
checkout's first run, loaded after), the library generated from the seed
and written under ``build/tcrbench/<workload>/``, one warm lane. Window: a
closed loop, one lab submitting the library again as soon as the last one
is done: ``run_with_config`` lane after lane until ``--seconds`` have
passed (the lane then running finishes and counts). Each lane's
``nano_tcr/`` moves aside and is judged once the window has closed
(:mod:`tcrbench.judge`), with a sample of the window's polish tiles.

``--trace 0`` prints the end-to-end metrics; ``--trace 1`` runs the
window under ``torch.profiler`` (device activity), ``telemetry: "full"``
and the kernels' launch records, and prints the per-layer metrics, each
read by ``tcrbench/metrics/<name>.py``. The last stdout line is the
result; the last stderr lines are the compared numbers and their limits.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import importlib.util
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "ont_tcrconsensus_tpu")


def _log(*parts) -> None:
    print("tcrbench:", *parts, file=sys.stderr, flush=True)


def _since_process_start() -> float:
    """Seconds since this process started (``/proc``), else since import."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def load_cell(root: str, workload: str) -> dict:
    """The cell's entries, found by name: its workload, configuration and
    traffic (files), and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "tcrbench", "traffic", f"{cell['traffic']}.json")) as fh:
        traffic = json.load(fh)

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": cfg, "traffic": traffic, "bench": bench,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def load_reader(root: str, name: str):
    """``tcrbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(root, "tcrbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("tcrbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class PolishRecorder:
    """Keeps, for one drawn polish tile a lane, what the program was given
    and what it made: the packed subreads, the vote drafts, the polisher's
    per-position decisions and the consensus sequences. Host arrays the
    program already made; nothing is copied."""

    def __init__(self):
        self.calls = 0
        self.lane = 0
        self.record_at: int | None = None
        self.active: dict | None = None
        self.records: list[dict] = []

    def install(self, stack: contextlib.ExitStack) -> None:
        from ont_tcrconsensus_tpu_torch.models import polisher as polisher_mod
        from ont_tcrconsensus_tpu_torch.ops import consensus as consensus_mod
        from ont_tcrconsensus_tpu_torch.pipeline import stages

        rec = self
        dispatch = stages._dispatch_polish_packed
        vote = consensus_mod.consensus_clusters_batch
        predictions = polisher_mod._predictions

        @functools.wraps(dispatch)
        def dispatch_rec(packed, C, **kw):
            k, rec.calls = rec.calls, rec.calls + 1
            if k == rec.record_at:
                rec.active = {"lane": rec.lane, "sub": packed[0], "lens": packed[1], "C": C,
                              "band": kw["eff_band"], "rounds": kw["rounds"]}
            try:
                seqs = dispatch(packed, C, **kw)
            finally:
                active, rec.active = rec.active, None
            if active is not None and isinstance(seqs, list):
                active["seqs"] = seqs
                rec.records.append(active)
            return seqs

        @functools.wraps(vote)
        def vote_rec(*args, **kw):
            out = vote(*args, **kw)
            if rec.active is not None:
                rec.active["drafts"], rec.active["dlens"] = out[0], out[1]
            return out

        @functools.wraps(predictions)
        def predictions_rec(*args, **kw):
            out = predictions(*args, **kw)
            if rec.active is not None and "conf" not in rec.active:
                rec.active["conf"], rec.active["ins_conf"] = out[1], out[4]
            return out

        for mod, name, fn in ((stages, "_dispatch_polish_packed", dispatch_rec),
                              (consensus_mod, "consensus_clusters_batch", vote_rec),
                              (polisher_mod, "_predictions", predictions_rec)):
            stack.enter_context(_patched(mod, name, fn))


@contextlib.contextmanager
def _patched(mod, name, fn):
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _force_bf16_polisher(stack: contextlib.ExitStack) -> None:
    """The program's own bfloat16 polisher, served without the exactness
    certificate its gate asks for."""
    from ont_tcrconsensus_tpu_torch.models import polisher as polisher_mod

    stack.enter_context(_patched(polisher_mod, "bf16_serving_certified",
                                 lambda *a, **kw: True))


def _force_bf16_assign(stack: contextlib.ExitStack) -> None:
    """The program's EE filter and sketch cosine, computed in bfloat16: the
    per-base error probabilities, their sum, the rate and its limit; the
    normalized profiles and their product."""
    import torch

    from ont_tcrconsensus_tpu_torch.ops import ee_filter, sketch

    bf16 = torch.bfloat16

    def ee_rate_mask_span(quals, t_start, t_end, max_ee_rate, min_len):
        q = quals.to(bf16)
        pos = torch.arange(q.shape[1], device=q.device, dtype=torch.int32)[None, :]
        in_span = (pos >= t_start[:, None]) & (pos < t_end[:, None])
        perr = torch.pow(torch.tensor(10.0, dtype=bf16, device=q.device), -q / 10.0)
        ee = torch.where(in_span, perr, torch.zeros((), dtype=bf16, device=q.device)).sum(dim=1)
        lens = t_end - t_start
        rate = ee / lens.clamp(min=1).to(bf16)
        return (rate <= torch.tensor(max_ee_rate, dtype=bf16, device=q.device)) & (lens >= min_len)

    def norm(x):
        x = x.to(bf16)
        return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True)).clamp(min=1e-6)

    def candidates_both_strands(read_codes, read_lens, ref_profiles, top_k_=4, k=8, dim=4096):
        fwd = sketch.kmer_profile(read_codes, read_lens, k=k, dim=dim)
        rev = sketch.kmer_profile(sketch.revcomp_batch(read_codes, read_lens), read_lens, k=k,
                                  dim=dim)
        refs_n = norm(ref_profiles)
        fwd_scores = (norm(fwd) @ refs_n.T).float()
        rev_scores = (norm(rev) @ refs_n.T).float()
        is_reverse = rev_scores.max(dim=1).values > fwd_scores.max(dim=1).values
        scores = torch.where(is_reverse[:, None], rev_scores, fwd_scores)
        best, idx = sketch.top_k(scores, top_k_)
        return idx.to(torch.int32), best, is_reverse

    stack.enter_context(_patched(ee_filter, "ee_rate_mask_span", ee_rate_mask_span))
    stack.enter_context(_patched(sketch, "candidates_both_strands", candidates_both_strands))


def _force_bf16(stack: contextlib.ExitStack, polisher: bool) -> None:
    """The control: every float layer the configuration states (the EE
    filter, the sketch cosine and, under ``rnn``, the polisher) computed
    in bfloat16, the nearest precision below its float32."""
    _force_bf16_assign(stack)
    if polisher:
        _force_bf16_polisher(stack)


class LaunchRecorder:
    """The traced run's launches of kernels B1-B6: each kernel's Python
    entry point wrapped to add its launch's operations and bytes, counted
    by ``tcrbench/roofline/<kernel>.py`` from the launch's own inputs (as
    device scalars: no synchronization inside the window)."""

    def __init__(self, root: str):
        self.kernels = {}
        rdir = os.path.join(root, "tcrbench", "roofline")
        for fname in sorted(os.listdir(rdir)):
            if fname.endswith(".py") and not fname.startswith("_"):
                spec = importlib.util.spec_from_file_location(f"tcrbench_roofline_{fname[:-3]}",
                                                              os.path.join(rdir, fname))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                self.kernels[mod.KERNEL] = mod
        self.counts = {k: [] for k in self.kernels}

    def install(self, stack: contextlib.ExitStack) -> None:
        for kernel, mod in self.kernels.items():
            module = importlib.import_module(mod.ENTRY[0])
            orig = getattr(module, mod.ENTRY[1])

            def wrapped(*args, _orig=orig, _mod=mod, _k=kernel, **kw):
                out = _orig(*args, **kw)
                self.counts[_k].append(_mod.count(args, kw, out))
                return out

            functools.update_wrapper(wrapped, orig)
            stack.enter_context(_patched(module, mod.ENTRY[1], wrapped))

    def totals(self) -> dict:
        """Per kernel: launches, operations, bytes and the sum of each
        launch's bound (read back once the window has closed)."""
        import torch

        def num(x):
            return float(x.item()) if torch.is_tensor(x) else float(x)

        out = {}
        for k, rows in self.counts.items():
            rows = [(num(o), num(b)) for o, b in rows]
            out[k] = {"launches": len(rows), "ops": sum(o for o, _ in rows),
                      "bytes": sum(b for _, b in rows),
                      "bound_s": sum(self.kernels[k].bound_s(o, b) for o, b in rows)}
        return out


def _device_events(prof, t0_ns: int, t1_ns: int):
    """The profiler's device operations as (name, start_s, end_s) on the
    clock ``t0_ns`` and ``t1_ns`` (the window's ends) were read from, and
    the offset applied (0 when the profiler stamps with that clock)."""
    from torch.autograd import DeviceType

    raw = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_hidden_event", lambda: False)()]
    if not raw:
        return [], 0
    first = min(s for _, s, _ in raw)
    offset = 0 if t0_ns - 10**9 <= first <= t1_ns + 10**9 else first - t0_ns
    return [(n, (s - offset) / 1e9, (e - offset) / 1e9) for n, s, e in raw], offset


def _merge(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_breakdown(events, w0: float, w1: float, host_spans) -> dict:
    """Busy seconds (the union of device operations inside the window),
    the ten device operations with the most time, and the ten host stages
    under which the device idled longest."""
    clipped = [(max(s, w0), min(e, w1)) for _, s, e in events if e > w0 and s < w1]
    merged = _merge(clipped)
    busy = sum(e - s for s, e in merged)
    by_name: dict[str, float] = {}
    for n, s, e in events:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host_spans = sorted(host_spans, key=lambda x: x[1])
    idle: dict[str, float] = {}
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        label = "between stages"
        for name, s, e in host_spans:
            if s <= mid <= e:
                label = name
        idle[label] = idle.get(label, 0.0) + (ge - gs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "device_ops": [[n[:160], v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            with contextlib.suppress(OSError):
                total += os.path.getsize(os.path.join(dirpath, f))
    return total


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: str = ROOT,
             device: str = "cuda", traffic: dict | None = None, control: bool = False,
             work: str | None = None) -> dict:
    """One run of a cell; the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, [``breakdown``], ``check``) and,
    under ``_info``, the set-up parts and disk bytes. ``traffic`` replaces
    the cell's traffic file (the tests' tiny lanes); ``control`` runs the
    control in the program's place: its EE filter and sketch cosine in
    bfloat16 and, under ``rnn``, its own bfloat16 polisher, forced past its
    certificate."""
    import numpy as np
    import torch

    from tcrbench import gen, judge

    spec = load_cell(root, workload)
    cfg, traffic = spec["config"], traffic or spec["traffic"]
    knobs = dict(cfg["knobs"])
    check = cfg["check"]
    on_card = device == "cuda"
    info: dict = {"setup": {}}

    from ont_tcrconsensus_tpu_torch.pipeline.config import RunConfig
    from ont_tcrconsensus_tpu_torch.pipeline.run import run_with_config

    if on_card:
        torch.cuda.init()
        torch.zeros(1, device="cuda")
    info["setup"]["startup_s"] = _since_process_start()
    t0 = time.perf_counter()
    if on_card:
        from ont_tcrconsensus_tpu_torch.io import native
        from ont_tcrconsensus_tpu_torch.ops import _build

        _build.use_build_dir(_build.DEFAULT_BUILD_DIR)
        _build.build_all()
        for name in _build.KERNELS:
            _build.load(name)
        native.load()
    info["setup"]["kernels_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lib = gen.generate(traffic, seed)
    work = work or os.path.join(root, "build", "tcrbench", workload)
    shutil.rmtree(work, ignore_errors=True)
    ref_path, fq_dir = gen.write_lane(lib, os.path.join(work, "lane"))
    info["setup"]["data_s"] = time.perf_counter() - t0
    info["reads"] = len(lib.reads)
    info["molecules"] = len(lib.molecules)
    info["input_bytes"] = _dir_bytes(os.path.join(work, "lane"))

    weights = (os.path.join(root, cfg["polisher_weights"])
               if knobs.get("polish_method", "rnn") == "rnn" else None)
    raw = {"reference_file": ref_path, "fastq_pass_dir": fq_dir, **knobs}
    if trace:
        raw["telemetry"] = "full"
    if control and weights is not None:
        raw["polish_bf16"] = True
    run_cfg = RunConfig.from_dict(raw)
    nano = os.path.join(fq_dir, "nano_tcr")
    lanes_dir = os.path.join(work, "lanes")
    os.makedirs(lanes_dir)

    t0 = time.perf_counter()
    warm = PolishRecorder()
    with contextlib.ExitStack() as stack:
        if control:
            _force_bf16(stack, weights is not None)
        warm.install(stack)
        run_with_config(run_cfg, device=device)
    shutil.rmtree(nano)
    n_calls = warm.calls
    if on_card:
        torch.cuda.synchronize()
    info["setup"]["warm_lane_s"] = time.perf_counter() - t0
    # set-up's objects (the library, the loaded modules) leave the
    # collector's generations, so no full collection walks them in the window
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = _since_process_start()
    info["setup"]["setup_s"] = setup_s
    _log("set-up", json.dumps(info["setup"]))

    rng = np.random.default_rng([seed, 1])
    rec = PolishRecorder()
    launches = LaunchRecorder(root) if trace and on_card else None
    lane_s, timings, failed = [], [], 0
    prof = None
    with contextlib.ExitStack() as stack:
        if control:
            _force_bf16(stack, weights is not None)
        rec.install(stack)
        if launches is not None:
            launches.install(stack)
        if trace and on_card:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        t_w0_ns = time.time_ns()
        w0 = time.perf_counter()
        while True:
            rec.calls, rec.lane = 0, len(lane_s)
            rec.record_at = int(rng.integers(max(n_calls, 1)))
            stage_s: dict[str, float] = {}
            t_lane = time.perf_counter()
            try:
                run_with_config(run_cfg, device=device, timings=stage_s)
            except Exception as exc:  # a lane that fails is judged as failed
                failed += 1
                _log(f"lane {len(lane_s)} failed: {exc!r}")
            if on_card:
                torch.cuda.synchronize()
            lane_s.append(time.perf_counter() - t_lane)
            timings.append(stage_s)
            if os.path.isdir(nano):
                os.rename(nano, os.path.join(lanes_dir, str(len(lane_s) - 1)))
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        t_w1_ns = time.time_ns()
        if prof is not None:
            prof.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_lanes = len(lane_s)
    info["lane_s"] = lane_s
    info["lane_bytes"] = [_dir_bytes(os.path.join(lanes_dir, d)) for d in sorted(os.listdir(lanes_dir))]

    ctx = {"lanes": n_lanes, "lane_s": lane_s, "timings": timings, "window_s": window_s,
           "telemetry": []}
    for k in range(n_lanes):
        path = os.path.join(lanes_dir, str(k), "telemetry.json")
        if os.path.exists(path):
            with open(path) as fh:
                ctx["telemetry"].append(json.load(fh))
    breakdown = None
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if prof is not None:
        events, offset = _device_events(prof, t_w0_ns, t_w1_ns)
        host_spans = []
        for k in range(n_lanes):
            path = os.path.join(lanes_dir, str(k), "logs", "trace.json")
            if os.path.exists(path):
                with open(path) as fh:
                    tr = json.load(fh)
                t0w = tr["otherData"]["t0_wall"]
                host_spans += [(e["name"], t0w + e["ts"] / 1e6, t0w + (e["ts"] + e["dur"]) / 1e6)
                               for e in tr["traceEvents"]
                               if e.get("ph") == "X" and e.get("cat") == "stage"]
        bd = device_breakdown(events, t_w0_ns / 1e9, t_w1_ns / 1e9, host_spans)
        del prof
        kern = launches.totals()
        for name, k in kern.items():
            k["device_s"] = sum(e - s for n, s, e in events if name in n)
        ctx.update(busy_s=bd["busy_s"], kernels=kern, trace_window_s=(t_w1_ns - t_w0_ns) / 1e9)
        dev_info.update(busy_s=bd["busy_s"], window_s=(t_w1_ns - t_w0_ns) / 1e9)
        breakdown = {"device_ops": bd["device_ops"], "idle_gaps": bd["idle_gaps"]}
        info["kernels"] = kern
        info["profiler_clock_offset_ns"] = offset
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the comparison, once the window has closed and the peak is read
    t0 = time.perf_counter()
    sem = {**cfg["semantics"], **knobs}
    drawn = np.random.default_rng([seed, 2]).choice(
        len(lib.reads), size=min(int(check["sample_reads"]), len(lib.reads)), replace=False)
    near = judge.near_limit(lib, sem, cfg["primers"], int(check["sample_near_limit"]))
    sample = np.union1d(drawn, near)
    exp = judge.Expected(lib, sem, cfg["primers"], sample, weights)
    parts = {"expected_s": time.perf_counter() - t0}
    numbers = {"assign_off": 0, "round2_off": 0, "counts_off": 0}
    lanes = {}
    for k in range(n_lanes):
        lane_numbers, lanes[k] = judge.judge_lane(os.path.join(lanes_dir, str(k)), exp)
        for key, v in lane_numbers.items():
            numbers[key] += v
    parts["lanes_s"] = time.perf_counter() - t0 - parts["expected_s"]
    numbers["clusters_off"] = judge.judge_members(
        [r for r in rec.records if r["lane"] in lanes], lanes, exp)
    t1 = time.perf_counter()
    polish = judge.judge_polish([r for r in rec.records if r["lane"] in lanes], lanes, exp,
                                np.random.default_rng([seed, 3]), int(check["sample_clusters"]))
    del lanes
    numbers.update({k: v for k, v in polish.items() if k != "clusters_checked"})
    numbers["lanes_failed"] = failed
    numbers = {k: v.item() if hasattr(v, "item") else v for k, v in numbers.items()}
    parts["polish_s"] = time.perf_counter() - t1
    info["check_s"] = time.perf_counter() - t0
    info["check_parts"] = parts
    info["clusters_checked"] = polish["clusters_checked"]
    limits = {**{k: 0 for k in numbers}, **check.get("limits", {})}
    correct = all(numbers[k] <= limits[k] for k in numbers) and n_lanes > 0
    shutil.rmtree(work, ignore_errors=True)

    n_reads = len(lib.reads)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            value = load_reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"reads_per_s": n_reads * n_lanes / window_s,
               "peak_device_gb": peak / 1e9,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in e2e}
    result = {"correct": bool(correct), "attempted": n_lanes, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    result["_info"] = info
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the control in the program's place (never a benchmark run)")
    args = p.parse_args(argv)
    import torch

    try:
        spec = load_cell(os.getcwd(), args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as exc:
        _log(f"cannot load the cell: {exc!r}")
        return 2
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        _log(f"needs {need} CUDA device(s), found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import ont_tcrconsensus_tpu_torch as program
    except ImportError as exc:
        _log(f"the program is not in this checkout: {exc!r}")
        return 2
    if not os.path.abspath(program.__file__).startswith(os.path.join(os.getcwd(), "")):
        _log(f"the program was found outside this checkout: {program.__file__}")
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          root=os.getcwd(), control=args.control)
    except RuntimeError as exc:
        _log(f"failed: {exc}")
        return 1
    bad = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if bad:
        _log(f"modules loaded in the run's process: {bad}")
        return 1
    info = result.pop("_info")
    print(json.dumps({"info": info}))
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
