"""Warm-up launches at the production shape buckets, at daemon start.

The counterpart of the JAX package's ``serve/prewarm.py``. There, each
entry point is lowered and compiled ahead of the first job for the
declared bucket set. The port compiles nothing per shape: its cold costs
are the ``nvcc`` build (or build-cache load) of the six hand kernels, the
CUDA context and cuDNN's GRU handles. So each entry here is one warm-up
launch of the real entry point at a declared bucket, on inputs drawn from
the reference panel (all-zero reads could leave the fused pass's
candidate selection without a candidate):

- ``fused_assign``: the round-1 fused pass (:meth:`~..pipeline.assign.
  AssignEngine.run_batch_async`, kernels B1 and B5 on the card) once per
  declared read-width bucket, at the budget-derived read batch, with the
  daemon's :class:`~..pipeline.assign.AssignEngine` and its real
  constants; on the card the first bucket's entry also warms the UMI
  clustering's distance pass (kernel B6) once, at its dispatch chunk;
- ``polisher``: one call of :func:`~..models.polisher.make_pipeline_polisher`'s
  device path at the JAX package's tile ``(cluster batch, s_bucket,
  largest width, band)``, which recomputes the pileup (kernels B2 and B3) and runs
  the bi-GRU, in bfloat16 where the bf16 gate
  (:func:`~..models.polisher.bf16_serving_certified`) lets the run serve
  it, as in JAX, else in float32.

The report keeps the JAX package's schema (``kind``, ``batch``, ``width``,
``ok``, ``seconds``; ``compiled``/``failed`` count the entries that warmed
or failed) and adds, per entry, the kernel launches it made (``launches``:
``{"B1": n, ..., "B6": n}``, from the wrappers' counters (B4, the QC error
profile's, 0 in a prewarm); 0 on the CPU, whose
plain versions launch no kernel) and, for the whole prewarm, the seconds
the process had spent making kernel libraries ready (``build_s``). An
entry that fails is reported ``ok: false`` with its error, exactly as in
JAX: prewarm is an optimization, the first job then pays the cold cost,
and nothing switches a kernel's route.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.io import bucketing
from ont_tcrconsensus_tpu_torch.ops import (_build, cs_kernel, dovetail_kernel, edit_distance,
                                            fuzzy_kernel, pileup_kernel, sw_kernel,
                                            traceback_kernel)
from ont_tcrconsensus_tpu_torch.ops.encode import PAD_CODE


def declared_width_buckets(cfg) -> list[int]:
    """The read-batch width buckets this config's traffic can produce:
    every declared width up to the one covering ``max_read_length``."""
    cap = (bucketing.bucket_width(cfg.max_read_length)
           or cfg.max_read_length)
    return [w for w in bucketing.DEFAULT_WIDTHS if w <= cap] or [cap]


def _launch_counts() -> dict[str, int]:
    return {"B1": sw_kernel.align_banded_cuda.launches,
            "B2": pileup_kernel.forward_planes_cuda.launches,
            "B3": traceback_kernel.traceback_columns_cuda.launches,
            "B4": cs_kernel.error_profile_cs_cuda.launches,
            "B5": fuzzy_kernel.fuzzy_find_multi_cuda.launches,
            "B6": dovetail_kernel.dovetail_cuda.launches}


def _launches_since(before: dict[str, int]) -> dict[str, int]:
    now = _launch_counts()
    return {k: now[k] - before[k] for k in now}


def _panel_rows(panel, n: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` rows of the panel's reference codes, cycled and cut to
    ``width``: (codes (n, width) uint8, lengths (n,) int32)."""
    codes = np.full((n, width), PAD_CODE, dtype=np.uint8)
    lens = np.zeros((n,), dtype=np.int32)
    for i in range(n):
        r = i % len(panel.names)
        ln = min(int(panel.lens[r]), width)
        codes[i, :ln] = panel.codes[r, :ln]
        lens[i] = ln
    return codes, lens


def _prewarm_fused_assign(cfg, engine, read_batch: int, widths: list[int],
                          report: list[dict]) -> None:
    from ont_tcrconsensus_tpu_torch.obs import device as obs_device

    for width in widths:
        t0 = time.monotonic()
        entry = {"kind": "fused_assign", "batch": read_batch,
                 "width": width}
        before = _launch_counts()
        try:
            codes, lens = _panel_rows(engine.panel, read_batch, width)
            # round-1 fastq serving: quals present, the SW fast path armed
            # by the region-overlap fraction, as run_assign dispatches it
            batch = bucketing.ReadBatch(
                codes=codes, quals=np.full(codes.shape, bucketing.QUAL_FILL, np.uint8),
                lengths=lens, valid=np.ones((read_batch,), bool),
                ids=[""] * read_batch, width=width)
            out = engine.run_batch_async(
                batch, cfg.max_ee_rate_base, cfg.minimal_length,
                overlap_frac=cfg.minimal_region_overlap)
            obs_device.to_host(out)  # the launch has finished on the card
            if engine.device.type == "cuda" and width == widths[0]:
                _prewarm_umi_distance(engine)
            entry["ok"] = True
        except Exception as exc:
            entry["ok"] = False
            entry["error"] = repr(exc)
        entry["launches"] = _launches_since(before)
        entry["seconds"] = round(time.monotonic() - t0, 3)
        report.append(entry)


def _prewarm_umi_distance(engine) -> None:
    """One launch of the UMI clustering's distance pass (kernel B6) at its
    dispatch chunk (``cluster/umi._PAIR_CHUNK`` pairs at ``cluster_umis``'
    pad width, 128), on reference rows cut to that width."""
    from ont_tcrconsensus_tpu_torch.cluster import umi
    from ont_tcrconsensus_tpu_torch.obs import device as obs_device

    codes, lens = _panel_rows(engine.panel, umi._PAIR_CHUNK, 128)
    c = torch.from_numpy(codes).to(engine.device)
    n = torch.from_numpy(lens).to(engine.device)
    obs_device.to_host(edit_distance.pairwise_dovetail(c, n, c.flip(0), n.flip(0)))


def _prewarm_polisher(cfg, engine, budget, widths: list[int],
                      report: list[dict]) -> None:
    from ont_tcrconsensus_tpu_torch.models import polisher as polisher_mod
    from ont_tcrconsensus_tpu_torch.ops import consensus as consensus_mod

    params = polisher_mod.load_default_params()
    if params is None or cfg.polish_method != "rnn":
        report.append({"kind": "polisher", "ok": False,
                       "error": "skipped: no bundled weights or "
                                "polish_method != rnn", "seconds": 0.0})
        return
    wants_v4 = (polisher_mod.params_feature_dim(params)
                == consensus_mod.FEATURE_DIM_V4)
    use_bf16 = cfg.polish_bf16 and polisher_mod.bf16_serving_certified(
        min_polish_depth=cfg.min_polish_depth, device=engine.device)
    s_bucket = bucketing.pow2_ceil(max(cfg.max_reads_per_cluster, 1))
    # the JAX package's tile: the largest declared width (subreads are
    # full-length reads) at the budget-derived cluster batch
    width = max(widths)
    eff_band = (cfg.sw_band_width if width <= 2048
                else max(cfg.sw_band_width, 128))
    cb = cfg.cluster_batch_size or budget.cluster_batch(
        s_bucket, width, eff_band, keep_final_pileup=True,
        keep_pos=wants_v4)
    t0 = time.monotonic()
    entry = {"kind": "polisher", "batch": cb, "s_bucket": s_bucket,
             "width": width, "band": eff_band, "v4": wants_v4}
    before = _launch_counts()
    try:
        polish = polisher_mod.make_pipeline_polisher(
            params, min_polish_depth=cfg.min_polish_depth, bf16=use_bf16,
            device=engine.device)
        drafts, dlens = _panel_rows(engine.panel, cb, width)
        sub = np.ascontiguousarray(
            np.broadcast_to(drafts[:, None, :], (cb, s_bucket, width)))
        lens = np.ascontiguousarray(np.broadcast_to(dlens[:, None], (cb, s_bucket)))
        # no kept pileup: the device path recomputes it (kernels B2 and B3), then
        # the features and the GRUs
        polish(sub, lens, drafts, dlens, band_width=eff_band)
        entry["ok"] = True
    except Exception as exc:
        entry["ok"] = False
        entry["error"] = repr(exc)
    entry["launches"] = _launches_since(before)
    entry["seconds"] = round(time.monotonic() - t0, 3)
    report.append(entry)


def prewarm(cfg, engine, read_batch: int, budget,
            widths: list[int] | None = None) -> dict:
    """Warm the declared bucket set; returns the report dict (recorded
    into the daemon's telemetry via ``analysis_set`` and behind the serve
    ledger entries' ``warmup_s``).

    ``engine`` is the daemon's round-1 :class:`AssignEngine` on the
    daemon's device (its panel and constants are the real launch inputs),
    ``read_batch``/``budget`` come from
    :func:`~..pipeline.run.resolve_batching`. ``widths`` overrides the
    declared bucket set (tests prewarm one small bucket). Mesh-sharded
    configs are skipped, as in the JAX package: their first job warms
    them. On the card every kernel is first built (one ``nvcc`` each,
    started together) or found in the build cache.
    """
    t0 = time.monotonic()
    report: list[dict] = []
    if cfg.mesh_shape:
        return {"skipped": "mesh_shape set — sharded entry points "
                           "prewarm lazily on the first job",
                "entries": [], "seconds": 0.0}
    widths = list(widths) if widths else declared_width_buckets(cfg)
    if engine.device.type == "cuda":
        _build.build_all()
    _prewarm_fused_assign(cfg, engine, read_batch, widths, report)
    _prewarm_polisher(cfg, engine, budget, widths, report)
    return {
        "entries": report,
        "compiled": sum(1 for e in report if e.get("ok")),
        "failed": sum(1 for e in report if not e.get("ok")),
        "build_s": round(_build.seconds(), 3),
        "seconds": round(time.monotonic() - t0, 3),
    }
