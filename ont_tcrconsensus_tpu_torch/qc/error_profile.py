"""cs-tag-style alignment difference profiling.

A copy of the JAX package's ``qc/error_profile.py``. The reference dumps,
per alignment pass, the 40 most common minimap2 ``cs`` difference strings
with their region and blast-id breakdowns; this pipeline has no BAM or cs
tags, so the difference strings are rebuilt from a banded unit-cost global
alignment of each sampled read against the reference span it aligned to,
in cs syntax:

    :N      run of N matches
    *<r><q> substitution (reference base, query base)
    +<seq>  insertion in the query
    -<seq>  deletion from the reference

Two routes give the same strings. On the CPU, numpy: :func:`banded_cs`
read by read and :func:`banded_cs_batch` over a batch. On the card,
:func:`banded_cs_batch_device`: the DP fill and its traceback over a tile
of reads, computed as the JAX package's ``_device_cs_core`` computes them
(two XLA scans there), as kernel B4 (``csrc/error_profile_cs.cu``, one
launch a tile, :func:`cs_core_auto`); its plain twin, the fill as a loop
over rows and the traceback as a loop over steps of a few PyTorch
operations each (:func:`_device_cs_core`), takes CPU tensors. Only a
per-step op log comes back to the host. :func:`profile_store` samples a
read store and picks the route from the device.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.ops import cs_kernel, encode
from ont_tcrconsensus_tpu_torch.robustness import watchdog

_BASE = "acgtn"  # cs syntax is lowercase


def banded_cs(query: np.ndarray, ref: np.ndarray, band: int = 96) -> str:
    """cs difference string of a banded global alignment (unit costs).

    Args:
      query/ref: dense uint8 code arrays (no padding).
    """
    q = np.asarray(query, dtype=np.int16)
    r = np.asarray(ref, dtype=np.int16)
    n, m = len(q), len(r)
    if n == 0:
        return f"-{''.join(_BASE[c] for c in r)}" if m else ""
    if m == 0:
        return f"+{''.join(_BASE[c] for c in q)}"
    # band around the length-interpolated diagonal
    half = max(band // 2, abs(n - m) + 8)
    BIG = 1 << 20
    # rows: query positions 0..n; per row keep [lo, lo+W) of ref positions
    W = 2 * half + 1
    ptr = np.zeros((n + 1, W), dtype=np.uint8)  # 0 diag, 1 up(q-gap? see below), 2 left
    prev = np.full(W, BIG, dtype=np.int64)
    lo_of = [0] * (n + 1)

    def row_lo(i: int) -> int:
        center = round(i * m / n)
        return max(0, min(center - half, m))

    lo = row_lo(0)
    lo_of[0] = lo
    js = np.arange(lo, min(lo + W, m + 1))
    prev[: len(js)] = js  # D[0][j] = j deletions
    ptr[0, : len(js)] = 2

    for i in range(1, n + 1):
        nlo = row_lo(i)
        lo_of[i] = nlo
        cur = np.full(W, BIG, dtype=np.int64)
        js = np.arange(nlo, min(nlo + W, m + 1))
        k = len(js)
        # shift the previous row into this row's band frame:
        # aligned_prev[t] = prev value at ref position (nlo + t - 1)
        shift = nlo - lo
        aligned_prev = np.full(W + 1, BIG, dtype=np.int64)
        t = np.arange(W + 1)
        src = t + shift - 1
        okm = (src >= 0) & (src < W)
        aligned_prev[okm] = prev[src[okm]]
        diag = aligned_prev[:W]                       # prev row, j-1
        up = aligned_prev[1 : W + 1]                  # prev row, j
        qi = q[i - 1]
        jmask = js >= 1
        rj = r[np.clip(js - 1, 0, m - 1)]
        sub = np.where((rj == qi) & (qi < 4) & (rj < 4), 0, 1)
        d = np.where(jmask[:k], diag[:k] + sub[:k], BIG)
        u = up[:k] + 1
        best = np.minimum(d, u)
        p = np.where(u < d, 1, 0).astype(np.uint8)    # ties prefer diag
        # left (ref-base deletion) chains collapse under unit cost:
        # left[j] = min_{l<j}(best[l] + (j-l)) via a prefix-min cascade
        idx = np.arange(k)
        run_min = np.minimum.accumulate(best - idx)
        left = run_min[np.maximum(idx - 1, 0)] + idx
        left[0] = BIG
        take_left = left < best
        best = np.where(take_left, left, best)
        p = np.where(take_left, 2, p).astype(np.uint8)
        cur[:k] = best
        ptr[i, :k] = p
        prev = cur
        lo = nlo

    return _traceback_cs(q, r, ptr, lo_of, W)


def _traceback_cs(q, r, ptr, lo_of, W) -> str:
    """Emit the cs string from a filled pointer matrix (shared by the
    single-read and batched fills)."""
    n, m = len(q), len(r)
    i, jpos = n, m
    ops: list[tuple[str, str]] = []  # (op, payload)
    while i > 0 or jpos > 0:
        lo = lo_of[i]
        t = jpos - lo
        if t < 0 or t >= W:
            # fell off the band — bail with a conservative tail
            break
        p = ptr[i, t]
        if i > 0 and jpos > 0 and p == 0:
            qc, rc = q[i - 1], r[jpos - 1]
            if qc == rc and qc < 4:
                ops.append((":", ""))
            else:
                ops.append(("*", _BASE[rc] + _BASE[qc]))
            i -= 1
            jpos -= 1
        elif i > 0 and p == 1:
            ops.append(("+", _BASE[q[i - 1]]))
            i -= 1
        elif jpos > 0:
            ops.append(("-", _BASE[r[jpos - 1]]))
            jpos -= 1
        else:
            ops.append(("+", _BASE[q[i - 1]]))
            i -= 1
    ops.reverse()

    # compress to cs syntax
    out: list[str] = []
    match_run = 0
    k = 0
    while k < len(ops):
        op, payload = ops[k]
        if op == ":":
            match_run += 1
            k += 1
            continue
        if match_run:
            out.append(f":{match_run}")
            match_run = 0
        if op == "*":
            out.append(f"*{payload}")
            k += 1
        else:  # run-collect insertions/deletions
            run = [payload]
            k += 1
            while k < len(ops) and ops[k][0] == op:
                run.append(ops[k][1])
                k += 1
            out.append(op + "".join(run))
    if match_run:
        out.append(f":{match_run}")
    return "".join(out)


def banded_cs_batch(queries: list[np.ndarray], refs: list[np.ndarray],
                    band: int = 96) -> list[str]:
    """Batched :func:`banded_cs`: one vectorized DP fill across reads.

    Bit-identical to the single-read version (per-read band geometry is
    preserved by masking each read's out-of-band lanes), but the row loop
    runs once for the whole batch — the QC profiling pass drops from
    ~0.2 s/read of small-array numpy calls to a few seconds per thousand
    reads. Band-width outliers (clipped alignments with |n-m| far above the
    band, whose wide lanes would inflate the shared pointer tensor for the
    whole batch) fall back to the single-read path.
    """
    B = len(queries)
    if B == 0:
        return []
    qs = [np.asarray(q, dtype=np.int16) for q in queries]
    rs = [np.asarray(r, dtype=np.int16) for r in refs]
    ns = np.array([len(q) for q in qs], np.int32)
    ms = np.array([len(r) for r in rs], np.int32)
    # degenerate rows handled scalar (identical to banded_cs early-outs)
    out: list[str | None] = [None] * B
    halves_all = np.maximum(band // 2, np.abs(ns - ms) + 8)
    w_cap = 2 * max(band // 2, 128) + 1
    live = []
    for b in range(B):
        if ns[b] == 0:
            out[b] = f"-{''.join(_BASE[c] for c in rs[b])}" if ms[b] else ""
        elif ms[b] == 0:
            out[b] = f"+{''.join(_BASE[c] for c in qs[b])}"
        elif 2 * halves_all[b] + 1 > w_cap:
            out[b] = banded_cs(qs[b], rs[b], band=band)  # band outlier
        else:
            live.append(b)
    if not live:
        return [s if s is not None else "" for s in out]

    idx = np.array(live)
    n_arr, m_arr = ns[idx], ms[idx]
    L = len(idx)
    n_max = int(n_arr.max())
    m_max = int(m_arr.max())
    halves = halves_all[idx]
    Ws = 2 * halves + 1
    W = int(Ws.max())
    BIG = 1 << 20

    qpad = np.zeros((L, n_max), np.int16)
    rpad = np.zeros((L, m_max), np.int16)
    for k, b in enumerate(live):
        qpad[k, : ns[b]] = qs[b]
        rpad[k, : ms[b]] = rs[b]

    # per-read, per-row band starts: row_lo(i) = clip(round(i*m/n) - half, 0, m)
    # (multiply-then-divide like banded_cs's round(i*m/n): exact int product
    # before the fp divide, so half-way cases round identically)
    rows = np.arange(n_max + 1, dtype=np.int32)[None, :]
    centers = np.rint(rows * m_arr[:, None] / n_arr[:, None]).astype(np.int32)
    lo_all = np.clip(centers - halves[:, None], 0, None)
    lo_all = np.minimum(lo_all, m_arr[:, None])          # (L, n_max+1)

    ptr = np.zeros((L, n_max + 1, W), dtype=np.uint8)
    lanes = np.arange(W, dtype=np.int32)[None, :]        # (1, W)
    lane_ok = lanes < Ws[:, None]                        # per-read band width

    # row 0: D[0][j] = j deletions for j in [lo, lo+W) ∩ [0, m]
    js0 = lo_all[:, 0:1] + lanes
    valid0 = lane_ok & (js0 <= m_arr[:, None])
    prev = np.where(valid0, js0, BIG).astype(np.int32)
    ptr[:, 0, :] = np.where(valid0, 2, 0)

    for i in range(1, n_max + 1):
        alive = i <= n_arr                               # (L,)
        nlo = lo_all[:, i]
        shift = nlo - lo_all[:, i - 1]                   # (L,)
        # aligned_prev[t] = prev at lane (t + shift - 1); [:W] = diag, [1:] = up
        src = lanes + shift[:, None] - 1                 # (L, W) for diag
        okm = (src >= 0) & (src < W)
        diag = np.where(okm, np.take_along_axis(prev, np.clip(src, 0, W - 1), 1), BIG)
        src_up = src + 1
        oku = (src_up >= 0) & (src_up < W)
        up = np.where(oku, np.take_along_axis(prev, np.clip(src_up, 0, W - 1), 1), BIG)

        js = nlo[:, None] + lanes                        # (L, W) ref positions
        valid = lane_ok & (js <= m_arr[:, None]) & alive[:, None]
        qi = qpad[np.arange(L), np.minimum(i, n_arr) - 1][:, None]  # (L, 1)
        rj = np.take_along_axis(rpad, np.clip(js - 1, 0, m_max - 1), 1)
        sub = np.where((rj == qi) & (qi < 4) & (rj < 4), 0, 1)
        d = np.where(js >= 1, diag + sub, BIG)
        u = up + 1
        best = np.minimum(d, u)
        p = np.where(u < d, 1, 0).astype(np.uint8)       # ties prefer diag
        best = np.where(valid, best, BIG)
        # left (ref-gap) chains collapse under unit cost: prefix-min cascade
        run_min = np.minimum.accumulate(best - lanes, axis=1)
        left = np.take_along_axis(run_min, np.maximum(lanes - 1, 0), 1) + lanes
        left[:, 0] = BIG
        take_left = (left < best) & valid
        best = np.where(take_left, left, best)
        p = np.where(take_left, 2, p).astype(np.uint8)
        cur = np.where(valid, best, BIG).astype(np.int32)
        ptr[:, i, :] = np.where(valid, p, 0)
        prev = np.where(alive[:, None], cur, prev)

    for k, b in enumerate(live):
        out[b] = _traceback_cs(
            qs[b], rs[b], ptr[k], lo_all[k, : ns[b] + 1], int(Ws[k])
        )
    return [s if s is not None else "" for s in out]


# ---------------------------------------------------------------------------
# device cs path: the fill and the traceback on the run's device (kernel B4
# on the card, the plain loops on CPU tensors); only a compact per-step op
# log (kind + the two base codes) returns to the host, where the cs string
# is assembled per contiguous segment instead of per base. Output equals
# banded_cs_batch string for string (tests/test_torch_qc.py,
# tests/test_torch_error_profile_kernel.py, and chip_smoke.py on the card).

_K_MATCH, _K_SUB, _K_INS, _K_DEL, _K_STOP = 0, 1, 2, 3, 4
_BIG = 1 << 20
# the traceback checks every this many steps whether all walks ended
_TB_CHECK_EVERY = 64


def cs_core_auto(qpad, rpad, n_arr, m_arr, lo_all, ws, *, w_pad: int):
    """The op log of one tile: the plain :func:`_device_cs_core` for CPU
    tensors, kernel B4 (:func:`..ops.cs_kernel.error_profile_cs_cuda`,
    uint8 codes) for CUDA tensors, launched once. Both log the walks equal
    up to each walk's first STOP; B4's log has all N + M rows."""
    if qpad.device.type == "cpu":
        return _device_cs_core(qpad, rpad, n_arr, m_arr, lo_all, ws, w_pad=w_pad,
                               n_fill=int(n_arr.max()))
    return cs_kernel.error_profile_cs_cuda(qpad, rpad, n_arr, m_arr, lo_all, ws, w_pad)


def _device_cs_core(qpad, rpad, n_arr, m_arr, lo_all, ws, *, w_pad: int, n_fill: int):
    """Banded unit-cost DP fill + traceback on the tensors' device, the
    plain version of kernel B4.

    Args: qpad (L, N) and rpad (L, M) integer codes, n_arr/m_arr (L,) int32,
    lo_all (L, N+1) int32 per-row band starts, ws (L,) int32 per-read band
    widths; ``w_pad`` >= ws.max(); ``n_fill`` = n_arr.max() (rows past
    every read's end only carry the previous row, so the fill stops there).
    Returns (kind, qb, rb): (S, L) uint8 step logs in traceback (reverse)
    order, kind == _K_STOP past a walk's end; S <= N + M, the loop ending
    once every walk has ended. Row by row the semantics of banded_cs_batch:
    ties prefer diagonal over up, a strict ``<`` lets the left chain win,
    and a walk that falls off its band stops with the conservative tail.
    """
    L, N = qpad.shape
    M = rpad.shape[1]
    dev = qpad.device
    i32, u8 = torch.int32, torch.uint8
    qpad, rpad = qpad.to(i32), rpad.to(i32)
    lanes = torch.arange(w_pad, dtype=i32, device=dev)[None, :]
    lanes1 = torch.arange(w_pad + 1, dtype=i32, device=dev)[None, :]
    lane_ok = lanes < ws[:, None]
    m_col = m_arr[:, None]
    big_col = torch.full((L, 1), _BIG, dtype=i32, device=dev)
    lo_rows = lo_all.t().contiguous()                        # (N+1, L)
    # per row: the diagonal's source lane offset, the query base compared
    # (N bases never match: -1 equals no reference code) and liveness
    src_off = lo_rows[1:] - lo_rows[:-1] - 1                  # (N, L)
    rows = torch.arange(1, N + 1, dtype=i32, device=dev)[:, None]
    q_live = torch.where(qpad < 4, qpad, -1)
    qi_rows = q_live.gather(1, (torch.minimum(rows.t(), n_arr[:, None]) - 1).clamp(0, N - 1)
                            .long()).t().contiguous()        # (N, L)
    alive_rows = (rows <= n_arr[None, :])[:, :, None]         # (N, L, 1)
    rpad_l = rpad.long()

    js0 = lo_rows[0][:, None] + lanes
    valid0 = lane_ok & (js0 <= m_col)
    prev = torch.where(valid0, js0, _BIG)
    ptr = torch.zeros((N + 1, L, w_pad), dtype=u8, device=dev)
    ptr[0] = valid0.to(u8) * 2
    for i in range(1, n_fill + 1):
        src = lanes1 + src_off[i - 1][:, None]
        gathered = prev.gather(1, src.clamp(0, w_pad - 1).long())
        aligned = torch.where((src >= 0) & (src < w_pad), gathered, _BIG)
        diag, up = aligned[:, :w_pad], aligned[:, 1:]
        js = lo_rows[i][:, None] + lanes
        valid = lane_ok & (js <= m_col) & alive_rows[i - 1]
        rj = rpad.gather(1, (js - 1).clamp(0, M - 1).long())
        d = torch.where(js >= 1, diag + (rj != qi_rows[i - 1][:, None]), _BIG)
        u = up + 1
        best = torch.where(valid, torch.minimum(d, u), _BIG)
        # left (ref-gap) chains collapse under unit cost: prefix-min cascade
        run_min = torch.cummin(best - lanes, dim=1).values
        left = torch.cat([big_col, run_min[:, :-1] + lanes[:, 1:]], dim=1)
        take_left = (left < best) & valid
        p = torch.where(take_left, 2, (u < d).to(u8))      # ties prefer diag
        ptr[i] = torch.where(valid, p, 0)
        cur = torch.where(valid, torch.where(take_left, left, best), _BIG)
        prev = torch.where(alive_rows[i - 1], cur, prev)

    ptr_flat = ptr.reshape(-1)
    read_off = torch.arange(L, device=dev, dtype=torch.int64) * w_pad
    row_stride = L * w_pad
    lo_l = lo_all.long()
    ws_l = ws.long()
    i = n_arr.long()
    j = m_arr.long()
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    kinds, qbs, rbs = [], [], []
    for s in range(N + M):
        lo_i = lo_l.gather(1, i[:, None])[:, 0]
        t = j - lo_i
        in_band = (t >= 0) & (t < ws_l)
        walking = ((i > 0) | (j > 0)) & ~done
        act = walking & in_band
        p = ptr_flat[i * row_stride + read_off + t.clamp(0, w_pad - 1)]
        qc = qpad.gather(1, (i - 1).clamp(min=0)[:, None])[:, 0]
        rc = rpad_l.gather(1, (j - 1).clamp(min=0)[:, None])[:, 0]
        is_diag = (i > 0) & (j > 0) & (p == 0)
        is_up = ~is_diag & (i > 0) & (p == 1)
        # what is neither diagonal nor up steps left while j > 0; the rest
        # (i > 0, j == 0, p != 1) is a query insertion, the python walk's
        # final else branch
        is_left = ~is_diag & ~is_up & (j > 0)
        kind = torch.where(
            is_diag, torch.where((qc == rc) & (qc < 4), _K_MATCH, _K_SUB),
            torch.where(is_left, _K_DEL, _K_INS),
        )
        kinds.append(torch.where(act, kind, _K_STOP).to(u8))
        qbs.append(qc.to(u8))
        rbs.append(rc.to(u8))
        i = i - (act & ~is_left).long()
        j = j - (act & (is_diag | is_left)).long()
        done = done | (walking & ~in_band) | ((i == 0) & (j == 0))
        if s % _TB_CHECK_EVERY == _TB_CHECK_EVERY - 1 and bool(done.all()):
            break
    return torch.stack(kinds), torch.stack(qbs), torch.stack(rbs)


def _cs_from_oplog(kind: np.ndarray, qb: np.ndarray, rb: np.ndarray) -> str:
    """cs string from ONE read's reverse-order op log (1-D arrays)."""
    stop = np.flatnonzero(kind == _K_STOP)
    end = int(stop[0]) if stop.size else kind.size
    k = kind[:end][::-1]
    q = qb[:end][::-1]
    r = rb[:end][::-1]
    if end == 0:
        return ""
    bounds = np.flatnonzero(np.diff(k)) + 1
    out: list[str] = []
    start = 0
    for stop_ in list(bounds) + [end]:
        seg_kind = int(k[start])
        ln = stop_ - start
        if seg_kind == _K_MATCH:
            out.append(f":{ln}")
        elif seg_kind == _K_SUB:
            out.append("".join(
                f"*{_BASE[r[s]]}{_BASE[q[s]]}" for s in range(start, stop_)
            ))
        elif seg_kind == _K_INS:
            out.append("+" + "".join(_BASE[c] for c in q[start:stop_]))
        else:
            out.append("-" + "".join(_BASE[c] for c in r[start:stop_]))
        start = stop_
    return "".join(out)


def _bucket(x: int, q: int) -> int:
    return -(-x // q) * q


def _tile_inputs(qs: list[np.ndarray], rs: list[np.ndarray], part: list[int],
                 halves_all: np.ndarray):
    """One tile's inputs to the fill + traceback, numpy: codes qpad (L_pad,
    N) and rpad (L_pad, M) uint8, n, m (L_pad,) int32, the band starts
    lo_all (L_pad, N+1) int32 (float64 ``np.rint`` of the interpolated
    diagonal, as the JAX package rounds), ws (L_pad,) int32, and w_pad.
    Lengths are bucketed to 256 and band lanes to 64; the read axis is
    padded to 64 with one-base pad rows whose walks are discarded."""
    L = len(part)
    ns = np.array([len(qs[b]) for b in part], np.int32)
    ms = np.array([len(rs[b]) for b in part], np.int32)
    halves = halves_all[part]
    ws = 2 * halves + 1
    N = _bucket(int(ns.max()), 256)
    M = _bucket(int(ms.max()), 256)
    w_pad = _bucket(int(ws.max()), 64)
    L_pad = _bucket(L, 64)
    qpad = np.zeros((L_pad, N), np.uint8)
    rpad = np.zeros((L_pad, M), np.uint8)
    for k, b in enumerate(part):
        qpad[k, : ns[k]] = qs[b]
        rpad[k, : ms[k]] = rs[b]
    n_full = np.ones(L_pad, np.int32)  # pad rows: 1-base walks, discarded
    m_full = np.ones(L_pad, np.int32)
    n_full[:L] = ns
    m_full[:L] = ms
    ws_full = np.full(L_pad, ws.max() if L else 1, np.int32)
    ws_full[:L] = ws
    rows = np.arange(N + 1, dtype=np.int32)[None, :]
    centers = np.rint(rows * m_full[:, None] / n_full[:, None]).astype(np.int32)
    halves_full = np.ones(L_pad, np.int32)
    halves_full[:L] = halves
    lo_all = np.clip(centers - halves_full[:, None], 0, None)
    lo_all = np.minimum(lo_all, m_full[:, None]).astype(np.int32)
    return qpad, rpad, n_full, m_full, lo_all, ws_full, w_pad


def banded_cs_batch_device(queries: list[np.ndarray], refs: list[np.ndarray],
                           band: int = 96, tile: int = 512,
                           device: str | torch.device | None = None) -> list[str]:
    """Device twin of :func:`banded_cs_batch` (the same strings), on
    ``device`` (the card when None).

    The degenerate-row and band-outlier fallbacks reuse the host paths
    verbatim; live reads run the fill + traceback (:func:`cs_core_auto`,
    kernel B4 on the card) in tiles of ``tile`` reads, as
    :func:`_tile_inputs` lays them out: the JAX package's tiling.
    """
    device = resolve_device(device)
    B = len(queries)
    if B == 0:
        return []
    qs = [np.asarray(q, dtype=np.int16) for q in queries]
    rs = [np.asarray(r, dtype=np.int16) for r in refs]
    ns = np.array([len(q) for q in qs], np.int32)
    ms = np.array([len(r) for r in rs], np.int32)
    out: list[str | None] = [None] * B
    halves_all = np.maximum(band // 2, np.abs(ns - ms) + 8)
    w_cap = 2 * max(band // 2, 128) + 1
    live = []
    for b in range(B):
        if ns[b] == 0:
            out[b] = f"-{''.join(_BASE[c] for c in rs[b])}" if ms[b] else ""
        elif ms[b] == 0:
            out[b] = f"+{''.join(_BASE[c] for c in qs[b])}"
        elif 2 * halves_all[b] + 1 > w_cap:
            out[b] = banded_cs(qs[b], rs[b], band=band)  # band outlier
        else:
            live.append(b)

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    for s in range(0, len(live), tile):
        part = live[s : s + tile]
        *arrays, w_pad = _tile_inputs(qs, rs, part, halves_all)
        kind, qb, rb = (x.cpu().numpy() for x in cs_core_auto(
            *(up(a) for a in arrays), w_pad=w_pad))
        for k, b in enumerate(part):
            out[b] = _cs_from_oplog(kind[:, k], qb[:, k], rb[:, k])
    return [s_ if s_ is not None else "" for s_ in out]


def profile_store(store, panel, sample_size: int = 1000, seed: int = 0,
                  chunk: int = 1024, device: str | torch.device | None = None):
    """cs-tag counters over a read-store sample, on ``device`` (the card
    when None).

    Returns (tag_counter, tag->region counter, tag->blast_id counter), the
    triple the reference builds from its BAM. The sample is uniform over
    all survivors (``np.random.default_rng(seed).choice``), processed in
    length-sorted chunks; reads are profiled in their aligned orientation
    against the reference span the fused pass recorded. Rows of the SW
    fast path carry synthesized spans and a NaN blast id, which the blast
    histogram leaves out. On CUDA the chunks take the device path, on the
    CPU the numpy fill (the JAX package's split between accelerator and
    host backends).
    """
    device = resolve_device(device)
    handles = [
        (bi, r) for bi, blk in enumerate(store.blocks) for r in range(blk.num_reads)
    ]
    rng = np.random.default_rng(seed)
    if len(handles) > sample_size:
        pick = rng.choice(len(handles), size=sample_size, replace=False)
        handles = [handles[int(i)] for i in np.sort(pick)]
    handles.sort(key=lambda h: int(store.blocks[h[0]].lens[h[1]]))

    tag_counter: Counter = Counter()
    tag_region: dict[str, Counter] = defaultdict(Counter)
    tag_blast: dict[str, Counter] = defaultdict(Counter)
    for s in range(0, len(handles), chunk):
        # liveness: one heartbeat per profiled chunk (this runs on the
        # overlapped worker under its own watchdog guard)
        watchdog.heartbeat("qc.error_profile_chunk")
        part = handles[s : s + chunk]
        queries, ref_spans = [], []
        for bi, r in part:
            blk = store.blocks[bi]
            ln = int(blk.lens[r])
            qcodes = blk.codes[r, :ln]
            if blk.is_rev[r]:
                qcodes = encode.revcomp_codes(qcodes)
            queries.append(qcodes)
            ridx = int(blk.region_idx[r])
            rs, re = int(blk.ref_start[r]), int(blk.ref_end[r])
            ref_spans.append(panel.codes[ridx, rs:re])
        if device.type == "cuda":
            tags = banded_cs_batch_device(queries, ref_spans, device=device)
        else:
            tags = banded_cs_batch(queries, ref_spans)
        for (bi, r), tag in zip(part, tags):
            blk = store.blocks[bi]
            ridx = int(blk.region_idx[r])
            tag_counter[tag] += 1
            tag_region[tag][panel.names[ridx]] += 1
            b = float(blk.blast_id[r])
            if not np.isnan(b):
                tag_blast[tag][round(b, 6)] += 1
    return tag_counter, tag_region, tag_blast


def write_error_profile_log(
    tag_counter: Counter, tag_region: dict, tag_blast: dict, log_path: str,
    top_n: int = 40,
) -> None:
    """The reference pipeline's error-profile log sections."""
    top = tag_counter.most_common(top_n)
    with open(log_path, "w") as fh:
        fh.write(f"\nTop {top_n} most common cs tags:\n")
        for tup in top:
            fh.write(str(tup) + "\n")
        fh.write(
            f"\nTop 4 most common regions counted for each of the top {top_n} "
            "most common cs tags:\n"
        )
        for tag, _ in top:
            fh.write(f"{tag} {tag_region[tag].most_common(4)}\n")
        fh.write(
            f"\nTop 4 most common blast identities counted for each of the top {top_n} "
            "most common cs tags:\n"
        )
        for tag, _ in top:
            fh.write(f"{tag} {tag_blast[tag].most_common(4)}\n")
