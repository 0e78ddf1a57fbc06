"""Banded alignment with traceback -> per-column pileups.

The counterpart of the JAX package's ``ops/pileup.py`` production path:
a banded forward DP stores one packed direction plane per band cell, then
a scan-log traceback walks the planes from each lane's best cell and the
pileup columns materialize in one vectorized pass. Each lane's band is
centred on its diagonal offset (``offs``, None for 0 everywhere: the
polish path's same-molecule subreads): cell (i, b) lies over draft column
``i + off - W/2 + b``.

Packed plane per cell (u16): ``tdir | fjump << 4``.
- ``tdir``: bits 0-1 = tmp choice (0 diag, 1 read-gap/E, 3 fresh/stop);
  bit 2 = diag predecessor was a fresh start (emit, then stop);
  bit 3 = the E value here OPENED from H (vs extended from the E above).
- ``fjump``: 0 if H == tmp at this cell, else the ref-gap run length m
  (H chose F; predecessor is tmp at band slot b - m in the same row).

:func:`_forward_batch` is the plain PyTorch twin of kernel B2
(``csrc/pileup_forward.cu``) and :func:`_traceback_steps` that of kernel B3
(``csrc/pileup_traceback.cu``); :func:`forward_auto` and
:func:`traceback_auto` pick by device.
"""

from __future__ import annotations

import torch

from ont_tcrconsensus_tpu_torch.ops import pileup_kernel, traceback_kernel
from ont_tcrconsensus_tpu_torch.parallel import mesh as mesh_mod
from ont_tcrconsensus_tpu_torch.ops.sw_align import (
    GAP_EXT,
    GAP_OPEN,
    MATCH,
    MISMATCH,
    NEG,
    _ref_windows,
    shift_right,
    shift_up,
)

UNCOVERED = 5
DELETION = 4

_DIAG, _EGAP, _FRESH = 0, 1, 3
_DIAG_STOP_BIT = 0b100
_EOPEN_BIT = 0b1000

# traceback walks are checked for completion this often (steps)
_DONE_CHECK = 256


def _forward_batch(reads, read_lens, refs, ref_lens, band_width: int,
                   match: int = MATCH, mismatch: int = MISMATCH,
                   gap_open: int = GAP_OPEN, gap_ext: int = GAP_EXT, offs=None):
    """Plain banded forward over flat lanes, each centred on its offset
    (``offs`` (N,) int32; None: 0 for every lane). The reference window
    reads PAD outside ``refs``' width, as the JAX package's ``ref_shifted``.

    Returns (best (N, 3) int32 ``(score, row, slot)`` — ``(0, -1, 0)`` when
    nothing scores above 0 —, planes (N, L, W) int16 holding the u16
    ``tdir | fjump << 4``). Every row of the padded width is computed: the
    planes of rows past a read's length are part of the output.
    """
    N, L = reads.shape
    W = band_width
    c = W // 2
    dev = reads.device
    i32 = torch.int32
    iota = torch.arange(W, device=dev, dtype=i32)[None, :]
    rlen = read_lens.to(i32)[:, None]
    tlen = ref_lens.to(i32)[:, None]
    reads_i = reads.to(i32)
    off = (torch.zeros(N, dtype=i32, device=dev) if offs is None
           else offs.to(device=dev, dtype=i32))
    win = _ref_windows(refs, off, L, W)
    off = off[:, None]

    H = torch.full((N, W), NEG, dtype=i32, device=dev)
    E = H.clone()
    best = torch.tensor([0, -1, 0], dtype=i32, device=dev).repeat(N, 1)
    planes = torch.empty((N, L, W), dtype=torch.int16, device=dev)
    rows = torch.arange(N, device=dev)
    for i in range(L):
        jrow = i + off - c + iota
        valid = (jrow >= 0) & (jrow < tlen) & (i < rlen)
        rbase = reads_i[:, i : i + 1]
        tbase = win[:, i : i + W]
        is_match = (tbase == rbase) & (rbase < 4) & (tbase < 4)
        sub = torch.where(is_match, match, -mismatch).to(i32)

        open_sc = shift_up(H, NEG) - gap_open - gap_ext
        ext_sc = shift_up(E, NEG) - gap_ext
        e_open = open_sc >= ext_sc
        E_new = torch.where(e_open, open_sc, ext_sc)

        fresh_pred = H < 0
        D = torch.where(fresh_pred, 0, H) + sub
        tdir = torch.where(fresh_pred, _DIAG | _DIAG_STOP_BIT, _DIAG)
        e_better = E_new > D
        tmp = torch.where(e_better, E_new, D)
        tdir = torch.where(e_better, _EGAP, tdir)
        fresh_better = tmp < 0
        tmp = torch.where(fresh_better, 0, tmp)
        tdir = torch.where(fresh_better, _FRESH, tdir)
        tmp = torch.where(valid, tmp, NEG)
        tdir = tdir | torch.where(e_open, _EOPEN_BIT, 0)

        # F via shift-doubling (sw_align._f_cascade), tracking the gap run
        g = tmp
        gap = torch.zeros_like(tmp)
        step = 1
        while step < W:
            cand_g = shift_right(g, step, NEG) - gap_ext * step
            take = cand_g > g
            g = torch.where(take, cand_g, g)
            gap = torch.where(take, shift_right(gap, step, 0) + step, gap)
            step *= 2
        F = shift_right(g, 1, NEG) - gap_open - gap_ext
        jump = (shift_right(gap, 1, 0) + 1) & 0xFF

        take_f = F > tmp
        H = torch.where(valid, torch.where(take_f, F, tmp), NEG)
        fjump = torch.where(take_f, jump, 0)
        planes[:, i] = (tdir | (fjump << 4)).to(torch.int16)

        b_star = torch.argmax(H, dim=1)
        row_best = H[rows, b_star]
        improve = row_best > best[:, 0]
        cand = torch.stack(
            [row_best, torch.full_like(row_best, i), b_star.to(i32)], dim=1
        )
        best = torch.where(improve[:, None], cand, best)
        E = torch.where(valid, E_new, NEG)
    return best, planes


def forward_auto(reads, read_lens, refs, ref_lens, band_width: int, offs=None):
    """The plain forward for CPU tensors, kernel B2 for CUDA tensors."""
    if reads.device.type == "cpu":
        return _forward_batch(reads, read_lens, refs, ref_lens, band_width, offs=offs)
    return pileup_kernel.forward_planes_cuda(reads, read_lens, refs, ref_lens, band_width,
                                             offs=offs)


def traceback_auto(best, planes, reads, band_width: int, out_len: int, offs=None):
    """The traceback as a generator for :func:`..parallel.mesh.lockstep`:
    the plain :func:`_traceback_steps` for CPU tensors; for CUDA tensors
    kernel B3, launched once, then one yield, so that every slice launches
    before any slice waits. Returns the columns."""
    if reads.device.type == "cpu":
        return (yield from _traceback_steps(best, planes, reads, band_width, out_len, offs))
    cols = traceback_kernel.traceback_columns_cuda(best, planes, reads, band_width, out_len,
                                                   offs=offs)
    yield
    return cols


def _traceback_batch(best, planes, reads, band_width: int, out_len: int, offs=None):
    """Traceback over flat lanes: :func:`traceback_auto` run to its end."""
    return mesh_mod.lockstep([traceback_auto(best, planes, reads, band_width, out_len,
                                             offs)])[0]


def _traceback_steps(best, planes, reads, band_width: int, out_len: int, offs=None):
    """Scan-log traceback over flat lanes, each centred on its offset
    (``offs`` as in :func:`_forward_batch`), the plain version of kernel B3
    on any device: a generator that yields after each step's launches and
    returns the columns.

    Each step gathers ONE packed plane cell per lane, keeps 7 scalars of
    per-lane state and logs the move (op, read index, draft column); the
    walk stops once every lane is done (dead lanes emit nothing). The
    columns then materialize vectorized:

    - ``base_at``: one set per logged (lane, j) — indices are unique (a
      draft column is consumed at most once per walk);
    - ``ins_cnt``: scatter-add of the logged insertion steps;
    - ``ins_base``: the FIRST base of each insertion run = the run's latest
      traceback step, a scatter-max of ``t * 4 + base``.

    Dropped entries land in an extra column ``out_len`` that is sliced off
    (the JAX version's ``mode="drop"``). Steps past a lane's end emit
    nothing, so how late the walk stops never changes the columns.
    """
    N, L = reads.shape
    W = band_width
    c = W // 2
    dev = reads.device
    i32 = torch.int32
    T = L + out_len
    score, i0, b0 = best[:, 0], best[:, 1], best[:, 2]
    off = 0 if offs is None else offs.to(device=dev, dtype=i32)
    jend = i0 + off - c + b0
    MODE_H, MODE_E, MODE_TMP = 0, 1, 2
    OP_DEL, OP_DIAG, OP_INS = 1, 2, 3
    planes_flat = planes.reshape(N, L * W)

    i, b = i0.clone(), b0.clone()
    mode = torch.full((N,), MODE_H, dtype=i32, device=dev)
    pending = torch.zeros((N,), dtype=i32, device=dev)
    done = (score <= 0) | (i0 < 0)
    rstart, fstart = i0 + 1, jend + 1
    ops, idx_i, idx_j = [], [], []
    for t in range(T):
        if t % _DONE_CHECK == 0 and bool(done.all()):
            break
        live = ~done
        jrow = i + off - c + b
        jc = jrow.clamp(0, out_len - 1)
        j_ok = (jrow >= 0) & (jrow < out_len) & live
        ci = i.clamp(0, L - 1)
        cb = b.clamp(0, W - 1)
        p = planes_flat.gather(1, (ci * W + cb).long()[:, None])[:, 0].to(i32)
        d = p & 15
        m = p >> 4

        in_del = pending > 0
        start_del = ~in_del & (mode == MODE_H) & (m > 0)
        do_del = in_del | start_del
        new_pending = torch.where(in_del, pending - 1, torch.where(start_del, m - 1, 0))

        choice = torch.where(mode == MODE_E, _EGAP, d & 3)
        is_diag = ~do_del & (choice == _DIAG)
        is_egap = ~do_del & (choice == _EGAP)
        is_fresh = ~do_del & (choice == _FRESH)

        op = torch.where(
            do_del & j_ok, OP_DEL,
            torch.where(is_diag & j_ok, OP_DIAG, torch.where(is_egap & j_ok, OP_INS, 0)),
        )
        ops.append(op.to(torch.int8))
        idx_i.append(ci)
        idx_j.append(jc)

        e_open = (d & _EOPEN_BIT) != 0
        diag_stop = is_diag & ((d & _DIAG_STOP_BIT) != 0)
        ni = torch.where(is_diag | is_egap, i - 1, i)
        nb = torch.where(do_del, b - 1, torch.where(is_egap, b + 1, b))
        nmode = torch.where(
            do_del, MODE_TMP, torch.where(is_egap & ~e_open, MODE_E, MODE_H)
        ).to(i32)
        ndone = done | is_fresh | diag_stop | (ni < 0) | (nb < 0) | (nb >= W)
        rstart = torch.where(live & (is_diag | is_egap), i, rstart)
        fstart = torch.where(live & (is_diag | do_del), jrow, fstart)
        i = torch.where(live, ni, i)
        b = torch.where(live, nb, b)
        mode = torch.where(live, nmode, mode)
        pending = torch.where(live, new_pending, pending)
        done = ndone
        yield

    base_at = torch.full((N, out_len + 1), UNCOVERED, dtype=torch.uint8, device=dev)
    pos_at = torch.full((N, out_len + 1), -1, dtype=i32, device=dev)
    ins_cnt = torch.zeros((N, out_len + 1), dtype=i32, device=dev)
    pk = torch.full((N, out_len + 1), -1, dtype=i32, device=dev)
    if ops:
        op_t = torch.stack(ops, dim=1).to(i32)          # (N, T')
        i_t = torch.stack(idx_i, dim=1)
        jc_t = torch.stack(idx_j, dim=1)
        rb_t = reads.to(i32).gather(1, i_t.long())
        rb_known = rb_t < 4
        set_hit = (op_t == OP_DEL) | ((op_t == OP_DIAG) & rb_known)
        set_j = torch.where(set_hit, jc_t, out_len).long()
        set_v = torch.where(op_t == OP_DEL, DELETION, rb_t).to(torch.uint8)
        diag_hit = (op_t == OP_DIAG) & rb_known
        diag_j = torch.where(diag_hit, jc_t, out_len).long()
        ins_hit = (op_t == OP_INS) & rb_known
        ins_j = torch.where(ins_hit, jc_t, out_len).long()
        ts = torch.arange(op_t.shape[1], device=dev, dtype=i32)[None, :]
        ins_pk = ts * 4 + (rb_t & 3)
        base_at.scatter_(1, set_j, set_v)
        pos_at.scatter_(1, diag_j, i_t)
        ins_cnt.scatter_add_(1, ins_j, torch.ones_like(ins_j, dtype=i32))
        pk.scatter_reduce_(1, ins_j, ins_pk, reduce="amax")
    base_at, pos_at, ins_cnt, pk = (x[:, :out_len] for x in (base_at, pos_at, ins_cnt, pk))
    ins_base = torch.where(pk >= 0, pk % 4, 0).to(torch.uint8)
    spans = torch.stack([rstart, i0 + 1, fstart, jend + 1], dim=1)
    return base_at, ins_cnt, ins_base, pos_at, spans


def _forward_traceback(reads, rlens, refs, reflens, band_width: int, out_len: int,
                       offs=None):
    """One slice's pileup program, a generator for :func:`..parallel.mesh.lockstep`:
    the forward (kernel B2 on the card), a yield so every slice launches
    its forward before any slice waits, then the traceback (kernel B3 on
    the card, the plain steps on the CPU)."""
    best, planes = forward_auto(reads, rlens, refs, reflens, band_width, offs)
    yield
    return (yield from traceback_auto(best, planes, reads, band_width, out_len, offs))


def pileup_columns_batch_auto(subreads, subread_lens, drafts, draft_lens,
                              band_width: int = 128, out_len: int | None = None,
                              mesh=None, diag_offsets=None):
    """Align each subread to its cluster's draft and emit per-position
    columns — forward (kernel B2 on the card) + traceback (kernel B3).

    Args: subreads (C, S, L) uint8 codes; subread_lens (C, S); drafts
    (C, Ld) uint8; draft_lens (C,); diag_offsets (C, S) int32 band centres,
    or None for 0 everywhere (the kernels then read no offsets). Returns
    (base_at, ins_cnt, ins_base, pos_at — each (C, S, out_len) — and spans
    (C, S, 4) int32 ``[read_start, read_end, ref_start, ref_end)``).

    ``mesh`` splits the flat lane axis (C*S) over the mesh's data slices
    when it divides the data-axis size (callers pad the cluster axis):
    every slice runs the forward and the traceback on its lanes, each
    launching in turn before any waits (on the CPU the plain traceback
    steps in turns over the slices), and the columns gather on the first
    slice's device.
    """
    if out_len is None:
        out_len = drafts.shape[-1]
    C, S, L = subreads.shape
    reads = subreads.reshape(C * S, L)
    rlens = subread_lens.reshape(C * S).to(torch.int32)
    refs = drafts.repeat_interleave(S, dim=0)
    reflens = draft_lens.to(torch.int32).repeat_interleave(S)
    offs = None if diag_offsets is None else diag_offsets.reshape(C * S).to(torch.int32)
    if mesh is not None and (C * S) % mesh_mod.mesh_data_size(mesh) == 0:
        d1, d2 = mesh_mod.P("data"), mesh_mod.P("data", None)
        cols = mesh_mod.shard_map_compat(
            lambda *a: _forward_traceback(*a[:4], band_width, out_len, a[4]), mesh,
            in_specs=(d2, d1, d2, d1, d1), out_specs=(d2, d2, d2, d2, d2),
        )(reads, rlens, refs, reflens, offs)
    else:
        cols = mesh_mod.lockstep([_forward_traceback(reads, rlens, refs, reflens,
                                                     band_width, out_len, offs)])[0]
    base_at, ins_cnt, ins_base, pos_at, spans = cols
    return (
        base_at.reshape(C, S, out_len),
        ins_cnt.reshape(C, S, out_len),
        ins_base.reshape(C, S, out_len),
        pos_at.reshape(C, S, out_len),
        spans.reshape(C, S, 4),
    )


def pileup_columns(subreads, subread_lens, draft, draft_len, diag_offsets,
                   band_width: int = 128, out_len: int | None = None, device=None):
    """One cluster's pileup: each subread aligned to ``draft`` (the JAX
    package's single-cluster ``pileup_columns``), on ``device`` (the card
    when None; kernels B2 and B3 there), through
    :func:`pileup_columns_batch_auto` at C = 1.

    Args: subreads (S, L) uint8 codes; subread_lens (S,); draft (Ld,)
    uint8; draft_len a scalar; diag_offsets (S,) band centres (0 for
    same-molecule subreads). Returns (base_at, ins_cnt, ins_base, pos_at —
    each (S, out_len) — and spans (S, 4)) on ``device``.
    """
    from ont_tcrconsensus_tpu_torch.device import resolve_device

    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    draft_t = t(draft, torch.uint8)
    if out_len is None:
        out_len = draft_t.shape[-1]
    cols = pileup_columns_batch_auto(
        t(subreads, torch.uint8)[None], t(subread_lens, torch.int32)[None], draft_t[None],
        t(draft_len, torch.int32).reshape(1), band_width=band_width, out_len=out_len,
        diag_offsets=t(diag_offsets, torch.int32)[None])
    return tuple(c[0] for c in cols)


def pileup_columns_batch(subreads, subread_lens, drafts, draft_lens, band_width: int = 128,
                         out_len: int | None = None):
    """The JAX package's ``pileup_columns_batch``: every cluster's subreads
    aligned to its draft at offset 0, on the tensors' device (kernels B2
    and B3 for CUDA tensors): :func:`pileup_columns_batch_auto` with no
    mesh. Args and returns as there."""
    return pileup_columns_batch_auto(subreads, subread_lens, drafts, draft_lens,
                                     band_width=band_width, out_len=out_len)
