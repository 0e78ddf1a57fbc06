"""Kernel B3 (the polish traceback, ``csrc/pileup_traceback.cu``): a scalar
walk written the way the kernel walks a lane (its row filled first, the
cells read from chunks of rows staged into a double buffer, the columns
written through a chunk's slots, the insertion run counted in a register)
against the JAX package's scan-log ``_traceback_batch`` and the port's plain
``_traceback_steps``, on planes from the forward and on seeded random
direction fields; a chunk staged one row short caught; the wrapper's CPU
refusal and the CPU dispatch; and, on a card, the kernel against the plain
steps. Tolerance: exact."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ont_tcrconsensus_tpu_torch.io.dp_cases import noisy_copy, pack, random_planes  # noqa: E402

try:  # the JAX reference; a card machine without JAX runs the gpu case only
    from ont_tcrconsensus_tpu.ops import pileup as jpileup
except ImportError:
    jpileup = None
from ont_tcrconsensus_tpu_torch.ops import pileup, pileup_kernel, traceback_kernel  # noqa: E402
from ont_tcrconsensus_tpu_torch.parallel.mesh import lockstep  # noqa: E402

COLUMNS = ("base_at", "ins_cnt", "ins_base", "pos_at", "spans")
LANE_KINDS = ("noisy", "long_del", "long_ins", "n_bases", "dead", "unrelated")


def _lanes(seed: int, n: int, L: int):
    """``n`` (read, draft) lanes of width ``L``, cycling over LANE_KINDS:
    noisy copies, a 9-14 base run deleted from the read (a ref-gap jump
    of more than one), 8-12 bases inserted (an E run), N bases (code 4),
    empty reads (lanes that start done) and unrelated reads. Drafts are
    shorter than ``L``."""
    rng = np.random.default_rng(seed)
    reads, drafts = [], []
    for k in range(n):
        kind = LANE_KINDS[k % len(LANE_KINDS)]
        tpl = rng.integers(0, 4, int(rng.integers(L // 3, L - 48))).astype(np.uint8)
        drafts.append(noisy_copy(rng, tpl, 0.03))
        read = noisy_copy(rng, tpl, 0.06)
        cut = int(rng.integers(len(read) // 4, len(read) // 2))
        if kind == "long_del":
            read = np.concatenate([read[:cut], read[cut + int(rng.integers(9, 15)):]])
        elif kind == "long_ins":
            run = rng.integers(0, 4, int(rng.integers(8, 13))).astype(np.uint8)
            read = np.concatenate([read[:cut], run, read[cut:]])
        elif kind == "n_bases":
            read = read.copy()
            read[rng.random(len(read)) < 0.05] = 4
        elif kind == "dead":
            read = read[:0]
        elif kind == "unrelated":
            read = rng.integers(0, 4, len(read)).astype(np.uint8)
        reads.append(read[:L])
    r, rl = pack(reads, L)
    d, dl = pack(drafts, L)
    return r, rl, d, dl


K_ROWS = 32  # csrc/pileup_traceback.cu kRows: plane rows a staged chunk
POISON = 0xAB  # what an output row holds before the warp's first write


def _kernel_walk(best, planes, reads, W: int, out_len: int, chunk_rows: int = K_ROWS,
                 stats: Counter | None = None, offs=None, jrow_offset: bool = True):
    """Kernel B3's walk, lane by lane in plain Python, in its order: the
    warp writes its lane's whole row with the fill values; the walk reads
    each cell from a double buffer of staged chunks (rows [hi - K_ROWS + 1,
    hi], the next chunk staged as the walk enters the current one, a slot's
    old rows kept until a chunk overwrites them), keeps the scan's seven
    scalars of state and writes each step's columns to the chunk's column
    slots (j0 - j), the insertion run counted in a register; as it leaves a
    chunk the slots go out to the row and back to the fill values, the open
    column's run carried. ``chunk_rows`` is how many rows a chunk stages
    (K_ROWS in the kernel; one fewer is a mutation). ``stats`` counts the
    chunks each walk entered, the slots it stood in and the deletion
    runs. ``offs`` are the lanes' band centres (None: 0); with
    ``jrow_offset`` False the step's column leaves the offset out (a
    mutation: the chunk's first column keeps it)."""
    N, L = reads.shape
    c = W // 2
    cols = K_ROWS + W + 1
    base_at = np.full((N, out_len), POISON, np.uint8)
    ins_cnt = np.full((N, out_len), -POISON, np.int32)
    ins_base = np.full((N, out_len), POISON, np.uint8)
    pos_at = np.full((N, out_len), -POISON, np.int32)
    spans = np.zeros((N, 4), np.int32)
    stats = Counter() if stats is None else stats
    fill = (pileup.UNCOVERED, 0, 0, -1)
    for n in range(N):
        base_at[n], ins_cnt[n], ins_base[n], pos_at[n] = fill
        slots = [np.array([v] * (cols + 1)) for v in fill]  # base, icnt, ibase, pos
        score, i0, b0 = (int(x) for x in best[n])
        off = 0 if offs is None else int(offs[n])
        jend = i0 + off - c + b0
        i, b, mode, pending = i0, b0, 0, 0
        done = score <= 0 or i0 < 0 or L <= 0
        rstart, fstart = i0 + 1, jend + 1
        ins_j, ins_n, ins_b = -1, 0, 0
        ring = np.full((2, K_ROWS, W), 0xFFFF, np.int64)  # never-staged cells
        ring_read = np.full((2, K_ROWS), 5, np.int64)

        def stage(slot, lo, hi):
            first = max(lo, 0)
            last = min(hi, first + chunk_rows - 1)
            for r in range(first, last + 1):
                ring[slot, r - first] = planes[n, r]
                ring_read[slot, r - first] = reads[n, r]

        t, T = 0, L + out_len
        if not done:
            hi = min(i0, L - 1)
            lo = hi - K_ROWS + 1
            j0 = jend
            stage(0, lo, hi)
            k = 0
            while not done and t < T:
                buf = k & 1
                stage(buf ^ 1, lo - K_ROWS, hi - K_ROWS)
                base = max(lo, 0)
                stats["chunks"] += 1
                del_run = 0
                while t < T and not done:
                    ci = min(max(i, 0), L - 1)
                    if ci < lo:
                        break
                    jrow = i + (off if jrow_offset else 0) - c + b
                    cb = min(max(b, 0), W - 1)
                    p = int(ring[buf, ci - base, cb])
                    d, m = p & 15, p >> 4
                    in_del = pending > 0
                    start_del = not in_del and mode == 0 and m > 0
                    do_del = in_del or start_del
                    new_pending = pending - 1 if in_del else (m - 1 if start_del else 0)
                    choice = pileup._EGAP if mode == 1 else d & 3
                    is_diag = not do_del and choice == pileup._DIAG
                    is_egap = not do_del and choice == pileup._EGAP
                    is_fresh = not do_del and choice == pileup._FRESH
                    slot = min(j0 - jrow, cols)
                    stats["max_slot"] = max(stats["max_slot"], slot)
                    rb = int(ring_read[buf, ci - base])
                    known = rb < 4
                    if do_del or (is_diag and known):
                        slots[0][slot] = pileup.DELETION if do_del else rb
                    if is_diag and known:
                        slots[3][slot] = ci
                    if is_egap and known:
                        ins_n = ins_n + 1 if jrow == ins_j else 1
                        ins_j, ins_b = jrow, rb
                        slots[1][slot], slots[2][slot] = ins_n, rb
                    del_run = del_run + 1 if do_del else 0
                    stats["longest_deletion_run"] = max(stats["longest_deletion_run"], del_run)
                    stats["b0_reached"] += b == 0
                    stats["bW_reached"] += b == W - 1
                    e_open = bool(d & pileup._EOPEN_BIT)
                    diag_stop = is_diag and bool(d & pileup._DIAG_STOP_BIT)
                    ni = i - 1 if (is_diag or is_egap) else i
                    nb = b - 1 if do_del else (b + 1 if is_egap else b)
                    if is_diag or is_egap:
                        rstart = i
                    if is_diag or do_del:
                        fstart = jrow
                    mode = 2 if do_del else (1 if is_egap and not e_open else 0)
                    pending = new_pending
                    done = is_fresh or diag_stop or ni < 0 or nb < 0 or nb >= W
                    i, b = ni, nb
                    t += 1
                jc = i + off - c + b
                for s_ in range(min(j0 - jc, cols - 1) + 1):
                    col = j0 - s_
                    if 0 <= col < out_len:
                        base_at[n, col], ins_cnt[n, col] = slots[0][s_], slots[1][s_]
                        ins_base[n, col], pos_at[n, col] = slots[2][s_], slots[3][s_]
                    for arr, v in zip(slots, fill):
                        arr[s_] = v
                if ins_j == jc:
                    slots[1][0], slots[2][0] = ins_n, ins_b
                j0 = jc
                hi, lo, k = hi - K_ROWS, lo - K_ROWS, k + 1
            stats["most_chunks"] = max(stats["most_chunks"], k)
        spans[n] = (rstart, i0 + 1, fstart, jend + 1)
    return base_at, ins_cnt, ins_base, pos_at, spans


@pytest.mark.parametrize("out_frac", (1.0, 0.75))
@pytest.mark.parametrize("W", (64, 128))
def test_kernel_walk_matches_jax_and_plain_steps(W, out_frac):
    L = 256
    out_len = int(L * out_frac)
    reads, rl, drafts, dl = _lanes(7 + W, n=48, L=L)
    args = tuple(torch.from_numpy(x) for x in (reads, rl, drafts, dl))
    best, planes = pileup._forward_batch(*args, band_width=W)
    planes_u16 = planes.numpy().astype(np.uint16)
    # the cases reach what they are there for
    assert (planes_u16 >> 4 > 1).any(), "no ref-gap jump of more than one"
    assert (best[:, 0] <= 0).any() and (best[:, 0] > 0).sum() >= 30
    assert (reads == 4).any() and (dl < out_len).any()

    got = _kernel_walk(best.numpy(), planes_u16, reads, W, out_len)
    plain = pileup._traceback_batch(best, planes, args[0], W, out_len)
    jbest, jplanes = jpileup._forward_batch(reads, rl, drafts, dl, band_width=W)
    want = jpileup._traceback_batch(jbest, jplanes, reads, W, out_len)
    for name, g, p, w in zip(COLUMNS, got, plain, want):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w), err_msg=f"plain {name}")
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"walk {name}")
    assert (got[1] > 0).any(), "no insertion column"
    assert (got[0] == pileup.DELETION).any(), "no deletion column"


def _columns_of_all_three(best, planes, reads, W: int, out_len: int, **model):
    """The model's columns, the plain steps' and JAX's, as numpy."""
    got = _kernel_walk(best, planes.astype(np.uint16), reads, W, out_len, **model)
    plain = pileup._traceback_batch(torch.from_numpy(best), torch.from_numpy(planes),
                                    torch.from_numpy(reads), W, out_len)
    want = jpileup._traceback_batch(best, planes.astype(np.uint16), reads, W, out_len)
    return got, [x.numpy() for x in plain], [np.asarray(x) for x in want]


@pytest.mark.parametrize("out_frac", (1.0, 0.75))
@pytest.mark.parametrize("W", (64, 128))
def test_kernel_walk_on_random_planes_matches_jax_and_plain_steps(W, out_frac):
    """Seeded random direction fields (``dp_cases.random_planes``): walks
    that cross many staged chunks, deletion runs up to 40 columns, walks
    that stand at slot 0 and slot W - 1, N bases, dead lanes."""
    L = 256
    out_len = int(L * out_frac)
    best, planes, reads = random_planes(31 + W, 36, L, W)
    stats = Counter()
    got, plain, want = _columns_of_all_three(best, planes, reads, W, out_len, stats=stats)
    for name, g, p, w in zip(COLUMNS, got, plain, want):
        np.testing.assert_array_equal(p, w, err_msg=f"plain {name}")
        np.testing.assert_array_equal(g, w, err_msg=f"walk {name}")
    assert stats["most_chunks"] >= 5, "no walk crossed four chunk edges"
    assert stats["longest_deletion_run"] >= 20
    assert stats["b0_reached"] and stats["bW_reached"], "no walk stood at slot 0 and W - 1"
    assert stats["max_slot"] >= 40, "no chunk moved the column down 40 times"
    assert (got[1] > 1).any() and (got[0] == pileup.DELETION).any()


@pytest.mark.parametrize("case", ("lanes", "random_planes"))
def test_a_chunk_staged_one_row_short_changes_the_columns(case):
    """Mutation: each chunk staged one row short (its top row stays what
    the buffer held two chunks before) gives other columns than JAX's on
    the B2 planes of ``_lanes`` and on random planes, so the parity tests
    above would catch it."""
    W, L = 64, 256
    if case == "lanes":
        reads, rl, drafts, dl = _lanes(7 + W, n=48, L=L)
        best, planes = (x.numpy() for x in pileup._forward_batch(
            *(torch.from_numpy(x) for x in (reads, rl, drafts, dl)), band_width=W))
    else:
        best, planes, reads = random_planes(31 + W, 36, L, W)
    got, _, want = _columns_of_all_three(best, planes, reads, W, L, chunk_rows=K_ROWS - 1)
    assert any(not np.array_equal(g, w) for g, w in zip(got, want))


def test_wrapper_refuses_cpu_tensors():
    reads, rl, drafts, dl = _lanes(3, n=4, L=128)
    best, planes = pileup._forward_batch(
        *(torch.from_numpy(x) for x in (reads, rl, drafts, dl)), band_width=64)
    with pytest.raises(ValueError, match="CUDA"):
        traceback_kernel.traceback_columns_cuda(best, planes, torch.from_numpy(reads), 64, 128)


def test_columns_on_cpu_take_the_plain_traceback():
    """On CPU tensors ``pileup_columns_batch_auto`` runs the plain forward
    and the plain steps: no kernel counter moves, and the columns equal
    ``_traceback_steps`` run to its end."""
    reads, rl, drafts, dl = _lanes(5, n=12, L=128)
    sub, sl = torch.from_numpy(reads).reshape(3, 4, 128), torch.from_numpy(rl).reshape(3, 4)
    dr, drl = torch.from_numpy(drafts[::4].copy()), torch.from_numpy(dl[::4].copy())
    before = (pileup_kernel.forward_planes_cuda.launches,
              traceback_kernel.traceback_columns_cuda.launches)
    got = pileup.pileup_columns_batch_auto(sub, sl, dr, drl, band_width=64)
    assert (pileup_kernel.forward_planes_cuda.launches,
            traceback_kernel.traceback_columns_cuda.launches) == before
    flat = sub.reshape(12, 128)
    best, planes = pileup._forward_batch(flat, sl.reshape(12), dr.repeat_interleave(4, dim=0),
                                         drl.repeat_interleave(4), band_width=64)
    want = lockstep([pileup._traceback_steps(best, planes, flat, 64, 128)])[0]
    for name, g, w in zip(COLUMNS, got, want):
        assert torch.equal(g.reshape(w.shape), w), name


@pytest.mark.gpu
@pytest.mark.parametrize("W", (64, 128))
def test_kernel_matches_plain_steps_on_card(W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B3 has no CPU mode")
    dev = torch.device("cuda")
    reads, rl, drafts, dl = (torch.from_numpy(x).to(dev) for x in _lanes(11, n=64, L=256))
    best, planes = pileup_kernel.forward_planes_cuda(reads, rl, drafts, dl, band_width=W)
    for out_len in (256, 192):
        before = traceback_kernel.traceback_columns_cuda.launches
        got = traceback_kernel.traceback_columns_cuda(best, planes, reads, W, out_len)
        assert traceback_kernel.traceback_columns_cuda.launches == before + 1
        want = lockstep([pileup._traceback_steps(best, planes, reads, W, out_len)])[0]
        for name, g, w in zip(COLUMNS, got, want):
            assert torch.equal(g, w), name
