"""Kernel B6, the UMI dovetail edit distance (``csrc/dovetail.cu``): a
fixed count of bit-parallel word steps, ceil(a length / 64) words over b's
columns of each pair (a row and b row i, or the query and target of a
Q x T grid), at 20 int32 operations a word step, plus the corner's terms:
5 a column of the top row past the overhang, 4 a row of the left column;
against the bytes of each sequence within its length, the lengths and
one distance a pair."""

from tcrbench.roofline._peaks import WORD_STEP_OPS, bound_s, words  # noqa: F401

ENTRY = ("ont_tcrconsensus_tpu_torch.ops.dovetail_kernel", "dovetail_cuda")
KERNEL = "dovetail_kernel"


def count(args, kwargs, out):
    a, a_lens, b, b_lens, n_pairs, T, k_end = args[:7]
    dev = a.device
    al = a_lens.to(dev).long()
    bl = b_lens.to(dev).long()
    rows_seq, cols_seq = al.clamp(0, a.shape[1]), bl.clamp(0, b.shape[1])
    if T:
        rows, cols = rows_seq[:, None], cols_seq[None, :]
        a_len, b_len = al[:, None], bl[None, :]
    else:
        rows, cols, a_len, b_len = rows_seq, cols_seq, al, bl
    steps = (words(rows) * cols).sum()
    grid = rows * cols
    top = (cols - cols.minimum((b_len - k_end).clamp(min=0))).expand_as(grid)
    left = (rows - rows.minimum((a_len - k_end).clamp(min=0))).expand_as(grid)
    ops = steps * WORD_STEP_OPS + top.sum() * 5 + left.sum() * 4
    nbytes = rows_seq.sum() + cols_seq.sum() + 4 * (len(al) + len(bl)) + 4 * n_pairs
    return ops, nbytes
