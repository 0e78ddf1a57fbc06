"""Kernel B5, IUPAC infix edit distance (``csrc/fuzzy_match.cu``): a fixed
count of bit-parallel word steps, ceil(pattern length / 64) words over
each window's columns (the search) and over the prefix up to the match's
end (the start), at 20 int32 operations a word step, plus a column's
score terms (4) and the search's first-minimum (3) or the start's
last-equal (2) test; against the bytes of each pattern and window within
its length, the lengths and the three outputs."""

from tcrbench.roofline._peaks import WORD_STEP_OPS, bound_s, words  # noqa: F401

ENTRY = ("ont_tcrconsensus_tpu_torch.ops.fuzzy_kernel", "fuzzy_find_multi_cuda")
KERNEL = "fuzzy_match_kernel"


def count(args, kwargs, out):
    pmasks, plens, windows, wlens = args[:4]
    P, m = pmasks.shape
    B, Lw = windows.shape
    rows = plens.to(windows.device).clamp(0, m).long()[:, None]
    cols1 = wlens.to(windows.device).clamp(0, Lw).long()[None, :]
    cols2 = out[2].long()
    steps = (words(rows) * cols1).sum() + (words(rows) * cols2).sum()
    ops = steps * WORD_STEP_OPS + cols1.sum() * P * (4 + 3) + cols2.sum() * (4 + 2)
    nbytes = rows.sum() + 4 * P + cols1.sum() + 4 * B + 3 * 4 * P * B
    return ops, nbytes
