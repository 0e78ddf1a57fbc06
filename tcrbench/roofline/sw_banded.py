"""Kernel B1, banded Smith-Waterman (``csrc/sw_banded.cu``): the band
cells of each read's own rows times the int32 operations a cell's Gotoh
recurrence needs (68: cell index, validity, match and substitution 9; E
over four channels 9; the diagonal 9; tmp 14; F's max-plus 9 and open 3;
H 7; E's mask 1; the best cell 7), against the bytes of each read within
its length, each reference row, the lengths and offsets and the 7-field
result."""

from tcrbench.roofline._peaks import bound_s  # noqa: F401

ENTRY = ("ont_tcrconsensus_tpu_torch.ops.sw_kernel", "align_banded_cuda")
KERNEL = "sw_banded_kernel"
CELL_OPS = 68


def count(args, kwargs, out):
    reads, read_lens, refs = args[0], args[1], args[2]
    W = kwargs.get("band_width", args[5] if len(args) > 5 else 256)
    B, L = reads.shape
    rows = read_lens.to(reads.device).clamp(0, L).sum()
    return rows * W * CELL_OPS, rows + B * refs.shape[1] + 3 * 4 * B + 7 * 4 * B
