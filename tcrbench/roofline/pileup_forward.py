"""Kernel B2, the pileup's banded forward (``csrc/pileup_forward.cu``):
the band cells of each read's rows and the row after its end times the
int32 operations of a cell (45: index, validity, match, substitution 10;
E 4; the diagonal 4; tmp 7; the E-opened bit 2; F 5 and its open 1; H 3;
the fjump and packed plane 5; E's mask 1; the best cell 3), the cells past
that at 9 (the fresh-start direction), against the bytes: each read and
reference row, the lengths, best cells and the (N, L, W) uint16 planes
written once."""

from tcrbench.roofline._peaks import bound_s  # noqa: F401

ENTRY = ("ont_tcrconsensus_tpu_torch.ops.pileup_kernel", "forward_planes_cuda")
KERNEL = "pileup_forward_kernel"
CELL_OPS = 45
PAD_CELL_OPS = 9


def count(args, kwargs, out):
    reads, read_lens, refs = args[0], args[1], args[2]
    W = args[4] if len(args) > 4 else kwargs["band_width"]
    offs = args[5] if len(args) > 5 else kwargs.get("offs")
    N, L = reads.shape
    dp_rows = (read_lens.to(reads.device).long() + 1).clamp(0, L).sum()
    ops = dp_rows * W * CELL_OPS + (N * L - dp_rows) * W * PAD_CELL_OPS
    nbytes = N * L + N * refs.shape[1] + 2 * 4 * N + 3 * 4 * N + 2 * N * L * W
    return ops, nbytes + (4 * N if offs is not None else 0)
