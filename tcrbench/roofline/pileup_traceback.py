"""Kernel B3, the pileup's traceback (``csrc/pileup_traceback.cu``): its
bytes, what these inputs need: each lane's best cell, the plane cells of
its walk (at least the longer of its read span and its draft span, two
bytes a cell) and the read bases the walk emits, the offsets; each output
written once (base_at, ins_cnt, ins_base, pos_at over out_len, the
spans)."""

from tcrbench.roofline._peaks import bound_s  # noqa: F401

ENTRY = ("ont_tcrconsensus_tpu_torch.ops.traceback_kernel", "traceback_columns_cuda")
KERNEL = "pileup_traceback_kernel"


def count(args, kwargs, out):
    best, planes, reads = args[0], args[1], args[2]
    out_len = args[4] if len(args) > 4 else kwargs["out_len"]
    offs = args[5] if len(args) > 5 else kwargs.get("offs")
    N, L = reads.shape
    spans = out[4].long()
    read_span = (spans[:, 1] - spans[:, 0]).clamp(min=0)
    draft_span = (spans[:, 3] - spans[:, 2]).clamp(min=0)
    walked = read_span.maximum(draft_span).sum()
    inputs = N * 3 * 4 + walked * 2 + read_span.sum() + (4 * N if offs is not None else 0)
    outputs = N * out_len * (1 + 4 + 1 + 4) + N * 4 * 4
    return 0, inputs + outputs
