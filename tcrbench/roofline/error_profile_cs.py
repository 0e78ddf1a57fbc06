"""Kernel B4, the QC error profile's banded DP and walk
(``csrc/error_profile_cs.cu``): its bytes, each input read once (the
query and reference codes, the lengths, band widths and band starts) and
the (N + M, L) op log's three planes written once; its scratch plane is
not counted."""

from tcrbench.roofline._peaks import bound_s  # noqa: F401

ENTRY = ("ont_tcrconsensus_tpu_torch.ops.cs_kernel", "error_profile_cs_cuda")
KERNEL = "error_profile_cs_kernel"


def count(args, kwargs, out):
    qpad, rpad, n_arr, m_arr, lo_all, ws = args[:6]
    L, N = qpad.shape
    M = rpad.shape[1]
    inputs = qpad.numel() + rpad.numel() + 4 * (n_arr.numel() + m_arr.numel() + ws.numel()
                                                 + lo_all.numel())
    return 0, inputs + 3 * (N + M) * L
