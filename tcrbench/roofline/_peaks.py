"""The table of peaks the kernels' rooflines are taken against: one
NVIDIA H100 SXM (NVIDIA's data sheet; sm_90a at 1.98 GHz boost).

INT32: 132 SMs x 128 lanes x 1.98e9 = 33.5 Tops/s, the issue rate of
int32 adds, compares, selects and logical ops that the DP kernels spend
their cells on. HBM3: 3.35 TB/s. Both at the full 700 W power limit; the
run prints the card's limit beside the share.
"""

INT32_OPS_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# Bit-parallel DP (Myers 1999, in Hyyro's 64-row words): int32 operations
# of one word step, a 64-bit add, shift or two-input logical op counted as
# two and a three-input logical expression as one and a half
WORD_STEP_OPS = 20


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the int32 rate and the bytes over the memory rate."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def words(rows):
    """64-row words a column of ``rows`` rows takes (a tensor)."""
    return (rows.clamp(min=0) + 63) // 64
