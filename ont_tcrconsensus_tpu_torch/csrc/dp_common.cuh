// Warp-level band primitives shared by the two banded DP kernels.
//
// A band of W = NS * 32 slots lives in one warp: slot b = k * 32 + lane is
// register k of lane `lane`. The JAX package's kernels shift whole band
// vectors along the TPU's lanes; here a shift by s < 32 slots is a pair of
// warp shuffles (same register from lane - s, previous register from the
// lane 32 - s above), and a shift by a multiple of 32 is a register move.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dp {

constexpr int kNeg = -(1 << 24);  // sw_align.NEG
constexpr int kPad = 5;           // encode.PAD_CODE: never matches
// pileup plane bits (ops/pileup.py): tmp choice in bits 0-1, diag-stop and
// E-opened flags, fjump in the bits from kJumpShift up
constexpr int kDiag = 0;
constexpr int kEGap = 1;
constexpr int kFresh = 3;
constexpr int kDiagStopBit = 4;
constexpr int kEOpenBit = 8;
constexpr int kJumpShift = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

// y[b] = x[b + 1]; `fill` at the band's last slot.
template <int NS>
__device__ __forceinline__ void shift_up(const int (&x)[NS], int (&y)[NS],
                                         int fill, int lane) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int down = __shfl_down_sync(kFull, x[k], 1);
    int next = fill;
    if (k + 1 < NS) next = __shfl_sync(kFull, x[k + 1 < NS ? k + 1 : k], 0);
    y[k] = lane < 31 ? down : next;
  }
}

// y[b] = x[b - S]; `fill` at the band's first S slots.
template <int NS, int S>
__device__ __forceinline__ void shift_right(const int (&x)[NS], int (&y)[NS],
                                            int fill, int lane) {
  if constexpr (S < 32) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int same = __shfl_up_sync(kFull, x[k], S);
      int prev = fill;
      if (k > 0) prev = __shfl_down_sync(kFull, x[k > 0 ? k - 1 : 0], 32 - S);
      y[k] = lane >= S ? same : prev;
    }
  } else {
    constexpr int M = S / 32;
#pragma unroll
    for (int k = 0; k < NS; ++k) y[k] = k >= M ? x[k >= M ? k - M : 0] : fill;
  }
}

// Lexicographic best over (score desc, row asc, slot asc): the sequential
// kernel's tie-break (first row that reaches the maximum, then the
// smallest slot in that row).
__device__ __forceinline__ bool better(int s, int r, int b, int s2, int r2, int b2) {
  return s > s2 || (s == s2 && (r < r2 || (r == r2 && b < b2)));
}

}  // namespace dp
