// Kernel B5: multi-pattern infix (semi-global) fuzzy match with IUPAC masks.
//
// Replaces the JAX package's device program
// ont_tcrconsensus_tpu/ops/fuzzy_match.py:105 `fuzzy_find_multi`, whose
// `_final_row` (:52) is a `lax.scan` over a window's columns (:71), vmapped
// over patterns and windows and run twice: forward for the end, over the
// reversed prefix for the start. Semantics are those of the plain
// ops/fuzzy_match.fuzzy_find_multi_plain bit for bit: a pattern base and a
// window base match iff their 4-bit masks intersect (mask 0 never matches);
// the final row is read at the pattern's length p_len, not at the padded
// width m; columns past the window's length are masked; `end` is the first
// minimum of that row; `start = end - j2`, j2 the largest j <= end where the
// reversed pattern's row over the reversed prefix [0, end) equals the
// distance (DIVERGENCES.md §1). An empty window gives dist = p_len, end 0.
//
// Design. One thread a (pattern, window) pair. A block is one warp: 32
// windows of one pattern (grid (ceil(B / 32), P)), so the pattern's masks
// and their reverse sit in shared memory and every read of them is a
// broadcast. A thread's DP column, rows 0..p_len, lives in shared memory,
// row i of lane t at i * 32 + t (no bank conflicts). The in-column
// insertion cascade, `i + cummin(base - i)` in the JAX and plain versions,
// is the serial recurrence D[i] = min(base[i], D[i-1] + 1); on integers the
// two are equal. Rows past p_len, columns past the window's length (pass
// 1) and past `end` (pass 2) cannot change a result and are not computed.
//
// Bound on the H100: operations. A cell needs 7 int32 operations (the
// match test's and and compare, the diagonal and up adds and their min,
// the cascade's add and min); chip_smoke.py counts the cells these inputs
// need. This design adds two shared-memory loads and a store a cell, and
// each thread's cells form one dependent chain: at the lane's shapes
// (2,048-4,096 windows a pattern set) the card holds a few warps an SM, so
// the chain's latency, not the issue rate, sets the time. The shared
// column caps the pattern length at 1787 (the launcher refuses more).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;          // pairs a block: one warp
constexpr int kBig = 1 << 20;       // ops/fuzzy_match.BIG: a masked column
constexpr int kMaxShared = 232448;  // bytes of shared memory a block may use (sm_90)

// One column of the infix DP: rows 1..n of this lane's column `col`
// (stride kLanes) against the window base `ch`; row 0 stays 0 (the text's
// start is free). Returns the new value at row n.
__device__ __forceinline__ int column(int* col, const uint8_t* pat, int n, unsigned ch) {
  int diag = 0;  // the old D[i-1]: D[0] is 0 in every column
  int prev = 0;  // the new D[i-1]
#pragma unroll 4
  for (int i = 1; i <= n; ++i) {
    const int up = col[i * kLanes];
    const int sub = (pat[i - 1] & ch) == 0;
    const int v = min(min(diag + sub, up + 1), prev + 1);
    col[i * kLanes] = v;
    diag = up;
    prev = v;
  }
  return prev;
}

template <int LANES>
__global__ void __launch_bounds__(LANES)
fuzzy_match_kernel(const uint8_t* __restrict__ pmasks, const int32_t* __restrict__ plens,
                   const uint8_t* __restrict__ windows, const int32_t* __restrict__ wlens,
                   int32_t* __restrict__ out, int P, int m, int B, int Lw) {
  static_assert(LANES == kLanes, "the column's stride is one warp");
  extern __shared__ __align__(16) unsigned char dyn[];
  int* col = reinterpret_cast<int*>(dyn) + threadIdx.x;
  uint8_t* pat = dyn + sizeof(int) * (size_t)(m + 1) * LANES;
  uint8_t* rev = pat + m;
  const int p = blockIdx.y;
  const int p_len = plens[p];
  const int n = min(max(p_len, 0), m);  // the rows read
  const uint8_t* pm = pmasks + (size_t)p * m;
  for (int i = threadIdx.x; i < m; i += LANES) {
    pat[i] = pm[i];
    rev[i] = i < n ? pm[n - 1 - i] : 0;  // reversed within p_len, zero past it
  }
  __syncthreads();
  const int b = blockIdx.x * LANES + threadIdx.x;
  if (b >= B) return;  // no barrier follows
  const uint8_t* w = windows + (size_t)b * Lw;
  const int wl = wlens[b];

  // pass 1: the final row over the window's columns, its first minimum
  for (int i = 0; i <= n; ++i) col[i * LANES] = i;
  int dist = wl >= 0 ? p_len : kBig;  // column 0: the empty prefix
  int end = 0;
  const int ncol = min(wl, Lw);
  for (int j = 0; j < ncol; ++j) {
    const int v = column(col, pat, n, w[j]);
    if (v < dist) {
      dist = v;
      end = j + 1;
    }
  }

  // pass 2: the reversed pattern over the prefix [0, end) backwards; the
  // last column whose row equals the distance is the smallest start
  for (int i = 0; i <= n; ++i) col[i * LANES] = i;
  int j2 = p_len == dist ? 0 : -1;
  for (int r = 0; r < end; ++r) {
    if (column(col, rev, n, w[end - 1 - r]) == dist) j2 = r + 1;
  }

  const size_t o = (size_t)p * B + b;
  const size_t plane = (size_t)P * B;
  out[o] = dist;
  out[plane + o] = end - j2;
  out[2 * plane + o] = end;
}

}  // namespace

// pmasks (P, m) u8 zero-padded past each length, plens (P,) i32, windows
// (B, Lw) u8, wlens (B,) i32 in; out (3, P, B) i32: dist, start, end.
// Returns cudaErrorInvalidValue, launching nothing, for a negative size,
// more than 65,535 patterns (the grid's y) or a pattern longer than a
// block's shared-memory column holds (m <= 1787); else cudaGetLastError()
// after the launch.
extern "C" int fuzzy_match_launch(const void* pmasks, const void* plens, const void* windows,
                                  const void* wlens, void* out, int P, int m, int B, int Lw,
                                  void* stream) {
  if (P < 0 || m < 0 || B < 0 || Lw < 0 || P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t dyn = sizeof(int) * (size_t)(m + 1) * kLanes + 2 * (size_t)m;
  if (dyn > (size_t)kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || B == 0) return 0;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fuzzy_match_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((B + kLanes - 1) / kLanes, P);
  fuzzy_match_kernel<kLanes><<<grid, kLanes, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pmasks), static_cast<const int32_t*>(plens),
      static_cast<const uint8_t*>(windows), static_cast<const int32_t*>(wlens),
      static_cast<int32_t*>(out), P, m, B, Lw);
  return static_cast<int>(cudaGetLastError());
}
