// Kernel B6: budgeted-dovetail edit distance of short sequences (UMIs).
//
// Replaces the JAX package's device program
// ont_tcrconsensus_tpu/ops/edit_distance.py:96 `_dovetail_pair`, a
// `lax.scan` over the second sequence's columns (:137), vmapped over pairs
// by `pairwise_dovetail` (:144) and over a query x target grid by
// `many_vs_many_dovetail` (:152). Semantics are those of the plain
// ops/edit_distance.pairwise_dovetail_plain bit for bit: unit-cost edit
// distance with the borders D[i][0] = relu(i - k) and D[0][j] = relu(j - k);
// the answer is the min, over every cell with i <= a_len in the columns
// j <= b_len, of D[i][j] + relu(a_len - i - k) + relu(b_len - j - k), so up
// to k = k_end terminal bases of either sequence at either end are free.
// Codes are compared for equality, as the JAX scan compares them.
//
// Design. One thread a pair, a block one warp of 32 pairs (grid
// ceil(pairs / 32)). On the Q x T grid pair q * T + t reads query q and
// target t where they lie, so no repeated copies are made. A thread's
// column, rows 0..a_len, and its a codes live in shared memory, row i of
// lane t at i * 32 + t (no bank conflicts). The in-column insertion
// cascade, `i + cummin(base - i)` in the JAX and plain versions, is the
// serial recurrence D[i] = min(base[i], D[i-1] + 1); on integers the two are
// equal. Row i reads only rows <= i, and columns past b_len are frozen, so
// rows past a_len and columns past b_len are not computed. Each pair reads
// its own lengths: no host sync sizes the loop.
//
// Bound on the H100: operations. A cell needs 10 int32 operations (the
// match compare; the diagonal and up adds and their min; the cascade's add
// and min; the overhang past k_end, its relu, the candidate's add and min);
// chip_smoke.py counts the cells these inputs need. This design adds two
// shared-memory loads and a store a cell, and each thread's cells form one
// dependent chain, so at 8,192 pairs (256 warps on 132 SMs) the chain's
// latency sets the time. The shared column caps La at 1452 (the launcher
// refuses more).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;          // pairs a block: one warp
constexpr int kBig = 1 << 20;       // ops/edit_distance._BIG: no cell
constexpr int kMaxShared = 232448;  // bytes of shared memory a block may use (sm_90)

template <int LANES>
__global__ void __launch_bounds__(LANES)
dovetail_kernel(const uint8_t* __restrict__ a, const int32_t* __restrict__ a_lens,
                const uint8_t* __restrict__ b, const int32_t* __restrict__ b_lens,
                int32_t* __restrict__ out, int n_pairs, int T, int La, int Lb, int k) {
  extern __shared__ __align__(16) unsigned char dyn[];
  int* col = reinterpret_cast<int*>(dyn) + threadIdx.x;
  uint8_t* ac = dyn + sizeof(int) * (size_t)(La + 1) * LANES + threadIdx.x;
  const int pair = blockIdx.x * LANES + threadIdx.x;
  if (pair >= n_pairs) return;  // no barrier in this kernel
  const int ia = T > 0 ? pair / T : pair;
  const int ib = T > 0 ? pair % T : pair;
  const int a_len = a_lens[ia];
  const int b_len = b_lens[ib];
  const int n = min(a_len, La);  // rows 0..n; none when a_len < 0
  const uint8_t* arow = a + (size_t)ia * La;
  const uint8_t* brow = b + (size_t)ib * Lb;
  for (int i = 0; i < n; ++i) ac[i * LANES] = arow[i];

  // column 0, each cell charged its overhang of a past k
  int best = kBig;
  for (int i = 0; i <= n; ++i) {
    const int v = max(i - k, 0);
    col[i * LANES] = v;
    best = min(best, v + max(a_len - i - k, 0));
  }
  best += max(b_len - k, 0);

  const int ncol = min(b_len, Lb);
  for (int j = 0; j < ncol; ++j) {
    const unsigned ch = brow[j];
    int cand = kBig;
    if (n >= 0) {
      int diag = col[0];            // the old D[i-1]
      int prev = max(j + 1 - k, 0);  // the new D[i-1]: the border first
      col[0] = prev;
      cand = prev + max(a_len - k, 0);
#pragma unroll 4
      for (int i = 1; i <= n; ++i) {
        const int up = col[i * LANES];
        const int sub = ac[(i - 1) * LANES] != ch;
        const int v = min(min(diag + sub, up + 1), prev + 1);
        col[i * LANES] = v;
        cand = min(cand, v + max(a_len - i - k, 0));
        diag = up;
        prev = v;
      }
    }
    best = min(best, cand + max(b_len - (j + 1) - k, 0));
  }
  out[pair] = best;
}

}  // namespace

// a (rows_a, La) u8 and b (rows_b, Lb) u8 codes, a_lens (rows_a,) and b_lens
// (rows_b,) i32 in; out (n_pairs,) i32. T == 0: pair i reads a row i and b
// row i; T > 0: pair i reads a row i / T and b row i % T (the Q x T grid,
// n_pairs = Q * T). Returns cudaErrorInvalidValue, launching nothing, for a
// negative size or an La whose column a block's shared memory cannot hold
// (La <= 1452); else cudaGetLastError() after the launch.
extern "C" int dovetail_launch(const void* a, const void* a_lens, const void* b,
                               const void* b_lens, void* out, int n_pairs, int T, int La,
                               int Lb, int k_end, void* stream) {
  if (n_pairs < 0 || T < 0 || La < 0 || Lb < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = (sizeof(int) * (size_t)(La + 1) + (size_t)La) * kLanes;
  if (dyn > (size_t)kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dovetail_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_pairs + kLanes - 1) / kLanes);
  dovetail_kernel<kLanes><<<grid, kLanes, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(a_lens),
      static_cast<const uint8_t*>(b), static_cast<const int32_t*>(b_lens),
      static_cast<int32_t*>(out), n_pairs, T, La, Lb, k_end);
  return static_cast<int>(cudaGetLastError());
}
