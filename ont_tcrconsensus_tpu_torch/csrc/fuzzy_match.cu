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
// Design. Bit-parallel columns (bitvector.cuh: Myers 1999, Hyyro's words):
// one thread a (pattern, window) pair, a block one warp of 32 windows of one
// pattern (grid (ceil(B / 32), P)). At block start the warp builds the
// pattern's match words in shared memory, for every byte value c and each
// 64-row word: bit i set iff i < p_len and (mask[i] & c) != 0, from 16
// ballots a word (one a mask bit and half word) and a nibble split
// (Peq[c] = L[c & 15] | H[c >> 4]); the same for the pattern reversed within
// p_len. A window base then costs one table read a word, whose address does
// not hang on the DP, and one column step: ~10 64-bit operations a word.
// The score at row p_len starts at p_len and follows that row's horizontal
// deltas. A lane reads its window 16 bases at a time, in aligned 16-byte
// loads a chunk ahead of their columns (bitvector::for_each_quad: a byte
// load a column costs a warp 32 L1 wavefronts and stalls the chain behind
// it), and a warp runs as many columns as its longest window needs, each
// lane bounding its own results: no branch a column, and four columns'
// match words read before the first. Patterns of one or two words (the main
// path's m = 47 and 32) keep their column in registers, longer ones in
// shared memory at stride 32. Columns past the warp's longest window (pass
// 1) and its latest `end` (pass 2) are not computed; a lane's columns past
// its own window or end cannot change its results, which it bounds.
//
// Bound on the H100: operations. A word step is 10 64-bit operations
// (three of them 3-input logic, one LOP3 each), 20 int32 operations, and a
// column adds its score and minimum updates; chip_smoke.py counts the word
// steps these inputs need. Each thread's columns still form one dependent
// chain (~12 operations a word step deep): at the lane's shapes (2,048
// windows a pattern set, 2-4 warps an SM) its latency, not the instruction rate,
// sets the time. The launcher takes patterns up to m = 1787 (28 words:
// 129 KB of tables and columns a block).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitvector.cuh"

namespace {

using bitvector::Column;
using bitvector::Row;
using bitvector::SharedColumn;
using bitvector::column_step;
using bitvector::for_each_quad;

constexpr int kLanes = bitvector::kLanes;  // windows a block: one warp
constexpr int kBig = 1 << 20;              // ops/fuzzy_match.BIG: a masked column
constexpr int kMaxM = 1787;                // the longest pattern the launcher takes
constexpr int kMaxShared = 232448;         // bytes of shared memory a block may use (sm_90)

__host__ __device__ constexpr int words_of(int rows) { return rows > 0 ? (rows + 63) / 64 : 1; }

// Build word v of the pattern's match tables, forward and reversed within n
// (tables of 256 x nw words, [c * nw + v]), from the masks pm. Every lane of
// the warp takes part.
__device__ __forceinline__ void build_word(const uint8_t* pm, int n, int nw, int v, int lane,
                                           uint64_t* fwd, uint64_t* rev) {
  uint32_t fb[8][2], rb[8][2];  // row bits of each mask bit, each half word
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = v * 64 + h * 32 + lane;
    const unsigned f = i < n ? pm[i] : 0u;
    const unsigned r = i < n ? pm[n - 1 - i] : 0u;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      fb[b][h] = __ballot_sync(0xffffffffu, (f >> b) & 1u);
      rb[b][h] = __ballot_sync(0xffffffffu, (r >> b) & 1u);
    }
  }
  // c & 15 is lane & 15 for each c = lane + 32 q this lane writes
  uint32_t fl[2] = {0u, 0u}, rl[2] = {0u, 0u};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if ((lane >> b) & 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fl[h] |= fb[b][h];
        rl[h] |= rb[b][h];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = lane + 32 * q;
    const int hi = c >> 4;
    uint32_t f[2] = {fl[0], fl[1]}, r[2] = {rl[0], rl[1]};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if ((hi >> b) & 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          f[h] |= fb[4 + b][h];
          r[h] |= rb[4 + b][h];
        }
      }
    }
    fwd[c * nw + v] = (static_cast<uint64_t>(f[1]) << 32) | f[0];
    rev[c * nw + v] = (static_cast<uint64_t>(r[1]) << 32) | r[0];
  }
}

// One pass of this lane's column over its text (the window `row` read
// forward, or its prefix [0, len) backwards: DESC) with the match table
// `tbl` (nw words a byte value), reset to D[i][0] = i, for the warp's
// `ncol` columns; calls on_col(j, score) with the score at row n after each
// column (past the lane's own columns the scores are garbage).
template <bool DESC, class Col, class OnCol>
__device__ __forceinline__ void run_pass(Col& col, const uint64_t* tbl, int nw, int n,
                                         const uint8_t* row, int len, int ncol, OnCol on_col) {
  for (int v = 0; v < col.words(); ++v) {
    col.p(v) = ~0ull;
    col.m(v) = 0;
  }
  const Row last(n);
  int score = n;
  for_each_quad<DESC>(row, len, ncol, [&](int j, uint32_t word) {
    const uint64_t* e[4];  // the quad's match words, read before its first column
#pragma unroll
    for (int u = 0; u < 4; ++u) e[u] = tbl + ((word >> (8 * u)) & 0xffu) * nw;
    uint64_t eq[4][Col::kRegisters ? 2 : 1];
    if constexpr (Col::kRegisters) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < col.words(); ++v) eq[u][v] = e[u][v];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int d = 0;
      column_step(
          col,
          [&](int v) {
            if constexpr (Col::kRegisters) return eq[u][v];
            else return e[u][v];
          },
          0ull, [&](int v, uint64_t ph, uint64_t mh) { d += last.delta(v, ph, mh); });
      score += d;
      on_col(j + u, score);
    }
  });
}

// Both passes of one (pattern, window) pair: dist, start, end. Every lane
// of the warp takes part (a lane past the windows has an empty one).
template <class Col>
__device__ __forceinline__ void find(Col& col, const uint64_t* fwd, const uint64_t* rev, int nw,
                                     int n, int p_len, const uint8_t* w, int wl, int Lw,
                                     int& dist, int& start, int& end) {
  // pass 1: the final row over the window's columns, its first minimum
  const int ncol = max(min(wl, Lw), 0);
  dist = wl >= 0 ? p_len : kBig;  // column 0: the empty prefix
  end = 0;
  run_pass<false>(col, fwd, nw, n, w, ncol, __reduce_max_sync(0xffffffffu, ncol),
                  [&](int j, int score) {
                    if (j < ncol && score < dist) {
                      dist = score;
                      end = j + 1;
                    }
                  });
  // pass 2: the reversed pattern over the prefix [0, end) backwards; the
  // last column whose row equals the distance is the smallest start
  int j2 = p_len == dist ? 0 : -1;
  run_pass<true>(col, rev, nw, n, w, end, __reduce_max_sync(0xffffffffu, end),
                 [&](int r, int score) {
                   if (r < end && score == dist) j2 = r + 1;
                 });
  start = end - j2;
}

template <int LANES>
__global__ void __launch_bounds__(LANES)
fuzzy_match_kernel(const uint8_t* __restrict__ pmasks, const int32_t* __restrict__ plens,
                   const uint8_t* __restrict__ windows, const int32_t* __restrict__ wlens,
                   int32_t* __restrict__ out, int P, int m, int B, int Lw) {
  static_assert(LANES == kLanes, "a block is one warp: the tables are built by ballots");
  extern __shared__ __align__(16) uint64_t dyn[];
  const int nwm = words_of(m);
  uint64_t* fwd = dyn;               // 256 x nw words
  uint64_t* rev = dyn + 256 * nwm;   // 256 x nw words
  uint64_t* cols = rev + 256 * nwm;  // patterns of three words and more: Pv, Mv
  const int lane = threadIdx.x;
  const int p = blockIdx.y;
  const int p_len = plens[p];
  const int n = min(max(p_len, 0), m);  // the rows read
  const int nw = words_of(n);           // an empty pattern reads one word of zeros
  const uint8_t* pm = pmasks + static_cast<size_t>(p) * m;
  for (int v = 0; v < nw; ++v) build_word(pm, n, nw, v, lane, fwd, rev);
  __syncthreads();
  const int b = blockIdx.x * LANES + lane;
  const bool live = b < B;  // every lane stays for the warp's column counts
  const uint8_t* w = windows + static_cast<size_t>(live ? b : 0) * Lw;
  const int wl = live ? wlens[b] : 0;
  int dist, start, end;
  if (nw == 1) {
    Column<1> col;
    find(col, fwd, rev, nw, n, p_len, w, wl, Lw, dist, start, end);
  } else if (nw == 2) {
    Column<2> col;
    find(col, fwd, rev, nw, n, p_len, w, wl, Lw, dist, start, end);
  } else {
    SharedColumn col{cols + lane, cols + nwm * LANES + lane, nw};
    find(col, fwd, rev, nw, n, p_len, w, wl, Lw, dist, start, end);
  }
  if (live) {
    const size_t o = static_cast<size_t>(p) * B + b;
    const size_t plane = static_cast<size_t>(P) * B;
    out[o] = dist;
    out[plane + o] = start;
    out[2 * plane + o] = end;
  }
}

size_t shared_bytes(int m) {
  const size_t nwm = words_of(m);
  return sizeof(uint64_t) * (2 * 256 * nwm + (nwm > 2 ? 2 * nwm * kLanes : 0));
}

}  // namespace

// pmasks (P, m) u8 zero-padded past each length, plens (P,) i32, windows
// (B, Lw) u8, wlens (B,) i32 in; out (3, P, B) i32: dist, start, end.
// Returns cudaErrorInvalidValue, launching nothing, for a negative size,
// more than 65,535 patterns (the grid's y) or a pattern longer than 1787
// masks; else cudaGetLastError() after the launch.
extern "C" int fuzzy_match_launch(const void* pmasks, const void* plens, const void* windows,
                                  const void* wlens, void* out, int P, int m, int B, int Lw,
                                  void* stream) {
  if (P < 0 || m < 0 || B < 0 || Lw < 0 || P > 65535 || m > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t dyn = shared_bytes(m);
  if (dyn > static_cast<size_t>(kMaxShared)) return static_cast<int>(cudaErrorInvalidValue);
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
