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
// Design. Bit-parallel columns (bitvector.cuh: Myers 1999, Hyyro's words):
// one thread a pair, a block one warp of 32 pairs (grid ceil(pairs / 32));
// on the Q x T grid pair q * T + t reads query q and target t where they
// lie. A thread first builds its a's match words for the codes 0-5 (A C G T
// N PAD, ops/encode.py) in shared memory at stride 32. The borders enter as
// the initial Pv (+1 at rows past k) and as the top row's horizontal delta
// (+1 in the columns past k). The answer needs no cell's value but the
// corner's: D[i + 1][j] <= D[i][j] + 1 and D[i][j + 1] <= D[i][j] + 1
// everywhere, so a cell above row i0 = min(n, relu(a_len - k)) or left of
// column j0 = min(ncol, relu(b_len - k)) never beats the corner cell its
// overhang leads to (n, ncol the rows and columns computed: a_len, b_len
// capped at La, Lb), and in the corner both overhangs are the constants
// relu(a_len - n - k) + relu(b_len - ncol - k). D never falls along a
// diagonal (D[i + 1][j + 1] >= D[i][j]), so the corner's minimum lies on its
// top row or its left column: column j0 is kept, and past j0 row i0's
// horizontal deltas are summed, with the least such sum; after the last
// column the left column's cells follow from D[0][j0] = relu(j0 - k) and
// the kept column's vertical deltas (popcounts down to row i0, then row by
// row to n). A lane reads its b 16 bases at a time, in aligned 16-byte
// loads a chunk ahead of their columns (and its a the same way for the
// table), and a warp runs as many columns as its longest b needs, each lane
// bounding its own results: no branch a column. A warp runs as many words
// as its longest a needs: one or two in registers (the main path's UMIs,
// 58-68 codes at width 128). A warp with a longer a, or with a base of b
// past the codes (its word then built from a's rows), runs a loop over
// words kept in shared memory. Each pair reads its own lengths: no host
// sync sizes the loop.
//
// Bound on the H100: operations. A word step is 10 64-bit operations (three
// of them 3-input logic, one LOP3 each), 20 int32 operations, and the
// corner adds its top row's and left column's updates; chip_smoke.py counts
// the word steps these inputs need. Each thread's columns form one dependent chain
// (~12 operations a word step deep), so at 8,192 pairs (256 warps on 132
// SMs) the chain's latency sets the time. The launcher takes La up to 1452
// (23 words: 46 KB of tables and columns a block).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitvector.cuh"

namespace {

using bitvector::Column;
using bitvector::Row;
using bitvector::SharedColumn;
using bitvector::column_step;
using bitvector::for_each_quad;
using bitvector::load16;
using bitvector::prefix;

constexpr int kLanes = bitvector::kLanes;  // pairs a block: one warp
constexpr int kBig = 1 << 20;              // ops/edit_distance._BIG: no cell
constexpr int kCodes = 6;                  // the codes with a table word: A C G T N PAD
constexpr int kMaxLa = 1452;               // the widest first sequences the launcher takes
constexpr int kMaxShared = 232448;         // bytes of shared memory a block may use (sm_90)

__host__ __device__ constexpr int words_of(int rows) { return rows > 0 ? (rows + 63) / 64 : 1; }

// Word v of the match bits of byte ch over a's rows < n: a byte with no
// table word (never on the main path).
__device__ __noinline__ uint64_t match_word(const uint8_t* a, int n, int v, unsigned ch) {
  uint64_t e = 0;
  const int lo = v * 64, hi = min(n, lo + 64);
  for (int i = lo; i < hi; ++i) e |= static_cast<uint64_t>(a[i] == ch) << (i - lo);
  return e;
}

// This lane's match words of the codes over a's rows < rows, words 0..nw-1:
// code c's word v at tbl[(c * nwm + v) * kLanes]; a's bytes read 16 at a
// time (bitvector::load16).
__device__ __forceinline__ void build_table(const uint8_t* a, int rows, int nw, int nwm,
                                            uint64_t* tbl) {
  for (int v = 0; v < nw; ++v) {
    uint32_t acc[kCodes][2] = {};
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      const uint4 q = load16(a, rows, 64 * v + 16 * k16);
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const unsigned c = (words[i / 4] >> (8 * (i % 4))) & 0xffu;
        const uint32_t bit = 1u << (16 * (k16 % 2) + i);
#pragma unroll
        for (int x = 0; x < kCodes; ++x) acc[x][k16 / 2] |= c == static_cast<unsigned>(x) ? bit : 0u;
      }
    }
    const int r = rows - 64 * v;  // this word's rows of a
    const uint64_t keep = r >= 64 ? ~0ull : r > 0 ? (1ull << r) - 1 : 0ull;
#pragma unroll
    for (int x = 0; x < kCodes; ++x) {
      tbl[(x * nwm + v) * kLanes] =
          ((static_cast<uint64_t>(acc[x][1]) << 32) | acc[x][0]) & keep;
    }
  }
}

// The corner's left column, from column j0's vertical deltas `c` and
// D[0][j0] = top: (the least D[i][j0] over rows i0..n, D[i0][j0]).
template <class Col>
__device__ __forceinline__ int2 left_column(const Col& c, int n, int i0, int top) {
  int d = top + prefix(c, i0);  // D[i0][j0], then down the column
  const int at_i0 = d;
  int least = d;
  for (int r = i0 + 1; r <= n; ++r) {
    const Row row(r);
    d += row.delta(row.w, c.p_at(row.w), c.m_at(row.w));
    least = min(least, d);
  }
  return make_int2(least, at_i0);
}

// The distance of one pair with a_len >= 0: rows 0..n of a, columns
// 0..min(b_len, Lb) of b, over the warp's `wcol` columns (past the pair's
// own the column runs on, its results unread). ANY_BYTE: a base past the
// codes takes a word built from a's rows (match_word); else such a base
// sets `other`, and its word is wrong (the caller then runs the pair again
// with ANY_BYTE).
template <bool ANY_BYTE, class Col>
__device__ __forceinline__ int pair_distance(Col& col, const uint64_t* tbl, int nwm,
                                             const uint8_t* a, int n, int a_len,
                                             const uint8_t* b, int b_len, int Lb, int k,
                                             int wcol, bool& other) {
  const int ncol = max(min(b_len, Lb), 0);
  const int i0 = min(n, max(a_len - k, 0));  // the corner's top row
  const int j0 = min(ncol, max(b_len - k, 0));  // and its left column
  const int over = max(a_len - n - k, 0) + max(b_len - ncol - k, 0);
  for (int v = 0; v < col.words(); ++v) {
    const int s = k - 64 * v;  // D[i][0] = relu(i - k): +1 at the rows past k
    col.p(v) = s <= 0 ? ~0ull : s >= 64 ? 0ull : ~0ull << s;
    col.m(v) = 0;
  }
  const Row top(i0);
  int run = 0, least = kBig;  // row i0's deltas past column j0 summed; the least such sum
  // registers: column j0 is kept and read after the last column (a per-lane
  // branch in the loop would run once for each distinct j0 of the warp)
  Col at_j0 = col;
  int2 left = make_int2(kBig, 0);
  if constexpr (!Col::kRegisters) {
    if (j0 == 0) left = left_column(col, n, i0, max(-k, 0));
  }
  for_each_quad<false>(b, ncol, wcol, [&](int j4, uint32_t word) {
    unsigned c[4];  // the quad's bases and, in registers, their match words
    uint64_t eq[4][Col::kRegisters ? 2 : 1];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = (word >> (8 * u)) & 0xffu;
      if (!ANY_BYTE && j4 + u < ncol) other |= c[u] >= kCodes;
      if constexpr (Col::kRegisters) {
        const unsigned x = min(c[u], static_cast<unsigned>(kCodes - 1));
#pragma unroll
        for (int v = 0; v < col.words(); ++v) eq[u][v] = tbl[(x * nwm + v) * kLanes];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j4 + u + 1;  // the column, 1-based
      const uint64_t hin = j > k;  // D[0][j] - D[0][j - 1]
      int dt = 0;
      column_step(
          col,
          [&](int v) {
            if constexpr (Col::kRegisters) {
              return eq[u][v];
            } else {
              return c[u] < kCodes ? tbl[(c[u] * nwm + v) * kLanes] : match_word(a, n, v, c[u]);
            }
          },
          hin, [&](int v, uint64_t ph, uint64_t mh) { dt += top.delta(v, ph, mh); });
      if (j == j0) {
        if constexpr (Col::kRegisters) {
          at_j0 = col;
        } else {
          left = left_column(col, n, i0, max(j - k, 0));
        }
      }
      if (j > j0 && j <= ncol) {
        run += i0 >= 1 ? dt : static_cast<int>(hin);
        least = min(least, run);
      }
    }
  });
  if constexpr (Col::kRegisters) left = left_column(at_j0, n, i0, max(j0 - k, 0));
  return min(left.x, left.y + least) + over;
}

template <int LANES>
__global__ void __launch_bounds__(LANES)
dovetail_kernel(const uint8_t* __restrict__ a, const int32_t* __restrict__ a_lens,
                const uint8_t* __restrict__ b, const int32_t* __restrict__ b_lens,
                int32_t* __restrict__ out, int n_pairs, int T, int La, int Lb, int k) {
  static_assert(LANES == kLanes, "a block is one warp: its word count is warp-wide");
  extern __shared__ __align__(16) uint64_t dyn[];
  const int lane = threadIdx.x;
  const int nwm = words_of(La);
  uint64_t* tbl = dyn + lane;                   // kCodes x nwm words, stride LANES
  uint64_t* cols = dyn + kCodes * nwm * LANES;  // the shared-memory loop's Pv, Mv
  const int pair = blockIdx.x * LANES + lane;
  const bool live = pair < n_pairs;  // every lane stays for the warp's counts and votes
  const int ia = live ? (T > 0 ? pair / T : pair) : 0;
  const int ib = live ? (T > 0 ? pair % T : pair) : 0;
  const int a_len = live ? a_lens[ia] : -1;
  const int b_len = live ? b_lens[ib] : 0;
  const int n = min(a_len, La);  // rows 0..n; none when a_len < 0
  const bool rows = n >= 0;
  // the warp's words (as many as its longest column needs) and columns
  const int nw = words_of(static_cast<int>(
      __reduce_max_sync(0xffffffffu, static_cast<unsigned>(max(n, 0)))));
  const int wcol = static_cast<int>(__reduce_max_sync(
      0xffffffffu, static_cast<unsigned>(rows ? max(min(b_len, Lb), 0) : 0)));
  const uint8_t* arow = a + static_cast<size_t>(ia) * La;
  const uint8_t* brow = b + static_cast<size_t>(ib) * Lb;
  if (rows) build_table(arow, n, nw, nwm, tbl);
  int res = 0;
  bool other = false;  // a base of b past the codes
  if (nw <= 2) {
    if (nw == 1) {
      Column<1> col;
      if (rows) res = pair_distance<false>(col, tbl, nwm, arow, n, a_len, brow, b_len, Lb, k,
                                           wcol, other);
    } else {
      Column<2> col;
      if (rows) res = pair_distance<false>(col, tbl, nwm, arow, n, a_len, brow, b_len, Lb, k,
                                           wcol, other);
    }
  }
  if (nw > 2 || __any_sync(0xffffffffu, other)) {  // warp-uniform
    SharedColumn col{cols + lane, cols + nwm * LANES + lane, nw};
    if (rows) res = pair_distance<true>(col, tbl, nwm, arow, n, a_len, brow, b_len, Lb, k,
                                        wcol, other);
  }
  if (!rows) {  // no row: every candidate is kBig, the least column overhang added
    res = kBig + max(b_len - max(min(b_len, Lb), 0) - k, 0);
  }
  if (live) out[pair] = res;
}

size_t shared_bytes(int La) {
  const size_t nwm = words_of(La);
  return sizeof(uint64_t) * (kCodes + 2) * nwm * kLanes;
}

}  // namespace

// a (rows_a, La) u8 and b (rows_b, Lb) u8 codes, a_lens (rows_a,) and b_lens
// (rows_b,) i32 in; out (n_pairs,) i32. T == 0: pair i reads a row i and b
// row i; T > 0: pair i reads a row i / T and b row i % T (the Q x T grid,
// n_pairs = Q * T). Returns cudaErrorInvalidValue, launching nothing, for a
// negative size or an La past 1452; else cudaGetLastError() after the
// launch.
extern "C" int dovetail_launch(const void* a, const void* a_lens, const void* b,
                               const void* b_lens, void* out, int n_pairs, int T, int La,
                               int Lb, int k_end, void* stream) {
  if (n_pairs < 0 || T < 0 || La < 0 || Lb < 0 || La > kMaxLa) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t dyn = shared_bytes(La);
  if (dyn > static_cast<size_t>(kMaxShared)) return static_cast<int>(cudaErrorInvalidValue);
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
