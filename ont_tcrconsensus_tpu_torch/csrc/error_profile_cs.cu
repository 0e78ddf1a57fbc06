// Kernel B4: the QC error profile's banded unit-cost DP, its fill and its
// traceback, for a tile of sampled reads against their reference spans.
//
// Replaces the JAX package's device program
// ont_tcrconsensus_tpu/qc/error_profile.py:294 `_device_cs_core`, a jitted
// pair of `lax.scan`s (the fill over rows, the walk over steps; not a Pallas
// kernel). Semantics are those of the port's plain qc/error_profile.py
// `_device_cs_core`, bit for bit: row i of read b keeps the band
// [lo[i], lo[i] + W) of reference positions; a cell takes min(diagonal +
// substitution, up + 1), the up move winning only on a strict `<`, then the
// left (reference-gap) chain min over lanes k < t of (best[k] - k) + t,
// winning only on a strict `<`; every index outside [0, W) reads BIG. The
// walk starts at (n, m) and logs each move in reverse order as (kind, query
// code, reference code); it stops at (0, 0) or where it leaves the read's own
// band (ws), and the rows past that stay STOP, as the wrapper
// (ops/cs_kernel.py) fills them.
//
// Design. One block a read; each thread owns NS adjacent band lanes
// (cells_per_thread: W / 64, 2 at W = 128 up to 5 at 320), so a band of W
// lanes is two warps. The block first copies its read's query,
// reference and band starts into shared memory (cp.async), so no row of the
// fill and no step of the walk loads them from device memory; each row's
// band start and bases are loaded a row ahead. The fill keeps the previous
// row in shared memory, double buffered, and reads it at cell + shift - 1
// (diagonal) and cell + shift (up) for any shift the row's band start moves
// by. The left chain is a block-wide exclusive prefix minimum of best -
// cell: each thread's running minimum over its own cells, an inclusive
// warp scan of the threads' totals (shuffles), each warp's total in shared
// memory, then each thread folds the totals of the warps to its left. Two
// barriers a row. Each row of the direction plane (0 diagonal, 1 up, 2
// left) is packed to 2 bits a cell, cell t at bits 2 (t % 16) of word
// t / 16 (W / 4 bytes a row), each thread OR-ing its cells' bits into
// shared memory; the walk decodes a cell with a shift and a mask. The rows
// collect in shared memory and go
// out kRows at a time, 16 bytes a thread, to a scratch plane (L, N + 1,
// W / 4) in device memory. After the read's last row warp 0 walks, the
// block's other warps gone: it stages the packed rows back, kRows a chunk
// into a ring in shared memory (csrc/staging.cuh), the chunk above in
// flight while it walks the current one (the walk moves up at most a row a
// step). Its 32 threads step alike; each step loads the words of the
// three cells it can move to while it decodes its own, and its log entries
// go to shared memory and out to the op log (N + M, L) by the warp's 32
// threads together. Rows past a read's n are neither filled nor read.
//
// Bound on the H100: the function moves a few bytes a cell at most and
// does some 30 int32 operations a band cell, so its bound is the operations,
// about 0.1 ms at a 512-read tile. This design is bound by latency instead:
// each row of the fill waits on the row before it (two barriers and a
// shuffle scan), more so when the tile's reads share an SM's issue slots;
// each step of the walk is a chain of shared-memory loads and the step's
// arithmetic. Its floor is the tile's slowest read alone (chip_smoke.py
// prints it).
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kBig = 1 << 20;
constexpr uint8_t kMatch = 0, kSub = 1, kIns = 2, kDel = 3, kStop = 4;  // STOP: the wrapper's fill
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 64;  // packed plane rows a chunk (the fill's writes, the walk's staging)
constexpr int kRing = 4 * kRows;  // the walk's ring of staged rows
constexpr int kLog = 128;  // the walk's moves held before they are written out as op log rows
// a step's move: diagonal (i - 1, j - 1), up or the tail insertion (i - 1),
// left (j - 1), or the stop
constexpr uint8_t kMoveDiag = 0, kMoveUp = 1, kMoveLeft = 2, kMoveStop = 3;
constexpr int kMaxShared = 232448;  // bytes of shared memory a block may use (sm_90)

__host__ __device__ constexpr size_t round4(size_t x) { return (x + 3) & ~size_t(3); }

// The dynamic shared memory of a block: the walk's two chunks of packed
// rows, then lo (N + 1 int32), q (N bytes) and r (M bytes), each from a
// 4-byte boundary.
__host__ __device__ constexpr size_t ring_bytes(int W) { return (size_t)kRing * (W / 4); }
inline size_t shared_bytes(int W, int N, int M) {
  return ring_bytes(W) + 4 * ((size_t)N + 1) + round4(N) + round4(M);
}

// A read's row of codes into shared memory: 4-byte copies where the row
// and its length allow, else bytes.
__device__ __forceinline__ void stage_codes(uint8_t* dst, const uint8_t* src, int len, int tid,
                                            int threads) {
  if ((reinterpret_cast<uintptr_t>(src) & 3) == 0 && (len & 3) == 0) {
    for (int k = tid; k < len / 4; k += threads) staging::cp_async4(dst + 4 * k, src + 4 * k);
  } else {
    for (int k = tid; k < len; k += threads) dst[k] = src[k];
  }
}

// Band cells a thread owns in the fill, cell t = thread * NS + k, k < NS:
// W / 64, two warps a read at every width. One warp a read makes each row's
// chain longer; a thread a lane spends more instructions a row, and the
// tile's reads share each SM's issue slots.
template <int W>
__host__ __device__ constexpr int cells_per_thread() { return W / 64; }

template <int W, int NS = cells_per_thread<W>()>
__global__ void __launch_bounds__(W / NS, 1)
error_profile_cs_kernel(const uint8_t* __restrict__ qpad, const uint8_t* __restrict__ rpad,
                        const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
                        const int32_t* __restrict__ ws_arr, const int32_t* __restrict__ lo_all,
                        uint8_t* __restrict__ plane, uint8_t* __restrict__ kind,
                        uint8_t* __restrict__ qb, uint8_t* __restrict__ rb, int L, int N,
                        int M) {
  constexpr int kThreads = W / NS;
  constexpr int kWarps = kThreads / 32;
  constexpr int kRowBytes = W / 4;
  constexpr int kRowWords = W / 16;
  static_assert(kThreads % 32 == 0, "whole warps");
  // a row's values, cell c at at(c): with NS a multiple of 4, c + c / 32
  // (at most two threads of a warp on one bank)
  __shared__ int rows[2][W + W / 32];
  __shared__ __align__(16) int warp_min[kWarps];
  // the plane rows of the current chunk of kRows, written out as it fills
  __shared__ __align__(16) uint32_t chunk[kRows * kRowWords];
  __shared__ uint8_t log_move[kLog];
  extern __shared__ __align__(16) uint8_t dyn[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(dyn);  // [kRing][kRowWords]
  int32_t* lo = reinterpret_cast<int32_t*>(dyn + ring_bytes(W));
  uint8_t* q = reinterpret_cast<uint8_t*>(lo + N + 1);
  uint8_t* r = q + round4(N);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int t0 = tid * NS;
  const int n = n_arr[b], m = m_arr[b], ws = ws_arr[b];
  {
    const int32_t* lo_g = lo_all + (size_t)b * (N + 1);
    for (int k = tid; k <= N; k += kThreads) staging::cp_async4(lo + k, lo_g + k);
    stage_codes(q, qpad + (size_t)b * N, N, tid, kThreads);
    stage_codes(r, rpad + (size_t)b * M, M, tid, kThreads);
    staging::commit();
    staging::wait<0>();
  }
  uint8_t* ptr = plane + (size_t)b * (N + 1) * kRowBytes;
  for (int k = tid; k < kRows * kRowWords; k += kThreads) chunk[k] = 0;
  __syncthreads();

  auto at = [](int c) { return NS % 4 == 0 ? c + (c >> 5) : c; };
  // a row's directions (0 diagonal, 1 up, 2 left) into the chunk, 2 bits a
  // cell: cell t at bits 2 (t % 16) of word t / 16, each thread OR-ing its
  // cells' 2 NS bits into the row's one or two words
  auto store_row = [&](int i, const int (&p)[NS]) {
    uint32_t bits = 0;
#pragma unroll
    for (int k = 0; k < NS; ++k) bits |= (uint32_t)p[k] << (2 * k);
    uint32_t* row = chunk + (i % kRows) * kRowWords + (2 * t0 >> 5);
    const int shift = 2 * t0 & 31;
    atomicOr(row, bits << shift);
    if (shift + 2 * NS > 32) atomicOr(row + 1, bits >> (32 - shift));
  };
  // after the barrier that ends row i: the chunk out to the plane when row
  // i is its last, and back to zeros
  auto flush_if = [&](int i) {
    if (i % kRows != kRows - 1 && i != n) return;
    const int first = i - i % kRows;
    const int pieces = (i - first + 1) * (kRowBytes / 16);
    uint4* src = reinterpret_cast<uint4*>(chunk);
    uint4* dst = reinterpret_cast<uint4*>(ptr + (size_t)first * kRowBytes);
    for (int k = tid; k < pieces; k += kThreads) {
      dst[k] = src[k];
      src[k] = make_uint4(0, 0, 0, 0);
    }
  };

  // row 0: D[0][j] = j deletions, each a left move
  int lo_prev = lo[0];
  {
    int p[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int t = t0 + k;
      const int js = lo_prev + t;
      const bool valid = t < ws && js <= m;
      rows[0][at(t)] = valid ? js : kBig;
      p[k] = valid ? 2 : 0;
    }
    store_row(0, p);
  }
  __syncthreads();
  flush_if(0);

  // the next row's band start, query base and reference bases, loaded a
  // row ahead; a query base of 4 or more (N, pad) matches nothing
  auto ref_at = [&](int js) { return (int)r[min(max(js - 1, 0), M - 1)]; };
  int nlo = lo[min(1, N)];
  int qi = q[0];
  int rj[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) rj[k] = ref_at(nlo + t0 + k);
  int* prev = rows[0];
  int* cur = rows[1];
  for (int i = 1; i <= n; ++i) {
    const int nlo_next = lo[min(i + 1, N)];
    const int qi_next = q[min(i, N - 1)];
    const bool q_none = qi >= 4;
    const int shift = nlo - lo_prev;
    // the row above at cell + shift - 1 (diagonal) and cell + shift (up)
    int above[NS + 1];
#pragma unroll
    for (int k = 0; k <= NS; ++k) {
      const int c = t0 + k + shift - 1;
      above[k] = (unsigned)c < (unsigned)W ? prev[at(c)] : kBig;
    }
    int best[NS], p[NS], before[NS];
    bool valid[NS];
    int run = INT_MAX;  // min of best - cell over this thread's cells so far
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int t = t0 + k;
      const int js = nlo + t;
      valid[k] = t < ws && js <= m;
      const int d = js >= 1 ? above[k] + (q_none || rj[k] != qi) : kBig;
      const int u = above[k + 1] + 1;
      best[k] = valid[k] ? min(d, u) : kBig;
      p[k] = u < d ? 1 : 0;  // ties prefer the diagonal
      before[k] = run;
      run = min(run, best[k] - t);
    }
    // inclusive prefix min over the warp of the threads' runs (a shuffle
    // from below lane 0 returns the lane's own value, which min ignores)
    int v = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) v = min(v, __shfl_up_sync(kFull, v, o));
    int excl = __shfl_up_sync(kFull, v, 1);
    if (wl == 0) excl = INT_MAX;
    if (wl == 31) warp_min[warp] = v;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWarps - 1; ++k) {
      if (k < warp) excl = min(excl, warp_min[k]);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int t = t0 + k;
      const int left = t == 0 ? kBig : min(excl, before[k]) + t;
      const bool take = left < best[k] && valid[k];  // the left chain wins only when strictly better
      cur[at(t)] = valid[k] ? (take ? left : best[k]) : kBig;
      p[k] = valid[k] ? (take ? 2 : p[k]) : 0;
    }
    store_row(i, p);
    lo_prev = nlo;
    nlo = nlo_next;
    qi = qi_next;
    int* const done_row = prev;
    prev = cur;
    cur = done_row;
#pragma unroll
    for (int k = 0; k < NS; ++k) rj[k] = ref_at(nlo + t0 + k);
    __syncthreads();
    flush_if(i);
  }
  __syncthreads();  // every plane row is out before warp 0 stages them

  if (warp != 0) return;
  // the walk, from (n, m) back to (0, 0); kind is STOP from the first step
  // that is not a move on. Plane rows are staged by chunks of kRows aligned
  // to multiples of kRows, row i at ring row i % kRing: the walk's chunk
  // and the one above it are in the ring, and the chunk above that is in
  // flight from when the walk reaches its chunk's first row. Each step
  // loads the words of the three cells it can move to while it decodes its
  // own, so its chain is the decode, the choice and a select, and logs only
  // its move; every kLog steps the 32 threads rebuild the op log rows from
  // the moves (a scan gives each entry's cell, then its codes) and write
  // them out (stride L).
  auto stage = [&](int first) {
    if (first >= 0) {
      staging::stage_rows(ring + (first & (kRing - 1)) * kRowWords, ptr, first,
                          min(first + kRows - 1, n), kRowBytes, wl);
    }
    staging::commit();
  };
  // the word holding cell c of a staged row (c clamped into the row: a
  // cell outside the band is never decoded, the walk stops there first)
  auto word = [&](int row, int c) {
    return ring[(row & (kRing - 1)) * kRowWords + (min(max(c, 0), W - 1) >> 4)];
  };
  const int S = N + M;
  int i = n, j = m, s = 0, s0 = 0;
  int i_s0 = i, j_s0 = j;         // the cell of step s0, the log's first entry
  int t = j - lo[i];              // j's cell in row i
  int lo_up = lo[max(i - 1, 0)];  // row i - 1's band start
  int lo_row = n - n % kRows;     // the walk's chunk's first row
  stage(lo_row);
  stage(lo_row - kRows);
  staging::wait<1>();
  __syncwarp();
  uint32_t w = word(i, t);
  bool stop = false;
  while (!stop && s < S) {
    if (i == lo_row && i > 0) {  // the walk leaves its chunk with its next move up
      staging::wait<0>();
      __syncwarp();
      stage(lo_row - 2 * kRows);
      lo_row -= kRows;
    }
    for (const int s_end = min(S, s0 + kLog); s < s_end && (i > lo_row || i == 0); ++s) {
      // loads first: their values are used at the step's end
      const int tu = j - lo_up;  // j's cell in row i - 1
      const uint32_t w_diag = word(i - 1, tu - 1), w_up = word(i - 1, tu), w_left = word(i, t - 1);
      const int lo_next = lo[max(i - 2, 0)];
      // the step, from registers
      const bool done = (i | j) == 0 || (unsigned)t >= (unsigned)ws;  // or off the read's band
      const int p = (w >> ((t & 15) * 2)) & 3;
      const bool is_diag = i > 0 && j > 0 && p == 0;
      const bool is_up = !is_diag && i > 0 && p == 1;
      // neither diagonal nor up: left while j > 0, else (i > 0, j == 0,
      // p != 1) the tail insertion, a move up like `up`
      const bool is_left = !is_diag && !is_up && j > 0;
      log_move[s - s0] = done ? kMoveStop : is_diag ? kMoveDiag : (is_left ? kMoveLeft : kMoveUp);
      if (done) {
        ++s;
        stop = true;
        break;
      }
      i -= !is_left;
      j -= is_diag || is_left;
      t = is_left ? t - 1 : (is_diag ? tu - 1 : tu);
      w = is_left ? w_left : (is_diag ? w_diag : w_up);
      lo_up = is_left ? lo_up : lo_next;
    }
    __syncwarp();
    // the moves out as op log rows: thread l takes entries 4l .. 4l + 3, its
    // starting cell from a warp scan of the moves before them
    {
      constexpr int kPer = kLog / 32;
      const int count = s - s0;
      int mv[kPer];
      int steps = 0;  // (rows up) << 16 | (columns left) over this thread's entries
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = kPer * wl + k;
        mv[k] = e < count ? log_move[e] : kMoveStop;
        steps += ((mv[k] == kMoveDiag || mv[k] == kMoveUp) << 16) +
                 (mv[k] == kMoveDiag || mv[k] == kMoveLeft);
      }
      int incl = steps;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, incl, o);
        if (wl >= o) incl += x;
      }
      int ii = i_s0 - ((incl - steps) >> 16), jj = j_s0 - ((incl - steps) & 0xffff);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = kPer * wl + k;
        if (e < count) {
          const int qc = q[max(ii - 1, 0)], rc = r[max(jj - 1, 0)];
          const size_t o = (size_t)(s0 + e) * L + b;
          kind[o] = mv[k] == kMoveStop ? kStop
                    : mv[k] == kMoveDiag ? ((qc == rc && qc < 4) ? kMatch : kSub)
                                         : (mv[k] == kMoveLeft ? kDel : kIns);
          qb[o] = (uint8_t)qc;
          rb[o] = (uint8_t)rc;
          ii -= mv[k] == kMoveDiag || mv[k] == kMoveUp;
          jj -= mv[k] == kMoveDiag || mv[k] == kMoveLeft;
        }
      }
    }
    s0 = s;
    i_s0 = i;
    j_s0 = j;
    __syncwarp();
  }
  staging::wait<0>();  // no copy may land after the block's shared memory is reused
}

template <int W>
int launch(const void* qpad, const void* rpad, const void* n, const void* m, const void* ws,
           const void* lo_all, void* plane, void* kind, void* qb, void* rb, int L, int N, int M,
           cudaStream_t stream) {
  const size_t dyn = shared_bytes(W, N, M);
  const size_t fixed = sizeof(int) * (2 * (W + W / 32) + W / 32) + kRows * W / 4 + kLog;
  if (dyn + fixed > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        error_profile_cs_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  error_profile_cs_kernel<W><<<L, W / cells_per_thread<W>(), dyn, stream>>>(
      static_cast<const uint8_t*>(qpad), static_cast<const uint8_t*>(rpad),
      static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
      static_cast<const int32_t*>(ws), static_cast<const int32_t*>(lo_all),
      static_cast<uint8_t*>(plane), static_cast<uint8_t*>(kind), static_cast<uint8_t*>(qb),
      static_cast<uint8_t*>(rb), L, N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qpad (L, N) u8, rpad (L, M) u8, n, m, ws (L,) i32 and lo_all (L, N + 1) i32
// in; plane (L, N + 1, w_pad / 4) u8 scratch, 16-byte aligned; kind, qb, rb
// (N + M, L) u8 out, kind filled with STOP by the caller. Returns
// cudaErrorInvalidValue, launching nothing, for a band width it is not built
// for, a negative size, an unaligned plane, or N and M too long for a
// block's shared memory (about 6 (N + M) / 2 + 2 * 64 * w_pad / 4 bytes
// under 227 KB: N = M up to about 37,000); else cudaGetLastError() after
// the launch.
extern "C" int error_profile_cs_launch(const void* qpad, const void* rpad, const void* n,
                                       const void* m, const void* ws, const void* lo_all,
                                       void* plane, void* kind, void* qb, void* rb, int L, int N,
                                       int M, int w_pad, void* stream) {
  if (L < 0 || N < 0 || M < 0 || reinterpret_cast<uintptr_t>(plane) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_pad) {
    case 128: return launch<128>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s);
    case 192: return launch<192>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s);
    case 256: return launch<256>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s);
    case 320: return launch<320>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
