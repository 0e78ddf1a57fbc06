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
// Design. One block a read, one thread a band lane (W = 128, 192, 256 or 320
// threads). The fill keeps the previous row in shared memory, double
// buffered, and reads it at lane + shift - 1 (diagonal) and lane + shift
// (up) for any shift the row's band start moves by. The left chain is a
// block-wide exclusive prefix minimum of best - lane: an inclusive warp scan
// of shuffles, each warp's total in shared memory, then each lane folds the
// totals of the warps to its left. Two barriers a row; each row of the
// direction plane (0 diagonal, 1 up, 2 left) is written coalesced to a
// scratch plane (L, N + 1, W) in device memory. After the read's last row,
// lane 0 walks the plane, one cell a step, writing the op log (N + M, L).
// Rows past a read's n are neither filled nor read.
//
// Bound on the H100: the function moves a few bytes a cell at most and
// does some 30 int32 operations a band cell, so its bound is the operations,
// about 0.1 ms at a 512-read tile. This design is bound by latency instead:
// each row of the fill waits on the row before it (two barriers and a
// shuffle scan, with every read of the tile in flight at once), and each
// step of the walk loads the cell the last step chose, a dependent load
// from device memory as in B3. Its floor is the tile's slowest read alone
// (chip_smoke.py prints both). Staging plane rows in shared memory for the
// walk, or packing the plane to 2 bits, is later work.
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr uint8_t kMatch = 0, kSub = 1, kIns = 2, kDel = 3;  // kStop = 4: the wrapper's fill
constexpr unsigned kFull = 0xffffffffu;

template <int W>
__global__ void __launch_bounds__(W)
error_profile_cs_kernel(const uint8_t* __restrict__ qpad, const uint8_t* __restrict__ rpad,
                        const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
                        const int32_t* __restrict__ ws_arr, const int32_t* __restrict__ lo_all,
                        uint8_t* __restrict__ plane, uint8_t* __restrict__ kind,
                        uint8_t* __restrict__ qb, uint8_t* __restrict__ rb, int L, int N,
                        int M) {
  constexpr int kWarps = W / 32;
  __shared__ int rows[2][W];
  __shared__ int warp_min[kWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int wl = lane & 31;
  const int warp = lane >> 5;
  const int n = n_arr[b], m = m_arr[b], ws = ws_arr[b];
  const uint8_t* q = qpad + (size_t)b * N;
  const uint8_t* r = rpad + (size_t)b * M;
  const int32_t* lo = lo_all + (size_t)b * (N + 1);
  uint8_t* ptr = plane + (size_t)b * (N + 1) * W;
  const bool lane_ok = lane < ws;

  // row 0: D[0][j] = j deletions, each a left move
  int lo_prev = lo[0];
  {
    const int js = lo_prev + lane;
    const bool valid = lane_ok && js <= m;
    rows[0][lane] = valid ? js : kBig;
    ptr[lane] = valid ? 2 : 0;
  }
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    const int* prev = rows[(i - 1) & 1];
    const int nlo = lo[i];
    const int src = lane + (nlo - lo_prev) - 1;
    const int diag = (src >= 0 && src < W) ? prev[src] : kBig;
    const int up = (src + 1 >= 0 && src + 1 < W) ? prev[src + 1] : kBig;
    const int js = nlo + lane;
    const bool valid = lane_ok && js <= m;
    const int qi = q[i - 1];
    const int rj = r[min(max(js - 1, 0), M - 1)];
    const int sub = (rj == qi && qi < 4 && rj < 4) ? 0 : 1;  // N bases never match
    const int d = js >= 1 ? diag + sub : kBig;
    const int u = up + 1;
    int best = valid ? min(d, u) : kBig;
    uint8_t p = u < d ? 1 : 0;  // ties prefer the diagonal

    // exclusive prefix min of best - lane over the lanes to the left
    int v = best - lane;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, v, o);
      if (wl >= o) v = min(v, t);
    }
    int excl = __shfl_up_sync(kFull, v, 1);
    if (wl == 31) warp_min[warp] = v;
    __syncthreads();
    if (wl == 0) excl = INT_MAX;
    for (int k = 0; k < warp; ++k) excl = min(excl, warp_min[k]);
    const int left = lane == 0 ? kBig : excl + lane;
    if (left < best && valid) {  // the left chain wins only when strictly better
      best = left;
      p = 2;
    }
    rows[i & 1][lane] = valid ? best : kBig;
    ptr[(size_t)i * W + lane] = valid ? p : 0;
    lo_prev = nlo;
    __syncthreads();
  }

  if (lane != 0) return;
  // the walk, from (n, m) back to (0, 0); kind is STOP from the first step
  // that is not a move on
  int i = n, j = m;
  const int S = N + M;
  for (int s = 0; s < S; ++s) {
    const size_t o = (size_t)s * L + b;
    const uint8_t qc = q[max(i - 1, 0)];
    const uint8_t rc = r[max(j - 1, 0)];
    qb[o] = qc;
    rb[o] = rc;
    const int t = j - lo[i];
    if ((i == 0 && j == 0) || t < 0 || t >= ws) break;  // done, or off the read's band
    const uint8_t p = ptr[(size_t)i * W + t];
    const bool is_diag = i > 0 && j > 0 && p == 0;
    const bool is_up = !is_diag && i > 0 && p == 1;
    // neither diagonal nor up: left while j > 0, else (i > 0, j == 0, p != 1)
    // the tail insertion
    const bool is_left = !is_diag && !is_up && j > 0;
    kind[o] = is_diag ? ((qc == rc && qc < 4) ? kMatch : kSub) : (is_left ? kDel : kIns);
    if (!is_left) --i;
    if (is_diag || is_left) --j;
  }
}

template <int W>
void launch(const void* qpad, const void* rpad, const void* n, const void* m, const void* ws,
            const void* lo_all, void* plane, void* kind, void* qb, void* rb, int L, int N, int M,
            cudaStream_t stream) {
  error_profile_cs_kernel<W><<<L, W, 0, stream>>>(
      static_cast<const uint8_t*>(qpad), static_cast<const uint8_t*>(rpad),
      static_cast<const int32_t*>(n), static_cast<const int32_t*>(m),
      static_cast<const int32_t*>(ws), static_cast<const int32_t*>(lo_all),
      static_cast<uint8_t*>(plane), static_cast<uint8_t*>(kind), static_cast<uint8_t*>(qb),
      static_cast<uint8_t*>(rb), L, N, M);
}

}  // namespace

// qpad (L, N) u8, rpad (L, M) u8, n, m, ws (L,) i32 and lo_all (L, N + 1) i32
// in; plane (L, N + 1, w_pad) u8 scratch; kind, qb, rb (N + M, L) u8 out,
// kind filled with STOP by the caller. Returns cudaErrorInvalidValue,
// launching nothing, for a band width it is not built for or a negative
// size; else cudaGetLastError() after the launch.
extern "C" int error_profile_cs_launch(const void* qpad, const void* rpad, const void* n,
                                       const void* m, const void* ws, const void* lo_all,
                                       void* plane, void* kind, void* qb, void* rb, int L, int N,
                                       int M, int w_pad, void* stream) {
  if (L < 0 || N < 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_pad) {
    case 128: launch<128>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s); break;
    case 192: launch<192>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s); break;
    case 256: launch<256>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s); break;
    case 320: launch<320>(qpad, rpad, n, m, ws, lo_all, plane, kind, qb, rb, L, N, M, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
