// Kernel B3: the polish traceback through kernel B2's direction planes into
// the pileup columns.
//
// Replaces the JAX package's device program
// ont_tcrconsensus_tpu/ops/pileup.py:297 `_traceback_batch`, a jitted
// `lax.scan` (not a Pallas kernel) that runs fused with the forward and the
// vote in one round program. Semantics are those of the port's plain
// ops/pileup.py `_traceback_steps`, bit for bit: from each lane's best cell
// (score, row, slot) it walks the packed u16 planes `tdir | fjump << 4` with
// the scan's seven scalars of state (i, b, mode, pending, done, rstart,
// fstart) and fills base_at, ins_cnt, ins_base and pos_at (N, out_len) and
// the spans (N, 4) = [read_start, read_end, ref_start, ref_end). Each lane's
// band centre is its diagonal offset (`offs`, 0 for every lane when null, as
// on the polish path): cell (i, b) lies over draft column i + off - W/2 + b.
//
// Design. One warp per lane. The warp first writes its lane's whole output
// row with the fill values (UNCOVERED, 0, 0, -1), coalesced, so the wrapper
// launches nothing else. The walk then reads its cells from shared memory:
// a lane's rows are contiguous in B2's (N, L, W) planes and the walk only
// moves up a row (diagonal, insertion) or stays in it (deletion), so the
// warp stages the chunk of kRows rows below the current one, with their read
// bases, into a double buffer (csrc/staging.cuh) as soon as the walk enters
// the current chunk, which lasts at least kRows steps. All 32 threads run
// the walk in step (each reads the same shared cell: a broadcast), so when
// to stage the next chunk is decided alike in every thread. Where the scan
// logs every move and scatters the log afterwards, the walk writes its
// lane's columns as it goes, into the chunk's column slots in shared memory
// (slot j0 - j, j0 the column the chunk starts in), which the 32 threads
// write out to the row as the walk leaves the chunk: a store to device
// memory inside the walk's chain would hold up every step. It keeps the
// scatter's equivalences:
// - a draft column j is set at most once a walk: j = i + off - W/2 + b
//   falls by one on every deletion and diagonal step and stays on an
//   insertion, so the columns set are distinct. A deletion sets DELETION
//   (4); a diagonal step over a known base (code < 4) sets the base and
//   pos_at = i;
// - ins_cnt[j] counts the insertion steps at j over known bases: they are
//   consecutive steps (only an insertion keeps j), so the walk counts the
//   run in a register and stores the count, never loading it back; and
//   ins_base[j] is the base of the LATEST such step (the scan's
//   scatter-max of t * 4 + base picks the largest t): a plain overwrite;
// - a step whose j lies outside [0, out_len) writes nothing (JAX's
//   mode="drop", its j_ok): its chunk slot, counted from the chunk's first
//   column, is written but never stored to the row. With an offset j may
//   start below 0 or past out_len, and the slots stay relative to j0;
// - a lane that starts done (score <= 0 or row < 0) writes only its fill
//   values and its spans.
// A walk stops when its lane is done or after L + out_len steps, the scan's
// static length; nothing waits on another lane.
//
// Bound on the H100. The function moves one 32-byte sector of planes a
// step and its columns once, microseconds at 3.35 TB/s, but each step's
// address depends on the cell the last step read. Staged, that chain is a
// shared-memory load and the step's arithmetic a step; the staged bytes
// are every walked row whole (kRows * W * 2 bytes a chunk). This design's
// floor is the larger of those bytes over the HBM rate and the longest
// walk's steps times one staged step of a lone lane (chip_smoke.py prints
// both beside the function's bound).
#include "dp_common.cuh"
#include "staging.cuh"

namespace {

using namespace dp;

constexpr int kRows = 32;  // rows a chunk: one read base a thread
constexpr int kModeH = 0;
constexpr int kModeE = 1;
constexpr int kModeTmp = 2;
constexpr uint8_t kDeletion = 4;   // ops/pileup.py DELETION
constexpr uint8_t kUncovered = 5;  // ops/pileup.py UNCOVERED

// Lanes (warps) a block: 32 KB of staged rows a block at either width, so
// six blocks share an SM and a 1024-lane tile runs in one wave.
template <int W>
__host__ __device__ constexpr int warps_per_block() { return W == 64 ? 4 : 2; }

// Columns a chunk's walk can reach: each diagonal or insertion step
// consumes one of its kRows rows, and a deletion moves the slot b down one,
// which starts below W and rises only on an insertion, so a chunk moves
// the column j down at most kRows + W times.
template <int W>
__host__ __device__ constexpr int cols_per_chunk() { return kRows + W + 1; }

// kOffs: the launch was given band centres. Without them (the main path)
// the lane's column shift is the constant -W/2 and the walk's code is that
// of a kernel that knows no offsets.
template <int W, bool kOffs>
__global__ void __launch_bounds__(warps_per_block<W>() * 32)
pileup_traceback_kernel(const int32_t* __restrict__ best, const uint16_t* __restrict__ planes,
                        const uint8_t* __restrict__ reads, const int32_t* __restrict__ offs,
                        uint8_t* __restrict__ base_at, int32_t* __restrict__ ins_cnt,
                        uint8_t* __restrict__ ins_base, int32_t* __restrict__ pos_at,
                        int32_t* __restrict__ spans, int N, int L, int out_len) {
  static_assert(kRows == 32, "a chunk's read bases are staged one a thread");
  constexpr int kWarps = warps_per_block<W>();
  constexpr int c = W / 2;
  constexpr int kCols = cols_per_chunk<W>();
  __shared__ __align__(16) uint16_t s_plane[kWarps][2][kRows * W];
  __shared__ uint8_t s_read[kWarps][2][kRows];
  // the chunk's columns j0 - s, s < kCols; slot kCols takes the writes a
  // step does not make
  __shared__ int32_t s_pos[kWarps][kCols + 1];
  __shared__ int32_t s_icnt[kWarps][kCols + 1];
  __shared__ uint8_t s_base[kWarps][kCols + 1];
  __shared__ uint8_t s_ibase[kWarps][kCols + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int score = best[(size_t)n * 3 + 0];
  const int i0 = best[(size_t)n * 3 + 1];
  const int b0 = best[(size_t)n * 3 + 2];
  // draft column of cell (i, b): i + shift + b
  const int shift = (kOffs ? offs[n] : 0) - c;
  const int jend = i0 + shift + b0;
  const size_t row = (size_t)n * out_len;
  for (int k = lane; k < out_len; k += 32) {
    base_at[row + k] = kUncovered;
    ins_cnt[row + k] = 0;
    ins_base[row + k] = 0;
    pos_at[row + k] = -1;
  }
  for (int k = lane; k <= kCols; k += 32) {
    s_base[warp][k] = kUncovered;
    s_icnt[warp][k] = 0;
    s_ibase[warp][k] = 0;
    s_pos[warp][k] = -1;
  }
  __syncwarp();

  const uint16_t* lane_planes = planes + (size_t)n * L * W;
  const uint8_t* read = reads + (size_t)n * L;
  int i = i0, b = b0, mode = kModeH, pending = 0;
  bool done = score <= 0 || i0 < 0 || L <= 0;
  int rstart = i0 + 1, fstart = jend + 1;
  int ins_j = -1, ins_n = 0, ins_b = 0;  // the insertion run being counted
  const int T = L + out_len;
  int t = 0;
  if (!done) {
    // chunk k holds rows [lo, hi] = [top - (k + 1) * kRows + 1, top - k * kRows],
    // those >= 0 staged from buffer index 0
    int hi = min(i0, L - 1);
    int lo = hi - kRows + 1;
    int j0 = jend;  // the column the chunk starts in
    staging::stage_rows(s_plane[warp][0], lane_planes, max(lo, 0), hi, W * 2, lane);
    staging::commit();
    {
      const int r = max(lo, 0) + lane;
      s_read[warp][0][lane] = r <= hi ? read[r] : 0;
    }
    for (int k = 0; !done && t < T; ++k) {
      const int buf = k & 1;
      const int nhi = hi - kRows, nlo = lo - kRows;
      staging::stage_rows(s_plane[warp][buf ^ 1], lane_planes, max(nlo, 0), nhi, W * 2, lane);
      staging::commit();
      const int nr = max(nlo, 0) + lane;
      const uint8_t next_read = nr <= nhi ? read[nr] : 0;
      staging::wait<1>();
      __syncwarp();
      const uint16_t* sp = s_plane[warp][buf];
      const uint8_t* sr = s_read[warp][buf];
      const int base = max(lo, 0);
      for (; t < T && !done; ++t) {
        const int ci = min(max(i, 0), L - 1);
        if (ci < lo) break;  // the walk enters the next chunk
        const int jrow = i + shift + b;
        const int cb = min(max(b, 0), W - 1);
        const int p = sp[(ci - base) * W + cb];
        const int d = p & 15;
        const int m = p >> kJumpShift;

        const bool in_del = pending > 0;
        const bool start_del = !in_del && mode == kModeH && m > 0;
        const bool do_del = in_del || start_del;
        const int new_pending = in_del ? pending - 1 : (start_del ? m - 1 : 0);
        const int choice = mode == kModeE ? kEGap : (d & 3);
        const bool is_diag = !do_del && choice == kDiag;
        const bool is_egap = !do_del && choice == kEGap;
        const bool is_fresh = !do_del && choice == kFresh;

        // the step's columns, into the chunk's slots; the walk never waits
        // on them
        const int slot = min(j0 - jrow, kCols);  // below kCols for B2's rows (< L)
        const int rb = sr[ci - base];
        const bool known = rb < 4;
        const bool set_pos = is_diag && known;
        s_base[warp][do_del || set_pos ? slot : kCols] = do_del ? kDeletion : (uint8_t)rb;
        s_pos[warp][set_pos ? slot : kCols] = ci;
        const bool set_ins = is_egap && known;
        ins_n = set_ins ? (jrow == ins_j ? ins_n + 1 : 1) : ins_n;
        ins_j = set_ins ? jrow : ins_j;
        ins_b = set_ins ? rb : ins_b;
        s_icnt[warp][set_ins ? slot : kCols] = ins_n;
        s_ibase[warp][set_ins ? slot : kCols] = (uint8_t)rb;

        const bool e_open = (d & kEOpenBit) != 0;
        const bool diag_stop = is_diag && (d & kDiagStopBit) != 0;
        const int ni = (is_diag || is_egap) ? i - 1 : i;
        const int nb = do_del ? b - 1 : (is_egap ? b + 1 : b);
        if (is_diag || is_egap) rstart = i;
        if (is_diag || do_del) fstart = jrow;
        mode = do_del ? kModeTmp : ((is_egap && !e_open) ? kModeE : kModeH);
        pending = new_pending;
        done = is_fresh || diag_stop || ni < 0 || nb < 0 || nb >= W;
        i = ni;
        b = nb;
      }
      __syncwarp();
      // the columns the chunk walked, [jc, j0], out and back to the fill
      // values; the open column jc keeps its insertion run in slot 0
      const int jc = i + shift + b;
      for (int k = lane; k <= min(j0 - jc, kCols - 1); k += 32) {
        const int col = j0 - k;
        if (col >= 0 && col < out_len) {
          base_at[row + col] = s_base[warp][k];
          ins_cnt[row + col] = s_icnt[warp][k];
          ins_base[row + col] = s_ibase[warp][k];
          pos_at[row + col] = s_pos[warp][k];
        }
        s_base[warp][k] = kUncovered;
        s_icnt[warp][k] = 0;
        s_ibase[warp][k] = 0;
        s_pos[warp][k] = -1;
      }
      if (lane == 0 && ins_j == jc) {
        s_icnt[warp][0] = ins_n;
        s_ibase[warp][0] = (uint8_t)ins_b;
      }
      j0 = jc;
      s_read[warp][buf ^ 1][lane] = next_read;
      hi = nhi;
      lo = nlo;
    }
    staging::wait<0>();  // no copy may land after the block's shared memory is reused
  }
  if (lane == 0) {
    int32_t* span = spans + (size_t)n * 4;
    span[0] = rstart;
    span[1] = i0 + 1;
    span[2] = fstart;
    span[3] = jend + 1;
  }
}

template <int W>
void launch(const void* best, const void* planes, const void* reads, const void* offs,
            void* base_at, void* ins_cnt, void* ins_base, void* pos_at, void* spans, int N, int L,
            int out_len, cudaStream_t stream) {
  constexpr int kWarps = warps_per_block<W>();
  const dim3 grid((N + kWarps - 1) / kWarps);
  const auto kernel = offs != nullptr ? pileup_traceback_kernel<W, true>
                                      : pileup_traceback_kernel<W, false>;
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(best), static_cast<const uint16_t*>(planes),
      static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(offs),
      static_cast<uint8_t*>(base_at), static_cast<int32_t*>(ins_cnt),
      static_cast<uint8_t*>(ins_base), static_cast<int32_t*>(pos_at),
      static_cast<int32_t*>(spans), N, L, out_len);
}

}  // namespace

// best (N, 3) i32, planes (N, L, W) u16 (B2's int16 tensor read unsigned,
// 16-byte aligned), reads (N, L) u8, offs (N,) i32 band centres or null (0
// for every lane) in; base_at (N, out_len) u8, ins_cnt i32, ins_base u8,
// pos_at i32 and spans (N, 4) i32 out, every element written here. Returns
// cudaErrorInvalidValue, launching nothing, for a band width it is not
// built for, a negative length or unaligned planes; else cudaGetLastError()
// after the launch.
extern "C" int pileup_traceback_launch(const void* best, const void* planes, const void* reads,
                                       const void* offs, void* base_at, void* ins_cnt,
                                       void* ins_base, void* pos_at, void* spans, int N, int L,
                                       int W, int out_len, void* stream) {
  if (N <= 0) return 0;
  if (L < 0 || out_len < 0 || reinterpret_cast<uintptr_t>(planes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: launch<64>(best, planes, reads, offs, base_at, ins_cnt, ins_base, pos_at, spans, N, L, out_len, s); break;
    case 128: launch<128>(best, planes, reads, offs, base_at, ins_cnt, ins_base, pos_at, spans, N, L, out_len, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
