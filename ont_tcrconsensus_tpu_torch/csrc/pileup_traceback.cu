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
// the spans (N, 4) = [read_start, read_end, ref_start, ref_end).
//
// Design. One thread per lane, 32 lanes a block so a 1024-lane tile spreads
// over 32 SMs. Each step reads one plane cell. Where the scan logs every
// move and scatters the log afterwards, the thread writes its own rows as it
// walks (each lane owns its rows: no atomics), keeping the scatter's
// equivalences:
// - a draft column j is set at most once a walk: j = i - W/2 + b falls by
//   one on every deletion and diagonal step and stays on an insertion, so
//   the columns set are distinct. A deletion sets DELETION (4); a diagonal
//   step over a known base (code < 4) sets the base and pos_at = i;
// - ins_cnt[j] counts the insertion steps at j over known bases, and
//   ins_base[j] is the base of the LATEST such step (the scan's scatter-max
//   of t * 4 + base picks the largest t): here a plain overwrite;
// - a step whose j lies outside [0, out_len) writes nothing (JAX's
//   mode="drop"); a lane that starts done (score <= 0 or row < 0) writes
//   only its spans.
// The wrapper (ops/traceback_kernel.py) fills the columns first (UNCOVERED,
// 0, 0, -1). A thread stops when its lane is done or after L + out_len
// steps, the scan's static length; nothing waits on another lane.
//
// Bound on the H100: latency. The function moves one 32-byte sector of
// planes a step and its columns once, which takes microseconds at 3.35
// TB/s, but each step's address depends on the cell the last step read, so
// a lane's walk is a chain of dependent device-memory loads, and the
// longest walk's steps times one load's latency is the floor of this design
// (chip_smoke.py prints both). Staging band rows in shared memory, or
// fusing the walk into B2 while its planes are on chip, is later work.
#include "dp_common.cuh"

namespace {

using namespace dp;

constexpr int kLanesPerBlock = 32;
constexpr int kModeH = 0;
constexpr int kModeE = 1;
constexpr int kModeTmp = 2;
constexpr uint8_t kDeletion = 4;  // ops/pileup.py DELETION

template <int W>
__global__ void __launch_bounds__(kLanesPerBlock)
pileup_traceback_kernel(const int32_t* __restrict__ best, const uint16_t* __restrict__ planes,
                        const uint8_t* __restrict__ reads, uint8_t* __restrict__ base_at,
                        int32_t* __restrict__ ins_cnt, uint8_t* __restrict__ ins_base,
                        int32_t* __restrict__ pos_at, int32_t* __restrict__ spans, int N, int L,
                        int out_len) {
  const int n = blockIdx.x * kLanesPerBlock + threadIdx.x;
  if (n >= N) return;
  constexpr int c = W / 2;
  const int score = best[(size_t)n * 3 + 0];
  const int i0 = best[(size_t)n * 3 + 1];
  const int b0 = best[(size_t)n * 3 + 2];
  const int jend = i0 - c + b0;
  const uint16_t* lane_planes = planes + (size_t)n * L * W;
  const uint8_t* read = reads + (size_t)n * L;
  const size_t row = (size_t)n * out_len;

  int i = i0, b = b0, mode = kModeH, pending = 0;
  bool done = score <= 0 || i0 < 0;
  int rstart = i0 + 1, fstart = jend + 1;
  const int T = L + out_len;
  for (int t = 0; t < T && !done; ++t) {
    const int jrow = i - c + b;
    const int ci = min(max(i, 0), L - 1);
    const int cb = min(max(b, 0), W - 1);
    const int p = lane_planes[(size_t)ci * W + cb];
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

    if (jrow >= 0 && jrow < out_len) {
      if (do_del) {
        base_at[row + jrow] = kDeletion;
      } else if (is_diag || is_egap) {
        const int rb = read[ci];
        if (rb < 4) {
          if (is_diag) {
            base_at[row + jrow] = (uint8_t)rb;
            pos_at[row + jrow] = ci;
          } else {
            ins_cnt[row + jrow] += 1;
            ins_base[row + jrow] = (uint8_t)rb;
          }
        }
      }
    }

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
  int32_t* span = spans + (size_t)n * 4;
  span[0] = rstart;
  span[1] = i0 + 1;
  span[2] = fstart;
  span[3] = jend + 1;
}

template <int W>
void launch(const void* best, const void* planes, const void* reads, void* base_at,
            void* ins_cnt, void* ins_base, void* pos_at, void* spans, int N, int L, int out_len,
            cudaStream_t stream) {
  const dim3 grid((N + kLanesPerBlock - 1) / kLanesPerBlock);
  pileup_traceback_kernel<W><<<grid, kLanesPerBlock, 0, stream>>>(
      static_cast<const int32_t*>(best), static_cast<const uint16_t*>(planes),
      static_cast<const uint8_t*>(reads), static_cast<uint8_t*>(base_at),
      static_cast<int32_t*>(ins_cnt), static_cast<uint8_t*>(ins_base),
      static_cast<int32_t*>(pos_at), static_cast<int32_t*>(spans), N, L, out_len);
}

}  // namespace

// best (N, 3) i32, planes (N, L, W) u16 (B2's int16 tensor read unsigned),
// reads (N, L) u8 in; base_at (N, out_len) u8, ins_cnt i32, ins_base u8,
// pos_at i32, filled by the caller, and spans (N, 4) i32 out. Returns
// cudaErrorInvalidValue, launching nothing, for a band width it is not built
// for or a negative length; else cudaGetLastError() after the launch.
extern "C" int pileup_traceback_launch(const void* best, const void* planes, const void* reads,
                                       void* base_at, void* ins_cnt, void* ins_base,
                                       void* pos_at, void* spans, int N, int L, int W,
                                       int out_len, void* stream) {
  if (N <= 0) return 0;
  if (L < 0 || out_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: launch<64>(best, planes, reads, base_at, ins_cnt, ins_base, pos_at, spans, N, L, out_len, s); break;
    case 128: launch<128>(best, planes, reads, base_at, ins_cnt, ins_base, pos_at, spans, N, L, out_len, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
