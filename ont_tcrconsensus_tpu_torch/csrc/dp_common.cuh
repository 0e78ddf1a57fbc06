// Band primitives shared by the two banded DP kernels (sw_banded.cu,
// pileup_forward.cu).
//
// Layout: lane-contiguous. A band of W slots is split over NW warps of
// 32 * NS slots each; lane l of warp w owns the NS contiguous slots
// w * 32 * NS + l * NS + k, k < NS, in registers k. A one-slot band shift
// is then a register move for NS - 1 of a lane's slots and one shuffle for
// the last (E's source slot b + 1, `shift_up`), where a slot-strided layout
// pays a shuffle pair for every slot.
//
// F, the in-row ref-gap max-plus R[b] = max(tmp[b], R[b-1] - ext) that
// keeps the nearer origin on a tie, is what the JAX package's
// strictly-greater shift-doubling computes: "larger value wins, a tie goes
// to the nearer origin" is associative, and the gap length and any
// channels follow the winning origin. The kernels run it in three steps:
//   1. each lane runs R sequentially over its own NS slots (its local
//      carry: value, gap length, channels at its last slot);
//   2. `scan_key`: a 5-step Kogge-Stone max over the warp of each lane's
//      carry, moved to a common origin by ext * slot and packed with its
//      lane so a tie picks the nearer lane; one more shuffle makes it
//      exclusive, and the winner's gap and channels come from its lane with
//      one indexed shuffle each (`from_lane`; across warps: shared memory);
//   3. each lane runs R again over its slots, started from that carry; this
//      pass yields F[b] = R[b-1] - open - ext for every slot.
// tests/test_torch_f_scan.py models this order in numpy and holds it to the
// JAX package. A lane keeps one running best (score, and row * 512 + slot
// as one key): rows ascend and its slots ascend within a row, so a strict
// > keeps the (score desc, row asc, slot asc) order, and one reduction with
// `better` at the end picks the pair's best cell.
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
// Base codes as the kernels compare them: a read base or a reference base
// of 4 or more (N, pad) never matches anything.
constexpr int kNoReadBase = 254;
constexpr int kNoRefBase = 255;

__device__ __forceinline__ int read_code(int base) { return base < 4 ? base : kNoReadBase; }

// The kernels load a row's new reference base one row ahead and code it
// where the row uses it, so the load's latency stays off the row's chain.
__device__ __forceinline__ int ref_base(const uint8_t* ref, int j, int Lr) {
  return (j >= 0 && j < Lr) ? (int)ref[j] : kPad;
}

__device__ __forceinline__ int ref_code(int base) { return base < 4 ? base : kNoRefBase; }

// x[k] = x[k + 1] along the band, in place: a register move inside the
// lane, lane + 1's first slot into the last, `edge` into lane 31's last.
template <int NS, typename T>
__device__ __forceinline__ void shift_up(T (&x)[NS], T edge, int lane) {
  const T next = __shfl_down_sync(kFull, x[0], 1);
#pragma unroll
  for (int k = 0; k + 1 < NS; ++k) x[k] = x[k + 1];
  x[NS - 1] = lane == 31 ? edge : next;
}

// Ref window of a lane's NS slots, one row down the band: slot k of row i
// reads ref[i + base + k], so a row adds one new base per lane (`next`).
template <int NS>
__device__ __forceinline__ void slide(int (&tb)[NS], int next) {
#pragma unroll
  for (int k = 0; k + 1 < NS; ++k) tb[k] = tb[k + 1];
  tb[NS - 1] = next;
}

// Inclusive scan over the warp of the lanes' local carries, `v` being the
// value at this lane's last slot. Each key is the value moved to lane 0's
// last slot (+ ext * NS * lane), times 32, plus the lane: the max of two
// keys is the larger value where both meet, and on a tie the nearer lane.
// Shuffles from below lane 0 return the lane's own key, which max ignores.
template <int NS>
__device__ __forceinline__ int scan_key(int v, int gap_ext, int lane) {
  int z = (v + gap_ext * NS * lane) * 32 + lane;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) z = max(z, __shfl_up_sync(kFull, z, d));
  return z;
}

// A field of the lane the scan's winner came from.
template <typename T>
__device__ __forceinline__ T from_lane(T x, int src) {
  return __shfl_sync(kFull, x, src);
}

// The value a scan key's carry has at the last slot of lane `at`.
template <int NS>
__device__ __forceinline__ int key_value(int z, int gap_ext, int at) {
  return (z >> 5) - gap_ext * NS * at;
}

__device__ __forceinline__ int key_lane(int z) { return z & 31; }

// A cell's place as one key, row * 2^kSlotBits + slot (W <= 512), so that
// key order is (row asc, slot asc).
constexpr int kSlotBits = 9;

// Lexicographic best over (score desc, key asc): the sequential kernel's
// tie-break (first row that reaches the maximum, then the smallest slot in
// that row).
__device__ __forceinline__ bool better(int s, int key, int s2, int key2) {
  return s > s2 || (s == s2 && key < key2);
}

// The carry scan packs (value + ext * slot) * 32 + lane into an int32. A
// local carry is at least kNeg (-2^24), and at most match per row: with
// non-negative scoring the key fits when match * L + ext * W < 2^26.
inline bool scores_fit(int L, int W, int match, int mismatch, int gap_open, int gap_ext) {
  if (match < 0 || mismatch < 0 || gap_open < 0 || gap_ext < 0) return false;
  return (long long)match * L + (long long)gap_ext * W < (1LL << 26);
}

}  // namespace dp
