// Kernel B2: banded affine forward DP that emits traceback direction planes.
//
// Replaces the JAX package's Pallas TPU kernel
// ont_tcrconsensus_tpu/ops/pileup_pallas.py:61 `_forward_kernel` (driven by
// `forward_planes_pallas`, :221). Semantics are those of ops/pileup.py
// `_forward_banded` at each lane's diagonal offset (the band centre; 0 for
// every lane when no offsets are given, as on the polish path), cell for
// cell, including cells outside the band's valid region: per cell one u16
// `tdir | fjump << 4` (the packed plane `_forward_batch` returns and the
// traceback consumes), where tdir bits 0-1 are the tmp choice (0 diag, 1
// E, 3 fresh), bit 2 the diag-stop flag, bit 3 the E-opened flag, and fjump
// is the ref-gap run length when H chose F (else 0). Per lane the best (score, row, slot)
// follows the sequential tie-break, and is (0, -1, 0) when nothing scores
// above 0.
//
// Design. One warp per lane (subread vs its cluster's draft), the band
// lane-contiguous (dp_common.cuh): NS = W / 32 slots a thread, H and E in
// registers. Per row: E's open-vs-extend at the source slot and one shuffle
// of (value, opened bit) down the band; tmp and its direction; F as the
// lane's local carry, one Kogge-Stone scan of packed keys across the warp,
// the winner's gap length by one indexed shuffle and a second pass over the
// lane's slots; a per-lane running best (score and row * 512 + slot). Each
// thread writes its NS contiguous u16 cells of a row as one 32-bit (W = 64)
// or 64-bit (W = 128) store, so a warp's row is one coalesced 128- or
// 256-byte segment. Rows past the read's end are a function of the bases
// alone: from row rlen + 1 on, H and E are NEG in every slot, no F can
// open, and the plane is the fresh-start direction of each cell, which a
// second loop writes without the DP. At W = 64 both row loops are unrolled
// (two slots a thread leave the per-row work a large share). The TPU
// kernel's two-reads-per-128-lanes packing, 128-aligned loads and host-side
// pre-shifted drafts are layout choices for the TPU and have no
// counterpart here; any L is accepted. An offset moves the lane's reference
// window: slot b of row i reads ref[i + off - W/2 + b], PAD outside
// [0, Lr) (ref_base, for the slots and for the base read a row ahead), and
// a cell is valid where that index lies in [0, ref_len).
//
// Bound on the H100: operations. The planes are 2 bytes per cell written
// once (2 * N * L * W bytes), against the 45 int32 operations a cell of a
// read's rows needs and the 9 a cell past its end (chip_smoke.py itemizes
// them). This design adds the lane's local F pass (4 operations a slot),
// the band shift's register moves and, per lane and row, the scan's keys
// and decoding (chip_smoke.py `PILEUP_DESIGN`); its shuffles are 9 a
// lane-row (E 2, scan 6, gap 1), 4.5 a cell at W = 64. On the card the
// per-cell arithmetic, not the scan, takes most of the time: a build whose
// F carry stays in the lane (no scan shuffles) is only somewhat faster.
#include "dp_common.cuh"

namespace {

using namespace dp;

template <int NS>
__device__ __forceinline__ void store_row(uint16_t* row, const int (&cell)[NS]) {
  if constexpr (NS == 2) {
    *reinterpret_cast<uint32_t*>(row) = (uint32_t)cell[0] | ((uint32_t)cell[1] << 16);
  } else {
    static_assert(NS == 4, "B2 takes W = 64 or 128");
    uint2 v;
    v.x = (uint32_t)cell[0] | ((uint32_t)cell[1] << 16);
    v.y = (uint32_t)cell[2] | ((uint32_t)cell[3] << 16);
    *reinterpret_cast<uint2*>(row) = v;
  }
}

template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pileup_forward_kernel(const uint8_t* __restrict__ reads, const int32_t* __restrict__ read_lens,
                      const uint8_t* __restrict__ refs, const int32_t* __restrict__ ref_lens,
                      const int32_t* __restrict__ offs, int32_t* __restrict__ best_out,
                      uint16_t* __restrict__ planes,
                      int N, int L, int Lr, int match, int mismatch, int gap_open, int gap_ext) {
  constexpr int W = NS * 32;
  constexpr int c = W / 2;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const uint8_t* read = reads + (size_t)n * L;
  const uint8_t* ref = refs + (size_t)n * Lr;
  const int b0 = lane * NS;  // this lane's first band slot
  uint16_t* out = planes + (size_t)n * L * W + b0;
  const int rlen = read_lens[n];
  const int tlen = ref_lens[n];
  const int off = offs != nullptr ? offs[n] : 0;
  const int jb = off - c + b0;  // ref index of slot b0 in row 0
  const int go_ge = gap_open + gap_ext;
  // the band's last slot reads H = E = NEG from beyond the band
  const bool open_fill = kNeg - go_ge >= kNeg - gap_ext;
  const int e_fill = open_fill ? kNeg - go_ge : kNeg - gap_ext;

  int H[NS], E[NS], tb[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    H[k] = E[k] = kNeg;
    tb[k] = ref_code(ref_base(ref, jb + k - 1, Lr));
  }
  int bs = 0, bkey = 0x7fffffff;

  // rows of the read, and the one after its end (its tdir still sees the
  // read's last row)
  const int n_rows = max(0, min(L, rlen + 1));
  // unrolled by two at W = 64 (two slots a lane: the per-row work is a
  // large share), not at W = 128, where the measured time rose
  constexpr int kDpUnroll = NS == 2 ? 2 : 1;
  constexpr int kPadUnroll = NS == 2 ? 4 : 1;
  int rnext = L > 0 ? read[0] : 0;
  int tnext = ref_base(ref, jb + NS - 1, Lr);
  int i = 0;
#pragma unroll kDpUnroll
  for (; i < n_rows; ++i) {
    const int rbase = read_code(rnext);
    slide<NS>(tb, ref_code(tnext));
    if (i + 1 < L) rnext = read[i + 1];
    tnext = ref_base(ref, i + 1 + jb + NS - 1, Lr);
    const bool row_ok = i < rlen;

    // E from the previous row's slot b+1, open-vs-extend decided at the
    // source slot and shifted with its plane bit
    int Eo[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int o = H[k] - go_ge;
      const int e = E[k] - gap_ext;
      Eo[k] = o >= e ? kEOpenBit : 0;
      E[k] = max(o, e);
    }
    shift_up<NS>(E, e_fill, lane);
    shift_up<NS>(Eo, open_fill ? kEOpenBit : 0, lane);

    // tmp and its direction, into H
    const int j0 = i + jb;
    int cell[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = j0 + k;
      const bool valid = row_ok && (unsigned)j < (unsigned)tlen;
      const bool is_match = tb[k] == rbase;
      const bool fresh = H[k] < 0;
      int t = (fresh ? 0 : H[k]) + (is_match ? match : -mismatch);
      int d = fresh ? kDiag | kDiagStopBit : kDiag;  // diag-stop on a fresh predecessor
      if (E[k] > t) { t = E[k]; d = kEGap; }
      if (t < 0) { t = 0; d = kFresh; }
      H[k] = valid ? t : kNeg;
      cell[k] = d | Eo[k];
    }

    // F: the lane's local carry, the scan, then F over the lane's slots
    int lv = H[0], lg = 0;
#pragma unroll
    for (int k = 1; k < NS; ++k) {
      const int cand = lv - gap_ext;
      const bool take = cand > H[k];
      lv = take ? cand : H[k];
      lg = take ? lg + 1 : 0;
    }
    const int z = scan_key<NS>(lv, gap_ext, lane);
    const int zx = __shfl_up_sync(kFull, z, 1);
    const int src = key_lane(zx);
    int rg = from_lane(lg, src) + (lane - 1 - src) * NS;
    int rv = key_value<NS>(zx, gap_ext, lane - 1);
    if (lane == 0) { rv = kNeg; rg = 0; }  // the band's edge: nothing to the left
    const int row_key = (i << kSlotBits) + b0;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int t = H[k];
      const bool valid = row_ok && (unsigned)(j0 + k) < (unsigned)tlen;
      const int f = rv - go_ge;
      const bool take_f = f > t;
      H[k] = valid ? (take_f ? f : t) : kNeg;
      E[k] = valid ? E[k] : kNeg;
      cell[k] |= take_f ? ((rg + 1) & 0xff) << kJumpShift : 0;
      const int cand = rv - gap_ext;
      const bool take = cand > t;
      rv = take ? cand : t;
      rg = take ? rg + 1 : 0;
      if (H[k] > bs) { bs = H[k]; bkey = row_key + k; }
    }
    store_row<NS>(out + (size_t)i * W, cell);
  }
  // rows after that: H and E stay NEG, E opens from the band's fill, the
  // diagonal starts fresh and no F beats a NEG tmp
  const int e_dir = open_fill ? kEOpenBit : 0;
#pragma unroll kPadUnroll
  for (; i < L; ++i) {
    const int rbase = read_code(rnext);
    slide<NS>(tb, ref_code(tnext));
    if (i + 1 < L) rnext = read[i + 1];
    tnext = ref_base(ref, i + 1 + jb + NS - 1, Lr);
    int cell[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int t = tb[k] == rbase ? match : -mismatch;
      const int d = e_fill > t ? (e_fill < 0 ? kFresh : kEGap)
                               : (t < 0 ? kFresh : kDiag | kDiagStopBit);
      cell[k] = d | e_dir;
    }
    store_row<NS>(out + (size_t)i * W, cell);
  }

  int s = bs, key = bkey;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, s, d);
    const int key2 = __shfl_xor_sync(kFull, key, d);
    if (better(s2, key2, s, key)) { s = s2; key = key2; }
  }
  if (lane == 0) {
    const bool aligned = s > 0;
    best_out[(size_t)n * 3 + 0] = aligned ? s : 0;
    best_out[(size_t)n * 3 + 1] = aligned ? key >> kSlotBits : -1;
    best_out[(size_t)n * 3 + 2] = aligned ? key & ((1 << kSlotBits) - 1) : 0;
  }
}

template <int NS>
void launch(const void* reads, const void* read_lens, const void* refs, const void* ref_lens,
            const void* offs, void* best, void* planes, int N, int L, int Lr, int match,
            int mismatch, int gap_open, int gap_ext, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  pileup_forward_kernel<NS><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(read_lens),
      static_cast<const uint8_t*>(refs), static_cast<const int32_t*>(ref_lens),
      static_cast<const int32_t*>(offs), static_cast<int32_t*>(best),
      static_cast<uint16_t*>(planes), N, L, Lr, match, mismatch, gap_open, gap_ext);
}

}  // namespace

// reads (N, L) u8, refs (N, Lr) u8, lens (N,) i32, offs (N,) i32 band
// centres or null (0 for every lane); best (N, 3) i32 and planes (N, L, W)
// u16 out. Returns cudaErrorInvalidValue, launching
// nothing, for a band width it is not built for or scoring its scan keys
// cannot hold (`scores_fit`: the one check of that limit); else
// cudaGetLastError() after the launch.
extern "C" int pileup_forward_launch(const void* reads, const void* read_lens, const void* refs,
                                     const void* ref_lens, const void* offs, void* best,
                                     void* planes,
                                     int N, int L, int Lr, int W, int match, int mismatch,
                                     int gap_open, int gap_ext, void* stream) {
  if (N <= 0) return 0;
  if (!scores_fit(L, W, match, mismatch, gap_open, gap_ext))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: launch<2>(reads, read_lens, refs, ref_lens, offs, best, planes, N, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 128: launch<4>(reads, read_lens, refs, ref_lens, offs, best, planes, N, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
