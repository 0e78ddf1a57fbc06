// Kernel B2: banded affine forward DP that emits traceback direction planes.
//
// Replaces the JAX package's Pallas TPU kernel
// ont_tcrconsensus_tpu/ops/pileup_pallas.py:61 `_forward_kernel` (driven by
// `forward_planes_pallas`, :221). Semantics are those of ops/pileup.py
// `_forward_banded` at diagonal offset 0, cell for cell, including cells
// outside the band's valid region: per cell one u16 `tdir | fjump << 4`
// (the packed plane `_forward_batch` returns and the traceback consumes),
// where tdir bits 0-1 are the tmp choice (0 diag, 1 E, 3 fresh), bit 2 the
// diag-stop flag, bit 3 the E-opened flag, and fjump is the ref-gap run
// length when H chose F (else 0). Per lane the best (score, row, slot)
// follows the sequential tie-break, and is (0, -1, 0) when nothing scores
// above 0.
//
// Design. One warp per lane (subread vs its cluster's draft); the W = 32 *
// NS band slots spread over the warp's lanes, the DP carry (H, E and the
// per-slot best) in registers, the ref-gap cascade as warp-shuffle
// doubling (dp_common.cuh). Every row's W plane cells are stored straight
// to the (N, L, W) output by the warp's 32 lanes on consecutive addresses.
// The TPU kernel's two-reads-per-128-lanes packing, 128-aligned loads and
// host-side pre-shifted drafts are layout choices for the TPU and have no
// counterpart here; any L is accepted.
//
// Bound on the H100: operations. The planes are 2 bytes per cell written
// once (2 * N * L * W bytes), against the 45 int32 operations a cell the
// function needs (chip_smoke.py itemizes them; F counted as the sequential
// max-plus, as in sw_banded.cu). This design spends 5 operations per
// doubling step instead, 70 a cell at W = 64, and 14 band shifts a cell,
// each 2 - 1/NS shuffles a slot (21 a cell at W = 64), whose rate (32 a
// clock per SM) sets the design's own floor. Every row of the padded
// width is computed because the planes of every row are part of the
// output.
#include "dp_common.cuh"

namespace {

using namespace dp;

template <int NS, int S>
__device__ __forceinline__ void cascade(int (&g)[NS], int (&gap)[NS], int gap_ext, int lane) {
  if constexpr (S < NS * 32) {
    int cg[NS], t[NS];
    shift_right<NS, S>(g, cg, kNeg, lane);
    shift_right<NS, S>(gap, t, 0, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int cand = cg[k] - gap_ext * S;
      const bool take = cand > g[k];
      g[k] = take ? cand : g[k];
      gap[k] = take ? t[k] + S : gap[k];
    }
    cascade<NS, 2 * S>(g, gap, gap_ext, lane);
  }
}

template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pileup_forward_kernel(const uint8_t* __restrict__ reads, const int32_t* __restrict__ read_lens,
                      const uint8_t* __restrict__ refs, const int32_t* __restrict__ ref_lens,
                      int32_t* __restrict__ best_out, uint16_t* __restrict__ planes,
                      int N, int L, int Lr, int match, int mismatch, int gap_open, int gap_ext) {
  constexpr int W = NS * 32;
  constexpr int c = W / 2;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const uint8_t* read = reads + (size_t)n * L;
  const uint8_t* ref = refs + (size_t)n * Lr;
  uint16_t* out = planes + (size_t)n * L * W;
  const int rlen = read_lens[n];
  const int tlen = ref_lens[n];
  const int go_ge = gap_open + gap_ext;
  // the band's last slot reads H = E = NEG from beyond the band
  const bool open_fill = kNeg - go_ge >= kNeg - gap_ext;
  const int e_fill = open_fill ? kNeg - go_ge : kNeg - gap_ext;

  int H[NS], E[NS], bH[NS], bRow[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    H[k] = E[k] = kNeg;
    bH[k] = 0;
    bRow[k] = -1;
  }

  for (int i = 0; i < L; ++i) {
    const int rbase = read[i];
    // E from the previous row's slot b+1, open-vs-extend decided at the
    // source slot and shifted with its flag
    int sE[NS], sOpen[NS], En[NS], Eopen[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int o = H[k] - go_ge;
      const int e = E[k] - gap_ext;
      sOpen[k] = o >= e;
      sE[k] = sOpen[k] ? o : e;
    }
    shift_up<NS>(sE, En, e_fill, lane);
    shift_up<NS>(sOpen, Eopen, open_fill ? 1 : 0, lane);

    int tmp[NS], tdir[NS], g[NS], gap[NS];
    bool valid[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = i - c + k * 32 + lane;
      valid[k] = j >= 0 && j < tlen && i < rlen;
      const int tb = (j >= 0 && j < Lr) ? (int)ref[j] : kPad;
      const bool is_match = tb == rbase && rbase < 4 && tb < 4;
      const bool fresh = H[k] < 0;
      int t = (fresh ? 0 : H[k]) + (is_match ? match : -mismatch);
      int d = fresh ? kDiag | kDiagStopBit : kDiag;  // diag-stop on a fresh predecessor
      if (En[k] > t) { t = En[k]; d = kEGap; }
      if (t < 0) { t = 0; d = kFresh; }
      tmp[k] = valid[k] ? t : kNeg;
      tdir[k] = d | (Eopen[k] ? kEOpenBit : 0);
      g[k] = tmp[k];
      gap[k] = 0;
    }
    cascade<NS, 1>(g, gap, gap_ext, lane);
    int F[NS], jump[NS];
    shift_right<NS, 1>(g, F, kNeg, lane);
    shift_right<NS, 1>(gap, jump, 0, lane);
    uint16_t* row = out + (size_t)i * W;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int f = F[k] - go_ge;
      const bool take_f = f > tmp[k];
      H[k] = valid[k] ? (take_f ? f : tmp[k]) : kNeg;
      E[k] = valid[k] ? En[k] : kNeg;
      const int fjump = take_f ? ((jump[k] + 1) & 0xff) : 0;
      row[k * 32 + lane] = static_cast<uint16_t>(tdir[k] | (fjump << kJumpShift));
      if (H[k] > bH[k]) { bH[k] = H[k]; bRow[k] = i; }
    }
  }

  int s = bH[0], r = bRow[0], b = lane;
#pragma unroll
  for (int k = 1; k < NS; ++k) {
    if (better(bH[k], bRow[k], k * 32 + lane, s, r, b)) { s = bH[k]; r = bRow[k]; b = k * 32 + lane; }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, s, d);
    const int r2 = __shfl_xor_sync(kFull, r, d);
    const int b2 = __shfl_xor_sync(kFull, b, d);
    if (better(s2, r2, b2, s, r, b)) { s = s2; r = r2; b = b2; }
  }
  if (lane == 0) {
    const bool aligned = s > 0;
    best_out[(size_t)n * 3 + 0] = aligned ? s : 0;
    best_out[(size_t)n * 3 + 1] = aligned ? r : -1;
    best_out[(size_t)n * 3 + 2] = aligned ? b : 0;
  }
}

template <int NS>
void launch(const void* reads, const void* read_lens, const void* refs, const void* ref_lens,
            void* best, void* planes, int N, int L, int Lr, int match, int mismatch,
            int gap_open, int gap_ext, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  pileup_forward_kernel<NS><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(read_lens),
      static_cast<const uint8_t*>(refs), static_cast<const int32_t*>(ref_lens),
      static_cast<int32_t*>(best), static_cast<uint16_t*>(planes),
      N, L, Lr, match, mismatch, gap_open, gap_ext);
}

}  // namespace

// reads (N, L) u8, refs (N, Lr) u8, lens (N,) i32; best (N, 3) i32 and
// planes (N, L, W) u16 out. Returns cudaGetLastError() after the launch.
extern "C" int pileup_forward_launch(const void* reads, const void* read_lens, const void* refs,
                                     const void* ref_lens, void* best, void* planes,
                                     int N, int L, int Lr, int W, int match, int mismatch,
                                     int gap_open, int gap_ext, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: launch<2>(reads, read_lens, refs, ref_lens, best, planes, N, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 128: launch<4>(reads, read_lens, refs, ref_lens, best, planes, N, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
