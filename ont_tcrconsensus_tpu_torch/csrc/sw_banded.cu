// Kernel B1: batched banded local affine-gap Smith-Waterman, stats only.
//
// Replaces the JAX package's Pallas TPU kernel
// ont_tcrconsensus_tpu/ops/sw_pallas.py:56 `_kernel` (driven by
// `align_banded_pallas`, :190). Semantics are those of
// ops/sw_align.py `align_banded` cell for cell: the same int32 DP, the same
// shift-doubling ref-gap cascade (strictly-greater takes, so ties keep the
// shorter gap), the same four channels (matches, columns, read start, ref
// start), and the same best-cell tie-break (max score, then earliest row,
// then smallest slot; all zero when nothing scores above 0).
//
// Design. One warp per pair; the band's W = 32 * NS slots spread over the
// lanes (NS registers per lane, slot b = k * 32 + lane). The row recurrence
// is sequential, so the warp loops over the read's rows with the whole DP
// carry in registers: nothing but the inputs and one 7-int result per pair
// ever touches device memory. The per-row ref-gap cascade is log2(W)
// max-plus doubling steps done with warp shuffles (dp_common.cuh). The
// E (read-gap) update selects open-vs-extend at the SOURCE slot, so each
// value crosses lanes once per row instead of twice. Per slot the best
// score is kept with its earliest row; one warp reduction at the end picks
// the pair's best cell.
//
// Bound on the H100: operations. The function needs 68 int32 operations a
// cell (chip_smoke.py itemizes them), with F counted as the sequential
// max-plus g[b] = max(tmp[b], g[b-1] - ext), which keeps the nearest origin
// on ties just as the strictly-greater doubling does. This design spends
// 9 operations per doubling step instead, 122 a cell at W = 128, and 41
// band shifts a cell (E, six values per cascade step below 32 slots, the
// final F shift), each 2 - 1/NS shuffles a slot: about 72 shuffles a cell,
// whose rate (32 a clock per SM) sets the design's own floor. Bytes are
// only the reads, the reference (cached) and the results. Rows past the
// read's length cannot change the result and are not computed.
#include "dp_common.cuh"

namespace {

using namespace dp;

template <int NS, int S>
__device__ __forceinline__ void cascade(int (&g)[NS], int (&gm)[NS], int (&gc)[NS],
                                        int (&grs)[NS], int (&gfs)[NS], int (&gap)[NS],
                                        int gap_ext, int lane) {
  if constexpr (S < NS * 32) {
    int cg[NS], t[NS];
    bool take[NS];
    shift_right<NS, S>(g, cg, kNeg, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      cg[k] -= gap_ext * S;
      take[k] = cg[k] > g[k];
    }
    shift_right<NS, S>(gm, t, 0, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) gm[k] = take[k] ? t[k] : gm[k];
    shift_right<NS, S>(gc, t, 0, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) gc[k] = take[k] ? t[k] : gc[k];
    shift_right<NS, S>(grs, t, 0, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) grs[k] = take[k] ? t[k] : grs[k];
    shift_right<NS, S>(gfs, t, 0, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) gfs[k] = take[k] ? t[k] : gfs[k];
    shift_right<NS, S>(gap, t, 0, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      gap[k] = take[k] ? t[k] + S : gap[k];
      g[k] = take[k] ? cg[k] : g[k];
    }
    cascade<NS, 2 * S>(g, gm, gc, grs, gfs, gap, gap_ext, lane);
  }
}

template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_banded_kernel(const uint8_t* __restrict__ reads, const int32_t* __restrict__ read_lens,
                 const uint8_t* __restrict__ refs, const int32_t* __restrict__ ref_lens,
                 const int32_t* __restrict__ offs, int32_t* __restrict__ out,
                 int B, int L, int Lr, int match, int mismatch, int gap_open, int gap_ext) {
  constexpr int W = NS * 32;
  constexpr int c = W / 2;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= B) return;  // the whole warp leaves together
  const uint8_t* read = reads + (size_t)pair * L;
  const uint8_t* ref = refs + (size_t)pair * Lr;
  const int rlen = read_lens[pair];
  const int tlen = ref_lens[pair];
  const int off = offs[pair];
  const int go_ge = gap_open + gap_ext;
  // E value at the band's last slot: shift_up fills H and E with NEG there
  const int e_fill = (kNeg - go_ge >= kNeg - gap_ext) ? kNeg - go_ge : kNeg - gap_ext;

  int H[NS], Hm[NS], Hc[NS], Hrs[NS], Hfs[NS];
  int E[NS], Em[NS], Ec[NS], Ers[NS], Efs[NS];
  int bH[NS], bRow[NS], bm[NS], bc[NS], brs[NS], bfs[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    H[k] = E[k] = kNeg;
    Hm[k] = Hc[k] = Hrs[k] = Hfs[k] = 0;
    Em[k] = Ec[k] = Ers[k] = Efs[k] = 0;
    bH[k] = 0;
    bRow[k] = -1;
    bm[k] = bc[k] = brs[k] = bfs[k] = 0;
  }

  const int n_rows = min(L, rlen);
  for (int i = 0; i < n_rows; ++i) {
    const int rbase = read[i];
    // E: read-consuming gap from (i-1, j), i.e. the previous row's slot
    // b+1. Open-vs-extend is decided at the source slot, then shifted.
    int sE[NS], sM[NS], sC[NS], sRs[NS], sFs[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int o = H[k] - go_ge;
      const int e = E[k] - gap_ext;
      const bool top = o >= e;
      sE[k] = top ? o : e;
      sM[k] = top ? Hm[k] : Em[k];
      sC[k] = top ? Hc[k] : Ec[k];
      sRs[k] = top ? Hrs[k] : Ers[k];
      sFs[k] = top ? Hfs[k] : Efs[k];
    }
    int En[NS], Enm[NS], Enc[NS], Enrs[NS], Enfs[NS];
    shift_up<NS>(sE, En, e_fill, lane);
    shift_up<NS>(sM, Enm, 0, lane);
    shift_up<NS>(sC, Enc, 0, lane);
    shift_up<NS>(sRs, Enrs, 0, lane);
    shift_up<NS>(sFs, Enfs, 0, lane);

    int tmp[NS], tm[NS], tc[NS], trs[NS], tfs[NS], gap[NS];
    bool valid[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      Enc[k] += 1;  // one more (gap) column
      const int j = i + off - c + k * 32 + lane;
      valid[k] = j >= 0 && j < tlen;
      const int tb = (j >= 0 && j < Lr) ? (int)ref[j] : kPad;
      const bool is_match = tb == rbase && rbase < 4 && tb < 4;
      // diagonal from (i-1, j-1), with the fresh (empty) predecessor of
      // the local-SW 0-clamp starting at (i, j)
      const bool fresh = H[k] < 0;
      int D = (fresh ? 0 : H[k]) + (is_match ? match : -mismatch);
      int Dm = (fresh ? 0 : Hm[k]) + (is_match ? 1 : 0);
      int Dc = (fresh ? 0 : Hc[k]) + 1;
      int Drs = fresh ? i : Hrs[k];
      int Dfs = fresh ? j : Hfs[k];
      // tmp = max(D, E, fresh) with priority D >= E >= fresh
      if (En[k] > D) {
        D = En[k]; Dm = Enm[k]; Dc = Enc[k]; Drs = Enrs[k]; Dfs = Enfs[k];
      }
      if (D < 0) {
        D = 0; Dm = 0; Dc = 0; Drs = i + 1; Dfs = j + 1;
      }
      tmp[k] = valid[k] ? D : kNeg;
      tm[k] = Dm; tc[k] = Dc; trs[k] = Drs; tfs[k] = Dfs;
      gap[k] = 0;
    }
    // F: ref-consuming gap within the row, by shift-doubling
    int g[NS], gm[NS], gc[NS], grs[NS], gfs[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      g[k] = tmp[k]; gm[k] = tm[k]; gc[k] = tc[k]; grs[k] = trs[k]; gfs[k] = tfs[k];
    }
    cascade<NS, 1>(g, gm, gc, grs, gfs, gap, gap_ext, lane);
    int F[NS], Fgap[NS], Fm[NS], Fc[NS], Frs[NS], Ffs[NS];
    shift_right<NS, 1>(g, F, kNeg, lane);
    shift_right<NS, 1>(gap, Fgap, 0, lane);
    shift_right<NS, 1>(gm, Fm, 0, lane);
    shift_right<NS, 1>(gc, Fc, 0, lane);
    shift_right<NS, 1>(grs, Frs, 0, lane);
    shift_right<NS, 1>(gfs, Ffs, 0, lane);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int f = F[k] - go_ge;
      const bool take_f = f > tmp[k];
      H[k] = valid[k] ? (take_f ? f : tmp[k]) : kNeg;
      Hm[k] = take_f ? Fm[k] : tm[k];
      Hc[k] = take_f ? Fc[k] + Fgap[k] + 1 : tc[k];
      Hrs[k] = take_f ? Frs[k] : trs[k];
      Hfs[k] = take_f ? Ffs[k] : tfs[k];
      E[k] = valid[k] ? En[k] : kNeg;
      Em[k] = Enm[k]; Ec[k] = Enc[k]; Ers[k] = Enrs[k]; Efs[k] = Enfs[k];
      // per-slot best; strict improvement keeps the earliest row
      if (H[k] > bH[k]) {
        bH[k] = H[k]; bRow[k] = i;
        bm[k] = Hm[k]; bc[k] = Hc[k]; brs[k] = Hrs[k]; bfs[k] = Hfs[k];
      }
    }
  }

  // the pair's best cell: over this lane's slots, then across the warp
  int s = bH[0], r = bRow[0], b = lane, m = bm[0], cc = bc[0], rs = brs[0], fs = bfs[0];
#pragma unroll
  for (int k = 1; k < NS; ++k) {
    if (better(bH[k], bRow[k], k * 32 + lane, s, r, b)) {
      s = bH[k]; r = bRow[k]; b = k * 32 + lane; m = bm[k]; cc = bc[k]; rs = brs[k]; fs = bfs[k];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, s, d), r2 = __shfl_xor_sync(kFull, r, d);
    const int b2 = __shfl_xor_sync(kFull, b, d), m2 = __shfl_xor_sync(kFull, m, d);
    const int c2 = __shfl_xor_sync(kFull, cc, d), rs2 = __shfl_xor_sync(kFull, rs, d);
    const int fs2 = __shfl_xor_sync(kFull, fs, d);
    if (better(s2, r2, b2, s, r, b)) {
      s = s2; r = r2; b = b2; m = m2; cc = c2; rs = rs2; fs = fs2;
    }
  }
  if (lane == 0) {
    int32_t* o = out + (size_t)pair * 7;
    const bool aligned = s > 0;
    o[0] = s;
    o[1] = aligned ? rs : 0;
    o[2] = aligned ? r + 1 : 0;
    o[3] = aligned ? fs : 0;
    o[4] = aligned ? r + off - c + b + 1 : 0;
    o[5] = aligned ? m : 0;
    o[6] = aligned ? cc : 0;
  }
}

template <int NS>
void launch(const void* reads, const void* read_lens, const void* refs, const void* ref_lens,
            const void* offs, void* out, int B, int L, int Lr, int match, int mismatch,
            int gap_open, int gap_ext, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sw_banded_kernel<NS><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(read_lens),
      static_cast<const uint8_t*>(refs), static_cast<const int32_t*>(ref_lens),
      static_cast<const int32_t*>(offs), static_cast<int32_t*>(out),
      B, L, Lr, match, mismatch, gap_open, gap_ext);
}

}  // namespace

// reads (B, L) u8, refs (B, Lr) u8, lens/offsets (B,) i32, out (B, 7) i32:
// score, read_start, read_end, ref_start, ref_end, n_match, n_cols.
// Returns cudaGetLastError() after the launch.
extern "C" int sw_banded_launch(const void* reads, const void* read_lens, const void* refs,
                                const void* ref_lens, const void* offs, void* out,
                                int B, int L, int Lr, int W, int match, int mismatch,
                                int gap_open, int gap_ext, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 128: launch<4>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 256: launch<8>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 384: launch<12>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 512: launch<16>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
