// Kernel B1: batched banded local affine-gap Smith-Waterman, stats only.
//
// Replaces the JAX package's Pallas TPU kernel
// ont_tcrconsensus_tpu/ops/sw_pallas.py:56 `_kernel` (driven by
// `align_banded_pallas`, :190). Semantics are those of
// ops/sw_align.py `align_banded` cell for cell: the same int32 DP, the same
// ref-gap F (the strictly-greater doubling's values, origins and gap
// lengths), the same four channels (matches, columns, read start, ref
// start), and the same best-cell tie-break (max score, then earliest row,
// then smallest slot; all zero when nothing scores above 0).
//
// Design. The band is lane-contiguous (dp_common.cuh): W = 128 is one warp
// of 4 slots a lane; W = 256, 384 and 512 are 2, 3 and 4 such warps in one
// block, one pair per block, so no width keeps more than 4 slots' carry in
// a thread's registers. The four channels ride in two 32-bit registers,
// (columns, matches) and (read start, ref start), 16 bits each, so every
// choice between two origins is three selects, not five; this holds while
// L + Lr < 2^16. The warp loops over the read's rows with the whole DP
// carry in registers. Per row: E's open-vs-extend at the source slot, then
// one slot down the band (a register move, and one shuffle of 3 values a
// lane); tmp; F as the lane's local carry, one Kogge-Stone scan of packed
// keys across the warp, the winner's gap and channels by indexed shuffle,
// and a second pass over the lane's slots; then H and a per-lane running
// best (score, row * 512 + slot, and the two channel words). Across warps,
// E's edge and the F carry go through shared memory, with two block
// barriers a row. The row loop is unrolled by two. Nothing but the inputs
// and one 7-int result per pair touches device memory.
//
// Bound on the H100: operations. The function needs 68 int32 operations a
// cell (chip_smoke.py itemizes them), with F counted as the sequential
// max-plus over four separate channels. This design adds the lane's local
// F pass and, per lane and row, the scan's keys and decoding, and saves the
// selects that packing the channels removes (chip_smoke.py `SW_DESIGN`);
// its shuffles are 12 a lane-row (E 3, scan 6, winner 3; 4 more when the
// band spans warps), 3 a cell. About half of the design's instructions are
// compares, selects and min/max, which issue only on the 64-lane INT32
// pipe. Rows past the read's length cannot change the result and are not
// computed.
#include "dp_common.cuh"

namespace {

using namespace dp;

constexpr unsigned kCol = 1u << 16;  // one column in the (columns, matches) word

template <int NS, int NW>
__global__ void __launch_bounds__(NW == 1 ? kWarpsPerBlock * 32 : NW * 32, 4)
sw_banded_kernel(const uint8_t* __restrict__ reads, const int32_t* __restrict__ read_lens,
                 const uint8_t* __restrict__ refs, const int32_t* __restrict__ ref_lens,
                 const int32_t* __restrict__ offs, int32_t* __restrict__ out,
                 int B, int L, int Lr, int match, int mismatch, int gap_open, int gap_ext) {
  constexpr int WS = NS * 32;  // slots a warp
  constexpr int W = WS * NW;
  constexpr int c = W / 2;
  constexpr int NWS = NW > 1 ? NW : 1;
  static_assert(W <= (1 << kSlotBits), "the best cell's key holds 9 bits of slot");
  // across warps: each warp's E source at its first slot (value, mc, pos),
  // its F carry at its last slot (value, gap, mc, pos) and its best cell
  // (score, key, mc, pos)
  __shared__ int esrc[NWS][3];
  __shared__ int wcarry[NWS][4];
  __shared__ int wbest[NWS][4];
  const int lane = threadIdx.x & 31;
  const int warp = NW == 1 ? 0 : (int)(threadIdx.x >> 5);
  const int pair = NW == 1 ? (int)(blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5))
                           : (int)blockIdx.x;
  if (pair >= B) return;  // the whole warp (one pair a warp) leaves together
  const uint8_t* read = reads + (size_t)pair * L;
  const uint8_t* ref = refs + (size_t)pair * Lr;
  const int rlen = read_lens[pair];
  const int tlen = ref_lens[pair];
  const int off = offs[pair];
  const int b0 = warp * WS + lane * NS;  // this lane's first band slot
  const int jb = off - c + b0;           // ref index of slot b0 in row 0
  const int go_ge = gap_open + gap_ext;
  // E at the band's last slot: its source beyond the band has H = E = NEG
  const int e_fill = max(kNeg - go_ge, kNeg - gap_ext);

  // per slot: score, (columns << 16 | matches) and (read start << 16 | ref
  // start) of H and of E
  int H[NS], E[NS], tb[NS];
  unsigned Hmc[NS], Hpos[NS], Emc[NS], Epos[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    H[k] = E[k] = kNeg;
    Hmc[k] = Hpos[k] = Emc[k] = Epos[k] = 0;
    tb[k] = ref_code(ref_base(ref, jb + k - 1, Lr));
  }
  int bs = 0, bkey = 0x7fffffff;
  unsigned bmc = 0, bpos = 0;

  const int n_rows = min(L, rlen);
  int rnext = n_rows > 0 ? read[0] : 0;
  int tnext = ref_base(ref, jb + NS - 1, Lr);
#pragma unroll 2
  for (int i = 0; i < n_rows; ++i) {
    const int rbase = read_code(rnext);
    slide<NS>(tb, ref_code(tnext));
    if (i + 1 < n_rows) rnext = read[i + 1];
    tnext = ref_base(ref, i + 1 + jb + NS - 1, Lr);

    // E: read-consuming gap from (i-1, j), the previous row's slot b+1.
    // Open-vs-extend is decided at the source slot, then shifted.
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int o = H[k] - go_ge;
      const int e = E[k] - gap_ext;
      const bool top = o >= e;
      E[k] = top ? o : e;
      Emc[k] = top ? Hmc[k] : Emc[k];
      Epos[k] = top ? Hpos[k] : Epos[k];
    }
    int edge = e_fill;
    unsigned edge_mc = 0, edge_pos = 0;
    if constexpr (NW > 1) {
      if (lane == 0) {
        esrc[warp][0] = E[0]; esrc[warp][1] = (int)Emc[0]; esrc[warp][2] = (int)Epos[0];
      }
      __syncthreads();
      if (warp + 1 < NW) {
        edge = esrc[warp + 1][0];
        edge_mc = (unsigned)esrc[warp + 1][1];
        edge_pos = (unsigned)esrc[warp + 1][2];
      }
    }
    shift_up<NS>(E, edge, lane);
    shift_up<NS>(Emc, edge_mc, lane);
    shift_up<NS>(Epos, edge_pos, lane);

    // tmp = max(diagonal, E, fresh) with priority D >= E >= fresh, into H.
    // A fresh start at (i, j) has read start i and ref start j.
    const int j0 = i + jb;
    const unsigned fresh_pos = (unsigned)i * (kCol + 1u) + (unsigned)jb;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      Emc[k] += kCol;  // one more (gap) column
      const bool valid = (unsigned)(j0 + k) < (unsigned)tlen;
      const bool is_match = tb[k] == rbase;
      // diagonal from (i-1, j-1), with the fresh (empty) predecessor of
      // the local-SW 0-clamp starting at (i, j)
      const bool fresh = H[k] < 0;
      int D = max(H[k], 0) + (is_match ? match : -mismatch);
      unsigned Dmc = (fresh ? 0u : Hmc[k]) + (is_match ? kCol + 1u : kCol);
      unsigned Dpos = fresh ? fresh_pos + k : Hpos[k];
      if (E[k] > D) {
        D = E[k]; Dmc = Emc[k]; Dpos = Epos[k];
      }
      if (D < 0) {  // empty: starts at (i + 1, j + 1)
        D = 0; Dmc = 0; Dpos = fresh_pos + k + kCol + 1u;
      }
      H[k] = valid ? D : kNeg;
      Hmc[k] = Dmc; Hpos[k] = Dpos;
    }

    // F step 1: this lane's local carry at its last slot
    int lv = H[0], lg = 0;
    unsigned lmc = Hmc[0], lpos = Hpos[0];
#pragma unroll
    for (int k = 1; k < NS; ++k) {
      const int cand = lv - gap_ext;
      const bool take = cand > H[k];
      lv = take ? cand : H[k];
      lg = take ? lg + 1 : 0;
      lmc = take ? lmc : Hmc[k];
      lpos = take ? lpos : Hpos[k];
    }
    // F step 2: the carry of the lanes to the left, at this lane's first
    // slot - 1, with its gap and channels from the lane it came from
    const int z = scan_key<NS>(lv, gap_ext, lane);
    const int zx = __shfl_up_sync(kFull, z, 1);
    const int src = key_lane(zx);
    int rv = key_value<NS>(zx, gap_ext, lane - 1);
    int rg = from_lane(lg, src) + (lane - 1 - src) * NS;
    unsigned rmc = from_lane(lmc, src);
    unsigned rpos = from_lane(lpos, src);
    // the carry into this warp's first slot: the band's edge (nothing to
    // the left) or the warps to the left
    int iv = kNeg, ig = 0;
    unsigned imc = 0, ipos = 0;
    if constexpr (NW > 1) {
      const int zl = __shfl_sync(kFull, z, 31);
      const int sl = key_lane(zl);
      const int g = from_lane(lg, sl) + (31 - sl) * NS;
      const unsigned mc = from_lane(lmc, sl);
      const unsigned pos = from_lane(lpos, sl);
      if (lane == 31) {
        wcarry[warp][0] = key_value<NS>(zl, gap_ext, 31); wcarry[warp][1] = g;
        wcarry[warp][2] = (int)mc; wcarry[warp][3] = (int)pos;
      }
      __syncthreads();
      // nearer warps last: a tie goes to the nearer origin
#pragma unroll
      for (int u = 0; u + 1 < NW; ++u) {
        if (u < warp) {
          const int d = (warp - 1 - u) * WS;
          const int v = wcarry[u][0] - gap_ext * d;
          if (u == 0 || v >= iv) {
            iv = v; ig = wcarry[u][1] + d;
            imc = (unsigned)wcarry[u][2]; ipos = (unsigned)wcarry[u][3];
          }
        }
      }
      // lanes to the left inside this warp are nearer: the warp's carry
      // wins only when strictly greater
      const int d = lane * NS;
      if (lane > 0 && iv - gap_ext * d > rv) {
        rv = iv - gap_ext * d; rg = ig + d; rmc = imc; rpos = ipos;
      }
    }
    if (lane == 0) {
      rv = iv; rg = ig; rmc = imc; rpos = ipos;
    }

    // F step 3: F[b] = R[b-1] - open - ext over this lane's slots; H, the
    // E band mask and the running best
    const int row_key = (i << kSlotBits) + b0;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int t = H[k];
      const unsigned tmc = Hmc[k], tpos = Hpos[k];
      const bool valid = (unsigned)(j0 + k) < (unsigned)tlen;
      const int f = rv - go_ge;
      const bool take_f = f > t;
      H[k] = valid ? (take_f ? f : t) : kNeg;
      if (take_f) {  // the gap's rg + 1 columns
        Hmc[k] = rmc + (unsigned)(rg + 1) * kCol; Hpos[k] = rpos;
      }
      E[k] = valid ? E[k] : kNeg;
      const int cand = rv - gap_ext;
      const bool take = cand > t;
      rv = take ? cand : t;
      rg = take ? rg + 1 : 0;
      rmc = take ? rmc : tmc;
      rpos = take ? rpos : tpos;
      if (H[k] > bs) {
        bs = H[k]; bkey = row_key + k; bmc = Hmc[k]; bpos = Hpos[k];
      }
    }
  }

  // the pair's best cell: across the warp, then across the block's warps
  int s = bs, key = bkey;
  unsigned mc = bmc, pos = bpos;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int s2 = __shfl_xor_sync(kFull, s, d), key2 = __shfl_xor_sync(kFull, key, d);
    const unsigned mc2 = __shfl_xor_sync(kFull, mc, d), pos2 = __shfl_xor_sync(kFull, pos, d);
    if (better(s2, key2, s, key)) {
      s = s2; key = key2; mc = mc2; pos = pos2;
    }
  }
  if constexpr (NW > 1) {
    if (lane == 0) {
      wbest[warp][0] = s; wbest[warp][1] = key; wbest[warp][2] = (int)mc;
      wbest[warp][3] = (int)pos;
    }
    __syncthreads();
    if (warp > 0) return;
#pragma unroll
    for (int u = 1; u < NW; ++u) {
      if (better(wbest[u][0], wbest[u][1], s, key)) {
        s = wbest[u][0]; key = wbest[u][1];
        mc = (unsigned)wbest[u][2]; pos = (unsigned)wbest[u][3];
      }
    }
  }
  if (lane == 0) {
    int32_t* o = out + (size_t)pair * 7;
    const bool aligned = s > 0;
    const int r = key >> kSlotBits, b = key & ((1 << kSlotBits) - 1);
    o[0] = s;
    o[1] = aligned ? (int)(pos >> 16) : 0;
    o[2] = aligned ? r + 1 : 0;
    o[3] = aligned ? (int)(pos & 0xffffu) : 0;
    o[4] = aligned ? r + off - c + b + 1 : 0;
    o[5] = aligned ? (int)(mc & 0xffffu) : 0;
    o[6] = aligned ? (int)(mc >> 16) : 0;
  }
}

template <int NW>
void launch(const void* reads, const void* read_lens, const void* refs, const void* ref_lens,
            const void* offs, void* out, int B, int L, int Lr, int match, int mismatch,
            int gap_open, int gap_ext, cudaStream_t stream) {
  const int per_block = NW == 1 ? kWarpsPerBlock : 1;  // pairs a block
  const dim3 block(NW == 1 ? kWarpsPerBlock * 32 : NW * 32);
  const dim3 grid((B + per_block - 1) / per_block);
  sw_banded_kernel<4, NW><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(read_lens),
      static_cast<const uint8_t*>(refs), static_cast<const int32_t*>(ref_lens),
      static_cast<const int32_t*>(offs), static_cast<int32_t*>(out),
      B, L, Lr, match, mismatch, gap_open, gap_ext);
}

}  // namespace

// reads (B, L) u8, refs (B, Lr) u8, lens/offsets (B,) i32, out (B, 7) i32:
// score, read_start, read_end, ref_start, ref_end, n_match, n_cols.
// Returns cudaErrorInvalidValue, launching nothing, for a band width it is
// not built for or inputs its packed keys and channels cannot hold (the one
// check of those limits); else cudaGetLastError() after the launch.
extern "C" int sw_banded_launch(const void* reads, const void* read_lens, const void* refs,
                                const void* ref_lens, const void* offs, void* out,
                                int B, int L, int Lr, int W, int match, int mismatch,
                                int gap_open, int gap_ext, void* stream) {
  if (B <= 0) return 0;
  // the channels' 16-bit fields hold a column count of at most L + Lr
  if (!scores_fit(L, W, match, mismatch, gap_open, gap_ext) || L + Lr >= (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 128: launch<1>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 256: launch<2>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 384: launch<3>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    case 512: launch<4>(reads, read_lens, refs, ref_lens, offs, out, B, L, Lr, match, mismatch, gap_open, gap_ext, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
