// The bit-parallel column of a unit-cost edit-distance DP, shared by kernels
// B5 (fuzzy_match.cu) and B6 (dovetail.cu).
//
// Myers 1999, in the words of Hyyro 2003: a DP column is kept as its
// vertical deltas D[i][j] - D[i-1][j], +1 in Pv and -1 in Mv (bit r of word
// w holds row 64 w + r + 1), and one text base advances it by a handful of
// logical operations, an add and two shifts a 64-row word. A column longer
// than 64 rows is one wide integer cut into words: the add's carry and the
// shifted-out horizontal delta pass from each word to the next, low rows
// first. The top row's horizontal delta enters word 0 (`hin`: 0 for an
// infix match, whose text start is free; 1 past B6's free overhang). Rows
// above the last one a lane needs may hold anything: no operation moves
// information down to a lower row.
#pragma once

#include <stdint.h>

namespace bitvector {

constexpr int kLanes = 32;  // a block is one warp; shared words of a lane at stride kLanes

// One 64-row word of a column step. `carry`, `ph_in` and `mh_in` come from
// the word below (the column's top for word 0) and leave for the word above;
// `ph` and `mh` return this word's horizontal +1 and -1 deltas before the
// shift (bit r: row 64 w + r + 1).
__device__ __forceinline__ void word_step(uint64_t eq, uint64_t& pv, uint64_t& mv,
                                          uint64_t& carry, uint64_t& ph_in, uint64_t& mh_in,
                                          uint64_t& ph, uint64_t& mh) {
  const uint64_t xv = eq | mv;
  const uint64_t t = eq & pv;
  const uint64_t s1 = t + pv;
  const uint64_t s = s1 + carry;
  carry = static_cast<uint64_t>((s1 < t) | (s < s1));
  const uint64_t xh = (s ^ pv) | eq;
  ph = mv | ~(xh | pv);
  mh = pv & xh;
  const uint64_t phs = (ph << 1) | ph_in;
  const uint64_t mhs = (mh << 1) | mh_in;
  ph_in = ph >> 63;
  mh_in = mh >> 63;
  pv = mhs | ~(xv | phs);
  mv = phs & xv;
}

// A lane's column of WORDS words in registers (the main path: 1 or 2).
template <int WORDS>
struct Column {
  static constexpr bool kRegisters = true;
  uint64_t pv[WORDS], mv[WORDS];
  __host__ __device__ static constexpr int words() { return WORDS; }
  __device__ __forceinline__ uint64_t& p(int w) { return pv[w]; }
  __device__ __forceinline__ uint64_t& m(int w) { return mv[w]; }
  // word w at a lane-dependent w: selects, never an indexed register array
  __device__ __forceinline__ uint64_t p_at(int w) const {
    uint64_t x = pv[0];
#pragma unroll
    for (int u = 1; u < WORDS; ++u) x = w == u ? pv[u] : x;
    return x;
  }
  __device__ __forceinline__ uint64_t m_at(int w) const {
    uint64_t x = mv[0];
#pragma unroll
    for (int u = 1; u < WORDS; ++u) x = w == u ? mv[u] : x;
    return x;
  }
};

// A lane's column of `nw` words in shared memory, word w at pv[w * kLanes]
// (longer patterns and sequences).
struct SharedColumn {
  static constexpr bool kRegisters = false;
  uint64_t* pv;
  uint64_t* mv;
  int nw;
  __device__ __forceinline__ int words() const { return nw; }
  __device__ __forceinline__ uint64_t& p(int w) { return pv[w * kLanes]; }
  __device__ __forceinline__ uint64_t& m(int w) { return mv[w * kLanes]; }
  __device__ __forceinline__ uint64_t p_at(int w) const { return pv[w * kLanes]; }
  __device__ __forceinline__ uint64_t m_at(int w) const { return mv[w * kLanes]; }
};

// Row r >= 1 of a column (row 0, the top, matches no word).
struct Row {
  int w;
  uint64_t bit;
  __device__ __forceinline__ explicit Row(int r) : w((r - 1) >> 6), bit(1ull << ((r - 1) & 63)) {}
  // the row's delta in word `word`'s deltas (+1 bits, -1 bits), 0 in other words
  __device__ __forceinline__ int delta(int word, uint64_t plus, uint64_t minus) const {
    return word == w ? static_cast<int>((plus & bit) != 0) - static_cast<int>((minus & bit) != 0)
                     : 0;
  }
};

// Advance `col` over one text base: eq(w) is word w of the base's match
// bits, hin the top row's horizontal delta; probe(w, ph, mh) sees each
// word's horizontal deltas.
template <class Col, class Eq, class Probe>
__device__ __forceinline__ void column_step(Col& col, Eq eq, uint64_t hin, Probe probe) {
  uint64_t carry = 0, ph_in = hin, mh_in = 0;
#pragma unroll
  for (int w = 0; w < col.words(); ++w) {
    uint64_t pv = col.p(w), mv = col.m(w), ph, mh;
    word_step(eq(w), pv, mv, carry, ph_in, mh_in, ph, mh);
    col.p(w) = pv;
    col.m(w) = mv;
    probe(w, ph, mh);
  }
}

// The sum of the vertical deltas of rows 1..i of a column: D[i][j] - D[0][j].
template <class Col>
__device__ __forceinline__ int prefix(const Col& c, int i) {
  int sum = 0;
  for (int w = 0; 64 * w < i; ++w) {
    const int r = i - 64 * w;  // this word's rows counted
    const uint64_t m = r >= 64 ? ~0ull : (1ull << r) - 1;
    sum += __popcll(c.p_at(w) & m) - __popcll(c.m_at(w) & m);
  }
  return sum;
}

// Bytes row[s..s+15] as four little-endian words (garbage where outside
// row[0..len)). Two aligned 16-byte loads, each made only when its block
// holds a byte of the row, so no load leaves the pages of the row's bytes.
// A lane reads its own row: a byte load a column would cost the warp 32
// L1 wavefronts a column, these two a 16 columns.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int len, int s) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(row);
  const uintptr_t hi = lo + static_cast<uintptr_t>(max(len, 0));
  const uintptr_t at = lo + static_cast<intptr_t>(s);
  const uintptr_t a0 = at & ~static_cast<uintptr_t>(15);
  const unsigned o = static_cast<unsigned>(at & 15);
  uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
  if (a0 + 16 > lo && a0 < hi) v0 = __ldg(reinterpret_cast<const uint4*>(a0));
  if (o != 0 && a0 + 32 > lo && a0 + 16 < hi) v1 = __ldg(reinterpret_cast<const uint4*>(a0 + 16));
  const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  const unsigned q = o >> 2, sh = (o & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(x[0], x[1], sh), __funnelshift_r(x[1], x[2], sh),
                    __funnelshift_r(x[2], x[3], sh), __funnelshift_r(x[3], x[4], sh));
}

// The bases of columns [c, c + 16) of a lane's text, column c + 4 i + u in
// byte u of word i: row[c + ...] ascending, or (DESC) row[end - 1 - c - ...]
// (len = end: the prefix read backwards).
template <bool DESC>
__device__ __forceinline__ uint4 chunk16(const uint8_t* row, int len, int c) {
  if constexpr (!DESC) {
    return load16(row, len, c);
  } else {
    const uint4 b = load16(row, len, len - 16 - c);
    return make_uint4(__byte_perm(b.w, 0, 0x0123), __byte_perm(b.z, 0, 0x0123),
                      __byte_perm(b.y, 0, 0x0123), __byte_perm(b.x, 0, 0x0123));
  }
}

// Call visit(j, word) for j = 0, 4, 8, ... < ncol with the bases of a
// lane's text's columns [j, j + 4), column j + u in byte u of the word; ncol
// is the same for every lane of the warp (each lane bounds its own
// results), and a last quad may run up to three columns past it. The bases
// are read 16 at a time, a chunk ahead of their columns, into two
// alternating chunks, so no load stalls the column chain behind it; the
// quads of a chunk are a loop, not unrolled (the loop body is one quad's
// four columns: unrolled chunks overflow the instruction cache).
template <bool DESC, class Visit>
__device__ __forceinline__ void for_each_quad(const uint8_t* row, int len, int ncol, Visit visit) {
  const auto run = [&](int c, uint4 q) {
    for (int i = 0; i < 4 && c + 4 * i < ncol; ++i) {
      visit(c + 4 * i, q.x);
      q = make_uint4(q.y, q.z, q.w, 0u);
    }
  };
  uint4 a = chunk16<DESC>(row, len, 0), b;
  for (int c = 0; c < ncol; c += 32) {
    b = chunk16<DESC>(row, len, c + 16);
    run(c, a);
    if (c + 16 >= ncol) break;
    a = chunk16<DESC>(row, len, c + 32);
    run(c + 16, b);
  }
}

}  // namespace bitvector
