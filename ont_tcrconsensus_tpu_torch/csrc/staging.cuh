// Row staging shared by the two traceback walks (pileup_traceback.cu,
// error_profile_cs.cu).
//
// A walk reads one cell a step, and the cell's address is known only once
// the last step's cell is in. From device memory each step would pay a
// load's full latency; from shared memory it pays a shared-memory load. Both
// walks move up their plane by at most one row a step, and a lane's rows are
// contiguous, so a warp copies the chunk of K rows the walk reaches next,
// one contiguous block, into a double buffer with `cp.async` (16 bytes a
// thread, through L2 only), while it walks the chunk before it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace staging {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The rows [row_lo, row_hi] of a plane whose rows are `row_bytes` long (a
// multiple of 16, the plane 16-byte aligned), copied by the 32 lanes of a
// warp to `dst`, row row_lo first. Nothing is copied when row_hi < row_lo.
__device__ __forceinline__ void stage_rows(void* dst, const void* plane, int row_lo, int row_hi,
                                           int row_bytes, int lane) {
  if (row_hi < row_lo) return;
  const int pieces = (row_hi - row_lo + 1) * (row_bytes / 16);
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(plane) +
                                                    (size_t)row_lo * row_bytes);
  uint4* out = static_cast<uint4*>(dst);
  for (int k = lane; k < pieces; k += 32) cp_async16(out + k, src + k);
}

}  // namespace staging
