// Inline PTX of the tensor-core GPQ kernel (plane_mma.cuh), for sm_90a:
// the int8 tensor-core products and the asynchronous global -> shared
// copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpq {

// d += A B for one m16n8k16 tile of unsigned bytes, int32 accumulators.
// Lane l (group l / 4, t = l % 4) holds
//   a0: A[l / 4][4t .. 4t+3]       a1: A[l / 4 + 8][4t .. 4t+3]
//   b:  B[4t .. 4t+3][l / 4]
//   d:  D[l / 4][2t, 2t+1], D[l / 4 + 8][2t, 2t+1]
// (one byte per element, the lowest k in the lowest byte).
__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// mma_u8 with signed bytes in B (the same fragment layouts).
__device__ __forceinline__ void mma_u8s8(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Copy 16 bytes (L2 only) or 4 bytes global -> shared without waiting;
// the bytes past src_bytes (all of them at 0) are written as zero and
// not read.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed copy groups
// are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

}  // namespace gpq
