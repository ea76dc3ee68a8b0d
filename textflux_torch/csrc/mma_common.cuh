// Device helpers of the attention kernels: the mma.sync bf16 tensor-core
// product and the cp.async copies (flash_attention.cu's LSE pass), and bf16
// packing (also taken by sm90_common.cuh). The Hopper building blocks
// (wgmma, TMA, mbarrier) are in sm90_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace textflux {

// D += A * B on the tensor cores: m16n8k16, bf16 in, fp32 accumulate.
// Fragments (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = A[g][2t,2t+1], a1 = A[g+8][2t,2t+1],
//                         a2 = A[g][2t+8,2t+9], a3 = A[g+8][2t+8,2t+9]
//   B (16x8, k x n):      b0 = B[2t,2t+1][g], b1 = B[2t+8,2t+9][g]
//   C/D (16x8):           d0,d1 = C[g][2t,2t+1], d2,d3 = C[g+8][2t,2t+1]
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16 (round to nearest even); `lo` goes to
// the low half, which the mma fragments hold for the lower column index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros (ragged tail rows)
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace textflux
