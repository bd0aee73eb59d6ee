// Tensor-core and async-copy helpers for the Hopper kernels
// (flash_attention_tc.cu, ssd_scan.cu): the bf16 mma.sync m16n8k16 with f32
// accumulation, bf16 packing and the hi + lo split of an f32 value,
// ldmatrix and cp.async.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA), with g = lane / 4 and
// q = lane % 4:
//   A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g + 8, 2q..),
//                           a2 = (g, 8 + 2q..), a3 = (g + 8, 8 + 2q..)
//   B (16 x 8, k x n):      b0 = (k 2q..2q+1, n g), b1 = (k 8 + 2q.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2q..2q+1), c2, c3 = (g + 8, 2q..)
// The element with the lower column (or k) index sits in the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace valet {

// d += a . b on the tensor cores (bf16 inputs, f32 accumulator)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values rounded to bf16, ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// v rounded to bf16 (hi), and the bf16 of what rounding left over (lo):
// hi + lo carries v to about 2^-16 relative.
__device__ __forceinline__ void split_bf16(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  hi = bits(h);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_bf16(v.x - hf.x, v.y - hf.y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, each matrix transposed on the way into the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// ``src_bytes`` (all 16 when it is 0) are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace valet
