// Shared device helpers for the attention kernels (paged_attention.cu,
// flash_attention.cu): 16-byte loads into f32 shared-memory rows, output
// conversion, warp reductions and the dtype codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace valet {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF (finite: no inf-inf)
constexpr int kThreads = 128;       // four warps per block
constexpr int kWarps = kThreads / 32;

// dtype codes passed through the C interface
enum DType : int { kF32 = 0, kBF16 = 1 };

// Elements per 16-byte vector.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// Store 16 loaded bytes (one vector of T) as f32 into shared memory.
template <typename T> __device__ __forceinline__ void store16_f32(uint4 u, float* dst);
template <> __device__ __forceinline__ void store16_f32<float>(uint4 u, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&u);
}
template <>
__device__ __forceinline__ void store16_f32<__nv_bfloat16>(uint4 u, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  float2 c = __bfloat1622float2(h[2]);
  float2 d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Stage ``rows`` rows of D values from two sources (K and V, or one when
// ``b`` is null) into f32 shared-memory rows of stride SD.  ``row_off(r)``
// is row r's element offset in both sources, or -1 for a row to zero-fill
// (no load is issued for it).  Each thread keeps U 16-byte loads per source
// in flight before it stores any, so the tile's load latency is paid about
// once per U vectors instead of once per vector.
template <typename T, int U, typename RowOff>
__device__ __forceinline__ void stage_rows(const T* __restrict__ a, float* da,
                                           const T* __restrict__ b, float* db,
                                           int rows, int D, int SD, RowOff row_off) {
  constexpr int N = Vec<T>::N;
  const int per_row = D / N;
  const int total = rows * per_row;
  for (int base = threadIdx.x; base < total; base += kThreads * U) {
    uint4 va[U], vb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      va[u] = vb[u] = make_uint4(0u, 0u, 0u, 0u);
      const int e = base + u * kThreads;
      if (e < total) {
        const long long off = row_off(e / per_row);
        if (off >= 0) {
          const size_t at = (size_t)off + (size_t)(e % per_row) * N;
          va[u] = __ldg(reinterpret_cast<const uint4*>(a + at));
          if (b != nullptr) vb[u] = __ldg(reinterpret_cast<const uint4*>(b + at));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * kThreads;
      if (e < total) {
        const int at = (e / per_row) * SD + (e % per_row) * N;
        store16_f32<T>(va[u], da + at);
        if (b != nullptr) store16_f32<T>(vb[u], db + at);
      }
    }
  }
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);   // round to nearest even, as torch and XLA
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dot product of two f32 shared-memory rows of length D (D % 4 == 0).
__device__ __forceinline__ float dot_row(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 x = *reinterpret_cast<const float4*>(a + d);
    float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace valet
