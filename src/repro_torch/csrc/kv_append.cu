// One decode step's K and V rows appended to a paged layer's pools, for
// the rows that own a slot in range; every other row writes nothing
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package appends with one scatter whose
// masked rows are sent out of range, where XLA drops them (`mode="drop"`,
// src/repro/core/device_ops.py:45).  PyTorch's `index_put_` asserts on an
// index out of range instead, so the eager path selects the live rows with
// `nonzero()` (`core/device_ops.live_rows`), which waits for the card; a
// decode step replayed as a CUDA graph can hold no such wait.  This kernel
// reads the mask, slots and offsets on the card and skips a row that is
// masked off or whose slot or offset is out of range, so the host never
// learns which rows append.
//
// Layout: k and v (B, row), contiguous, row = n_kv x head_dim elements in
// the step's dtype; the pools (n_slots, page, n_kv, head_dim), contiguous,
// in their own dtype.  Row b goes to pool + (slot[b] x page + off[b]) x row,
// converted through f32 (exact from bf16; to bf16 rounded to nearest even,
// as PyTorch's cast rounds).
//
// What bounds it: a launch's latency.  The bytes are a read of each row and
// a write into the pool, 2 x B x row elements (64 x 1,024 x 2 at
// granite-3-8b's batch: 0.79 MB of bf16 rows read and f32 rows written).
// Design: one block per (row, K or V); neighbouring threads on
// neighbouring elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace valet {

constexpr int kKvAppendThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename S, typename D>
__global__ void __launch_bounds__(kKvAppendThreads)
kv_append_kernel(const S* __restrict__ k, const S* __restrict__ v,
                 const uint8_t* __restrict__ mask, const long long* __restrict__ slot,
                 const long long* __restrict__ off, D* __restrict__ pool_k,
                 D* __restrict__ pool_v, long long n_slots, int page, int row) {
  const int b = blockIdx.x;
  const long long s = slot[b], o = off[b];
  if (!mask[b] || s < 0 || s >= n_slots || o < 0 || o >= page) return;
  const S* src = (blockIdx.y ? v : k) + static_cast<long long>(b) * row;
  D* dst = (blockIdx.y ? pool_v : pool_k) + (s * page + o) * row;
  for (int i = threadIdx.x; i < row; i += kKvAppendThreads) dst[i] = from_f32<D>(to_f32(src[i]));
}

template <typename S, typename D>
static cudaError_t launch(const void* k, const void* v, const void* mask, const void* slot,
                          const void* off, void* pool_k, void* pool_v, int batch,
                          long long n_slots, int page, int row, cudaStream_t stream) {
  kv_append_kernel<S, D><<<dim3(batch, 2), kKvAppendThreads, 0, stream>>>(
      static_cast<const S*>(k), static_cast<const S*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const long long*>(slot), static_cast<const long long*>(off),
      static_cast<D*>(pool_k), static_cast<D*>(pool_v), n_slots, page, row);
  return cudaGetLastError();
}

}  // namespace valet

// k, v: (batch, row) in src_dtype; mask: (batch,) bool; slot, off: (batch,)
// int64; pools: (n_slots, page, row) in pool_dtype.  Dtype codes: 0 f32,
// 1 bf16.  Issued on `stream`; nothing waits.
extern "C" int valet_kv_append(const void* k, const void* v, const void* mask,
                               const void* slot, const void* off, void* pool_k,
                               void* pool_v, int batch, long long n_slots, int page, int row,
                               int src_dtype, int pool_dtype, void* stream) {
  using valet::launch;
  using bf16 = __nv_bfloat16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (src_dtype == 0 && pool_dtype == 0)
    err = launch<float, float>(k, v, mask, slot, off, pool_k, pool_v, batch, n_slots, page, row, s);
  else if (src_dtype == 1 && pool_dtype == 0)
    err = launch<bf16, float>(k, v, mask, slot, off, pool_k, pool_v, batch, n_slots, page, row, s);
  else if (src_dtype == 0 && pool_dtype == 1)
    err = launch<float, bf16>(k, v, mask, slot, off, pool_k, pool_v, batch, n_slots, page, row, s);
  else if (src_dtype == 1 && pool_dtype == 1)
    err = launch<bf16, bf16>(k, v, mask, slot, off, pool_k, pool_v, batch, n_slots, page, row, s);
  return static_cast<int>(err);
}
