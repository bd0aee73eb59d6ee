// Flash (prefill) attention forward for Hopper (sm_90a): the C entry point
// and the f32 CUDA-core kernel.
//
// Replaces the Pallas kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py: causal and/or sliding-window
// attention with an online softmax in f32; q head i reads KV head
// i // group; the output is in q's dtype.  Unlike the Pallas version it
// takes ragged lengths: q rows at or beyond Sq are neither loaded nor
// stored, keys at or beyond Sk are masked (engine prefill runs one prompt at
// its exact length, e.g. 77 tokens).
//
// Two routes, chosen by dtype in `valet_flash_attention` below, neither
// falling back to the other:
//  * bf16 q with bf16 k/v (every prefill of the main paths) runs on the
//    tensor cores: flash_attention_tc.cu (mma.sync, cp.async ring).
//  * every other pair (f32/f32, f32 q over bf16 k/v, bf16 q over f32 k/v)
//    runs the f32 kernel of this file, which keeps f32 parity tight.
//
// What bounds it on this card: operations.  Each K/V tile is reused by a
// whole tile of query rows, so at prompt lengths of a few hundred tokens
// the multiply-adds outweigh the bytes; the f32 kernel runs them on the f32
// CUDA cores (67 TFLOP/s peak), far below the tensor cores.
//
// What the f32 kernel does:
//  * One block per (q head, tile of BQ = 4 * RQ query rows).  The block walks
//    KV tiles of 32 keys from the window band's start to the causal end, so
//    fully masked tiles are never loaded; the diagonal and band edges are
//    masked per element.
//  * Q, K and V tiles sit in shared memory as f32 rows of stride D + 4
//    (16-byte loads from device memory, several in flight per thread;
//    conflict-free 16-byte reads).
//  * Warp w owns query rows w, w + 4, ...; lane j owns key j of the tile, so
//    a row's scores live in one warp and m, l are warp-reduced in registers.
//    acc (RQ x D per warp) is spread over the lanes (d = lane + 32 c).
//  * RQ shrinks with D (16 rows per warp up to D = 128, 8 up to D = 256) so
//    acc stays at 64 registers per thread; the tiles exceed 48 KB and the
//    kernel opts into dynamic shared memory.

#include "attn_common.cuh"

namespace valet {

constexpr int kKeyTile = 32;

template <typename QT, typename KT, int RQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                 const KT* __restrict__ v, QT* __restrict__ out, int Sq, int Sk,
                 int D, int group, int causal, int window, float scale) {
  constexpr int BQ = kWarps * RQ;
  constexpr int kMaxCols = 64 / RQ;          // D <= 32 * kMaxCols
  extern __shared__ __align__(16) float smem[];
  const int SD = D + 4;
  float* qs = smem;                          // BQ x SD
  float* ks = qs + BQ * SD;                  // 32 x SD
  float* vs = ks + kKeyTile * SD;            // 32 x SD

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int bkv = bh / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const QT* qb = q + (size_t)bh * Sq * D;
  stage_rows<QT, 8>(qb, qs, nullptr, nullptr, BQ, D, SD, [&](int i) {
    return q0 + i < Sq ? (long long)(q0 + i) * D : -1LL;
  });

  float m[RQ], l[RQ], acc[RQ][kMaxCols];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  // KV band of this q tile: [k_begin, k_end)
  int k_begin = 0, k_end = Sk;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kKeyTile * kKeyTile;
  if (causal) k_end = min(Sk, q0 + BQ);

  const KT* kb = k + (size_t)bkv * Sk * D;
  const KT* vb = v + (size_t)bkv * Sk * D;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeyTile) {
    __syncthreads();   // previous tiles consumed (and the q tile stored)
    stage_rows<KT, 4>(kb, ks, vb, vs, kKeyTile, D, SD, [&](int j) {
      return k0 + j < Sk ? (long long)(k0 + j) * D : -1LL;
    });
    __syncthreads();

    // scores: s[r] = q[row r] . k[lane], k row read once per d step
    float s[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) s[r] = 0.f;
    const float* krow = ks + lane * SD;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (warp + kWarps * r) * SD + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qpos = q0 + warp + kWarps * r;
      bool valid = kpos < Sk;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      const float sc = valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[r][c] *= corr;
    }

    for (int j = 0; j < kKeyTile; ++j) {
      const float* vrow = vs + j * SD;
      float vv[kMaxCols];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? vrow[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  QT* ob = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = q0 + warp + kWarps * r;
    if (i >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store_out(ob + (size_t)i * D + d, acc[r][c] / lc);
    }
  }
}

// flash_attention_tc.cu: the tensor-core route for bf16 q/k/v
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v, void* out,
                            int BH, int Sq, int Sk, int D, int group, int causal,
                            int window, float scale, cudaStream_t stream);

template <typename QT, typename KT, int RQ>
cudaError_t launch_flash_rq(const void* q, const void* k, const void* v, void* out,
                            int BH, int Sq, int Sk, int D, int group, int causal,
                            int window, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<QT, KT, RQ>;
  constexpr int BQ = kWarps * RQ;
  const size_t smem = sizeof(float) * (size_t)(BQ + 2 * kKeyTile) * (D + 4);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<QT*>(out), Sq, Sk, D, group, causal, window, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out,
                         int BH, int Sq, int Sk, int D, int group, int causal,
                         int window, float scale, cudaStream_t stream) {
  if (D <= 128)
    return launch_flash_rq<QT, KT, 16>(q, k, v, out, BH, Sq, Sk, D, group, causal,
                                       window, scale, stream);
  return launch_flash_rq<QT, KT, 8>(q, k, v, out, BH, Sq, Sk, D, group, causal,
                                    window, scale, stream);
}

}  // namespace valet

// C interface (bound with ctypes).  q/out: (BH, Sq, D) contiguous; k/v:
// (BKV, Sk, D) contiguous with BH = BKV * group.  bf16/bf16 runs on the
// tensor cores, every other dtype pair on the f32 kernel.  Returns the
// cudaError_t.
extern "C" int valet_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int BH, int Sq, int Sk, int D,
                                     int group, int causal, int window, int q_dtype,
                                     int kv_dtype, float scale, void* stream) {
  using namespace valet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_flash<float, float>(q, k, v, out, BH, Sq, Sk, D, group, causal,
                                      window, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch_flash<float, __nv_bfloat16>(q, k, v, out, BH, Sq, Sk, D, group,
                                              causal, window, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch_flash<__nv_bfloat16, float>(q, k, v, out, BH, Sq, Sk, D, group,
                                              causal, window, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_flash_tc(q, k, v, out, BH, Sq, Sk, D, group, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
