// Flash (prefill) attention forward on the tensor cores, bf16 q/k/v
// (sm_90a).  The route of `valet_flash_attention` (flash_attention.cu) when
// q and k/v are both bf16; every other dtype pair takes the f32 CUDA-core
// kernel there.
//
// Replaces the Pallas kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py: causal and/or sliding-window
// attention with an online softmax in f32; q head i reads KV head
// i // group; the output is in q's dtype.  Ragged Sq and Sk are taken.
//
// What bounds it on this card: operations.  A query tile reuses every K/V
// tile it loads, so at prompt lengths of a few hundred tokens the products
// outweigh the bytes (granite S=512: 2.15 GFLOP against 4 MB), and only the
// tensor cores (989 TFLOP/s bf16, against 67 for f32 FMAs) bring the time
// near the bound.
//
// What the design does about it (the FlashAttention-2 layout on mma.sync):
//  * One block per (q head, tile of BQ = 16 * NW query rows); warp w owns
//    rows 16w..16w+15.  NW is 4, or 2 when 4-warp tiles would give fewer
//    blocks than the card has SMs (short prompts).  The heaviest (latest)
//    query tiles are launched first.
//  * K and V tiles stay bf16 in shared memory, rows padded by 16 bytes so
//    that ldmatrix and the 16-byte copies are free of bank conflicts.  A
//    ring of ST stages is filled with cp.async (rows at or past Sk, and the
//    columns from D up to the padded width, are zero-filled), so the next
//    tiles' loads overlap the current tile's math: 2 stages, 3 at D = 256
//    (measured: a third stage loses at D = 64 and 128, where it costs a
//    block per SM, and gains at D = 256).
//  * S = Q K^T by mma.sync.m16n8k16 (bf16 in, f32 accumulate): Q and K are
//    read with ldmatrix; K's row-major tile is the B operand as it is.
//  * The online softmax runs on the accumulator fragments in registers:
//    row max across the quad by shuffles, m and the per-thread part of l in
//    f32, exp2 by the SFU's ex2.approx with the scale folded into log2(e).
//    The finite kNegInf sentinel marks masked scores, whose probability is
//    set to 0; l is clamped to 1e-20 at the end.
//  * O += P V with P rounded to bf16 straight from the S fragments (the
//    accumulator layout of two 16x8 tiles is the A layout of one 16x16),
//    V read with ldmatrix.trans.
//  * The KV loop starts at the window band and stops at the causal end;
//    a warp skips a tile all of whose keys are masked for its rows, and the
//    per-element mask runs only on the diagonal, band and ragged tiles.
//  * D is any multiple of 8 up to 256, zero-padded to DP = 64, 128 or 256 in
//    shared memory; only D columns are stored.  At DP = 256 the O
//    accumulator is 128 registers a thread, so the key tile is 32 there
//    (64 otherwise).  The masks run as one warp-uniform branch and selects
//    (a branch per element compiled to a convergence barrier each).
//  * No atomics and a fixed order of every sum: two calls give the same
//    bits.

#include "attn_common.cuh"
#include "mma.cuh"

namespace valet {

// 2^x by the SFU's approximation (ex2.approx.ftz: about 2 ulp; 2^-1e30 = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP, int NW, int KT, int ST>
__global__ void __launch_bounds__(32 * NW)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                int Sq, int Sk, int D, int group, int causal, int window,
                float scale_log2) {
  constexpr int BQ = 16 * NW;
  constexpr int NTH = 32 * NW;
  constexpr int LD = DP + 8;          // row stride in bf16: 16 bytes of padding
  constexpr int CPR = DP / 8;         // 16-byte chunks per row
  constexpr int NKT = KT / 8;         // 8-key tiles of S
  constexpr int NDT = DP / 8;         // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BQ x LD
  __nv_bfloat16* ks = qs + BQ * LD;                                 // ST x KT x LD
  __nv_bfloat16* vs = ks + ST * KT * LD;                            // ST x KT x LD

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bkv = bh / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const __nv_bfloat16* qb = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)bkv * Sk * D;
  const __nv_bfloat16* vb = v + (size_t)bkv * Sk * D;

  // rows [row0, row0 + rows) of src (limit rows in all) into dst, zero-filled
  // past the limit and past column D
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                       int limit, int rows) {
    for (int e = tid; e < rows * CPR; e += NTH) {
      const int r = e / CPR, c = (e % CPR) * 8;
      const bool ok = row0 + r < limit && c < D;
      const __nv_bfloat16* from = ok ? src + (size_t)(row0 + r) * D + c : src;
      cp_async16(dst + r * LD + c, from, ok ? 16 : 0);
    }
  };

  // KV band of this q tile: [k_begin, k_end)
  int k_begin = 0, k_end = Sk;
  if (window > 0) k_begin = max(0, q0 - window + 1) / KT * KT;
  if (causal) k_end = min(Sk, q0 + BQ);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;

  // the ring: tile i in stage i % ST, one commit group per tile (Q joins
  // tile 0's); ST - 1 tiles are in flight ahead of the one in use
  load_rows(qs, qb, q0, Sq, BQ);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) {
      load_rows(ks + i * KT * LD, kb, k_begin + i * KT, Sk, KT);
      load_rows(vs + i * KT * LD, vb, k_begin + i * KT, Sk, KT);
    }
    cp_async_commit();
  }

  float o[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int rlo = q0 + warp * 16;                 // this warp's first row
  const int row[2] = {rlo + g, rlo + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * KT;
    const int st = it % ST;
    const int ahead = it + ST - 1;                // the tile whose load starts now
    if (ahead < n_tiles) {
      load_rows(ks + (ahead % ST) * KT * LD, kb, k_begin + ahead * KT, Sk, KT);
      load_rows(vs + (ahead % ST) * KT * LD, vb, k_begin + ahead * KT, Sk, KT);
    }
    cp_async_commit();
    cp_async_wait<ST - 1>();                      // this tile (and Q) landed
    __syncthreads();

    const bool skip = (causal && k0 > rlo + 15) ||
                      (window > 0 && k0 + KT - 1 <= rlo - window);
    if (!skip) {
      const __nv_bfloat16* kst = ks + st * KT * LD;
      const __nv_bfloat16* vst = vs + st * KT * LD;
      float s[NKT][4];
#pragma unroll
      for (int j = 0; j < NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NKT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kst + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], a, b[0], b[1]);
          mma_bf16(s[j + 1], a, b[2], b[3]);
        }
      }

#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      // one warp-uniform branch, then selects: a branch per element would
      // put a convergence barrier around each of them
      const bool edge = k0 + KT > Sk || (causal && k0 + KT - 1 > rlo) ||
                        (window > 0 && k0 <= rlo + 15 - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * tq + (e & 1), r = row[e >> 1];
            const bool valid = key < Sk && (!causal || key <= r) &&
                               (window <= 0 || key > r - window);
            s[j][e] = valid ? s[j][e] : kNegInf;
          }
      }

      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int j = 0; j < NKT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[h] = exp2_approx(m[h] - mx);
        m[h] = mx;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[j][e] > kNegInf ? exp2_approx(s[j][e] - m[e >> 1]) : 0.f;
          s[j][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }

#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < NDT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                   j * 8 + (lane >> 4) * 8);
          mma_bf16(o[j], a, b[0], b[1]);
          mma_bf16(o[j + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();                              // stage st is free again
  }
  cp_async_wait<0>();                             // nothing left in flight

  __nv_bfloat16* ob = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-20f);
    if (row[h] >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int col = j * 8 + 2 * tq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row[h] * D + col) =
            __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
  }
}

template <int DP, int NW, int KT, int ST>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int BH,
                      int Sq, int Sk, int D, int group, int causal, int window,
                      float scale, cudaStream_t stream) {
  auto kernel = flash_tc_kernel<DP, NW, KT, ST>;
  constexpr int BQ = 16 * NW;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ + 2 * ST * KT) * (DP + 8);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  kernel<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, D,
      group, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DP, int KT, int ST>
cudaError_t launch_tc_nw(const void* q, const void* k, const void* v, void* out, int BH,
                         int Sq, int Sk, int D, int group, int causal, int window,
                         float scale, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if ((long long)BH * ((Sq + 63) / 64) >= sms)
    return launch_tc<DP, 4, KT, ST>(q, k, v, out, BH, Sq, Sk, D, group, causal, window,
                                scale, stream);
  return launch_tc<DP, 2, KT, ST>(q, k, v, out, BH, Sq, Sk, D, group, causal, window, scale,
                              stream);
}

// bf16 q/k/v (the layout of valet_flash_attention); D % 8 == 0, D <= 256.
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v, void* out,
                            int BH, int Sq, int Sk, int D, int group, int causal,
                            int window, float scale, cudaStream_t stream) {
  if (D <= 0 || D % 8 || D > 256) return cudaErrorInvalidValue;
  if (D <= 64)
    return launch_tc_nw<64, 64, 2>(q, k, v, out, BH, Sq, Sk, D, group, causal, window,
                                scale, stream);
  if (D <= 128)
    return launch_tc_nw<128, 64, 2>(q, k, v, out, BH, Sq, Sk, D, group, causal, window,
                                 scale, stream);
  return launch_tc_nw<256, 32, 3>(q, k, v, out, BH, Sq, Sk, D, group, causal, window,
                               scale, stream);
}

}  // namespace valet
