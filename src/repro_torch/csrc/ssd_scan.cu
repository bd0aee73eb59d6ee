// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `ssd_scan` / `_ssd_kernel` in
// src/repro/kernels/ssd_scan.py.  Per (batch b, head h), with group
// g = h / (H / G), the chunks of Q steps run in order:
//   lc   = cumsum(dt * A) within the chunk,  ltot = lc[Q - 1]
//   y_t  = sum_{s <= t} (C_t . B_s) exp(lc_t - lc_s) dt_s x_s
//          + exp(lc_t) (C_t . h_prev)
//   h    = exp(ltot) h_prev + sum_s exp(ltot - lc_s) dt_s x_s B_s^T
// y is written in f32 for every step; h (P x N, f32) after the last chunk.
//
// What bounds it on this card: operations.  A chunk of Q steps does
// ~Q^2 (N + P) / 2 + 2 Q P N multiply-adds per head on Q (P + 2 N) input
// values, hundreds of operations per byte.  This first version runs them
// as f32 FMAs on the CUDA cores, out of shared memory (no tensor cores).
//
// What the design does:
//  * One block per (b, h) loops over the chunks in order and keeps h in
//    shared memory, so the state never leaves the SM (the TPU kernel keeps
//    it in VMEM scratch across its sequential grid axis).  Engine prefills
//    are B = 1, so the grid is H blocks (80 for mamba2, 50 for hymba) on 132
//    SMs: the card is not filled.  Splitting the scan over chunks (chunk
//    states, a state-passing pass, then the chunk outputs) is later work.
//  * A chunk (up to 256 steps) does not fit in shared memory whole, so its
//    rows t and columns s are tiled by 64, and bf16 inputs are widened to
//    f32 as they are staged.  Rows of B, C and h have an odd stride (N + 1
//    floats) so the 16 lanes reading 16 different rows hit distinct banks.
//  * y of the whole chunk is computed before the state update, so every
//    C_t . h_prev reads h_prev before it is overwritten.
//  * The mask is applied before the exponential: exp(lc_t - lc_s) is only
//    evaluated for s <= t < Q (for s > t it is > 1 and may overflow, and
//    inf * 0 would be NaN).  Columns past the tile's last row are skipped.
//  * Q is any length from 1 to 256 (a 77-token prompt is one 77-step
//    chunk); rows and columns past Q are zero-filled and never written.
//  * C . B^T is shared by the H / G heads of a group, but each head's block
//    recomputes it, as the TPU kernel does.
//  * lc is summed sequentially by one thread, in the reference's order.
// No cuBLAS or other library call: every product is the loops below.

#include "attn_common.cuh"

namespace valet {

constexpr int kSsdThreads = 256;          // a 16 x 16 grid of threads
constexpr int kSsdTile = 64;              // chunk rows t / columns s per tile
constexpr int kSsdMaxChunk = 256;
constexpr int kSsdMaxDim = 128;           // P, N <= 128
constexpr int kRows = kSsdTile / 16;      // tile rows (columns) per thread
constexpr int kCols = kSsdMaxDim / 16;    // P or N columns per thread, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Stage `rows` rows of `cols` values (row r at src + r * stride) into f32
// shared-memory rows of stride ld; rows at or past `valid` are zero-filled
// and not loaded.  Neighbouring threads read neighbouring values of a row,
// and each thread issues kLoads loads before it waits on any of them.
constexpr int kLoads = 8;
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long stride,
                                      int valid, int rows, int cols, float* dst,
                                      int ld) {
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += kSsdThreads * kLoads) {
    T v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * kSsdThreads;
      const int r = e / cols, c = e - r * cols;
      v[u] = (e < total && r < valid) ? src[(long long)r * stride + c] : zero<T>();
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * kSsdThreads;
      const int r = e / cols, c = e - r * cols;
      if (e < total) dst[r * ld + c] = to_f32(v[u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int G, int N,
                int Q) {
  extern __shared__ __align__(16) float smem[];
  const int LN = N + 1;                   // odd row stride of h, C and B
  const int LT = kSsdTile + 1;            // odd row stride of the M tile
  float* hs = smem;                       // P x LN      the state h[p][n]
  float* cs = hs + P * LN;                // tile x LN   C rows of the row tile
  float* bs = cs + kSsdTile * LN;         // tile x LN   B rows of the column tile
  float* xs = bs + kSsdTile * LN;         // tile x P    x rows of the column tile
  float* ms = xs + kSsdTile * P;          // tile x LT   masked, decayed C B^T dt
  float* lc = ms + kSsdTile * LT;         // Q           cumsum of dt * A
  float* dts = lc + kSsdMaxChunk;         // Q           dt
  float* ws = dts + kSsdMaxChunk;         // Q           exp(ltot - lc_s) dt_s

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int pn = (P + 15) / 16, nn = (N + 15) / 16;   // column groups in use
  const float a = A[h];
  const long long xstride = (long long)H * P, bstride = (long long)G * N;
  const T* xb = x + (long long)b * S * xstride + (long long)h * P;
  const T* bb = Bm + (long long)b * S * bstride + (long long)g * N;
  const T* cb = Cm + (long long)b * S * bstride + (long long)g * N;
  const float* dtb = dt + (long long)b * S * H + h;
  float* yb = y + (long long)b * S * xstride + (long long)h * P;

  for (int e = threadIdx.x; e < P * LN; e += kSsdThreads) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                      // the previous chunk is consumed
    for (int t = threadIdx.x; t < Q; t += kSsdThreads)
      dts[t] = dtb[(long long)(c0 + t) * H];
    __syncthreads();
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += dts[t] * a;
        lc[t] = acc;
      }
    }
    __syncthreads();
    const float ltot = lc[Q - 1];
    for (int t = threadIdx.x; t < Q; t += kSsdThreads)
      ws[t] = expf(ltot - lc[t]) * dts[t];

    // ---- y of the chunk, one tile of 64 rows at a time (reads h_prev) ----
    // thread (ty, tx) owns rows t = ty + 16 i and columns p = tx + 16 j
    for (int t0 = 0; t0 < Q; t0 += kSsdTile) {
      const int trows = min(kSsdTile, Q - t0);
      __syncthreads();                    // cs, bs, xs and ms are free
      stage(cb + (long long)(c0 + t0) * bstride, bstride, trows, kSsdTile, N, cs, LN);
      __syncthreads();
      float acc[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
      // inter-chunk: exp(lc_t) * sum_n C_t[n] h_prev[p][n]
      for (int k = 0; k < N; ++k) {
        float cv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) cv[i] = cs[(ty + 16 * i) * LN + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (j >= pn) break;
          const int p = tx + 16 * j;
          const float hv = p < P ? hs[p * LN + k] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(cv[i], hv, acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = ty + 16 * i;
        const float e = t < trows ? expf(lc[t0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] *= e;
      }
      // intra-chunk: the column tiles up to this tile's last row
      for (int s0 = 0; s0 < t0 + trows; s0 += kSsdTile) {
        const int srows = min(kSsdTile, Q - s0);
        __syncthreads();                  // bs, xs and ms are free
        stage(bb + (long long)(c0 + s0) * bstride, bstride, srows, kSsdTile, N, bs, LN);
        stage(xb + (long long)(c0 + s0) * xstride, xstride, srows, kSsdTile, P, xs, P);
        __syncthreads();
        // thread (ty, tx) owns M rows ty + 16 i and columns tx + 16 j
        float m[kRows][kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) m[i][j] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[kRows], bv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            cv[i] = cs[(ty + 16 * i) * LN + k];
            bv[i] = bs[(tx + 16 * i) * LN + k];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kRows; ++j) m[i][j] = fmaf(cv[i], bv[j], m[i][j]);
        }
        // mask before the exponential: only s <= t < Q is evaluated
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int tl = ty + 16 * i, t = t0 + tl;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int sl = tx + 16 * j, s = s0 + sl;
            ms[tl * LT + sl] = (tl < trows && s <= t)
                                   ? m[i][j] * expf(lc[t] - lc[s]) * dts[s]
                                   : 0.f;
          }
        }
        __syncthreads();
        const int scols = min(kSsdTile, t0 + trows - s0);   // columns with a live entry
        for (int sl = 0; sl < scols; ++sl) {
          float mv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) mv[i] = ms[(ty + 16 * i) * LT + sl];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if (j >= pn) break;
            const int p = tx + 16 * j;
            const float xv = p < P ? xs[sl * P + p] : 0.f;
#pragma unroll
            for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(mv[i], xv, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = ty + 16 * i;
        if (t < trows) {
          float* yr = yb + (long long)(c0 + t0 + t) * xstride;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if (j >= pn) break;
            const int p = tx + 16 * j;
            if (p < P) yr[p] = acc[i][j];
          }
        }
      }
    }

    // ---- state: h = exp(ltot) h_prev + sum_s ws_s x_s B_s^T ---------------
    // thread (ty, tx) owns h[p][n] for p = ty + 16 i and n = tx + 16 j
    float hacc[kCols][kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) hacc[i][j] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += kSsdTile) {
      const int srows = min(kSsdTile, Q - s0);
      __syncthreads();                    // bs and xs are free; y is done with h
      stage(bb + (long long)(c0 + s0) * bstride, bstride, srows, kSsdTile, N, bs, LN);
      stage(xb + (long long)(c0 + s0) * xstride, xstride, srows, kSsdTile, P, xs, P);
      __syncthreads();
      for (int sl = 0; sl < srows; ++sl) {
        const float w = ws[s0 + sl];
        float xv[kCols], bv[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          if (i >= pn) break;
          const int p = ty + 16 * i;
          xv[i] = p < P ? w * xs[sl * P + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (j >= nn) break;
          const int n = tx + 16 * j;
          bv[j] = n < N ? bs[sl * LN + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          if (i >= pn) break;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if (j >= nn) break;
            hacc[i][j] = fmaf(xv[i], bv[j], hacc[i][j]);
          }
        }
      }
    }
    const float decay = expf(ltot);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (i >= pn) break;
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (j >= nn) break;
        const int n = tx + 16 * j;
        if (p < P && n < N) hs[p * LN + n] = fmaf(decay, hs[p * LN + n], hacc[i][j]);
      }
    }
  }
  __syncthreads();
  float* hb = h_out + ((long long)b * H + h) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kSsdThreads)
    hb[e] = hs[(e / N) * LN + e % N];
}

template <typename T>
cudaError_t launch_ssd(const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, float* y, float* h_out, int B, int S, int H,
                       int P, int G, int N, int Q, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || Q > kSsdMaxChunk || S % Q || G <= 0 || H % G ||
      P <= 0 || P > kSsdMaxDim || N <= 0 || N > kSsdMaxDim)
    return cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T>;
  const size_t smem = sizeof(float) * ((size_t)P * (N + 1) + 2 * (size_t)kSsdTile * (N + 1) +
                                       (size_t)kSsdTile * P +
                                       (size_t)kSsdTile * (kSsdTile + 1) + 3 * kSsdMaxChunk);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kernel<<<grid, kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, h_out, S, H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace valet

// C interface (bound with ctypes).  x: (B, S, H, P) and B/C: (B, S, G, N) in
// f32 or bf16 (`dtype`), contiguous; dt: (B, S, H) f32; A: (H,) f32;
// y: (B, S, H, P) f32; h_final: (B, H, P, N) f32.  S % chunk == 0.
// Returns the cudaError_t of the launch.
extern "C" int valet_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y, void* h_final,
                              int B, int S, int H, int P, int G, int N, int chunk,
                              int dtype, void* stream) {
  using namespace valet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_final);
  if (dtype == kF32)
    return launch_ssd<float>(x, dtf, Af, Bm, Cm, yf, hf, B, S, H, P, G, N, chunk, s);
  if (dtype == kBF16)
    return launch_ssd<__nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, hf, B, S, H, P, G, N,
                                     chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
