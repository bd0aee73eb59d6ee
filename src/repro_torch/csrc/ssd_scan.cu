// Mamba-2 SSD chunk scan for Hopper (sm_90a), split over chunks.
//
// Replaces the Pallas kernel `ssd_scan` / `_ssd_kernel` in
// src/repro/kernels/ssd_scan.py.  Per (batch b, head h), with group
// g = h / (H / G) and chunks of Q steps:
//   lc   = cumsum(dt * A) within the chunk,  ltot = lc[Q - 1]
//   y_t  = sum_{s <= t} (C_t . B_s) exp(lc_t - lc_s) dt_s x_s
//          + exp(lc_t) (C_t . h_prev)
//   h    = exp(ltot) h_prev + sum_s exp(ltot - lc_s) dt_s x_s B_s^T
// y is written in f32 for every step; h (P x N, f32) after the last chunk.
//
// What bounds it on this card: at B = 1, how much of the card it fills and
// how fast operands reach the tensor cores.  A chunk does ~Q^2 (N + P) / 2
// + 2 Q P N multiply-adds per head on Q (P + 2 N) input values, so the work
// is small (mamba2 S=1024: ~2.4 G multiply-adds in bf16 with the split
// products below, a few microseconds at the tensor-core peak).  The TPU
// kernel carries h across a sequential grid axis; one block per (batch,
// head) doing the same fills 50-80 of 132 SMs at B = 1.
//
// What the design does about it: the reference's own decomposition
// (`ssd_chunked`) in five launches, each a grid of independent blocks:
//  0. lc (ssd_lc_kernel): the in-chunk cumulative decay, one thread per
//     (batch, chunk, head) summing in the reference's order, into a
//     (B, NC, H, Q) scratch read by the later passes.
//  1. CB: C . B^T once per (batch, chunk, group), the lower triangle of
//     64 x 64 tiles, into a (B, NC, G, Q, Q) f32 scratch; the H / G heads of
//     a group read it instead of recomputing it.
//  2. Chunk states, one block per (batch, chunk, head, 64 columns of N):
//     s_c = sum_s exp(ltot - lc_s) dt_s x_s B_s^T into a (B, NC, H, P, N)
//     scratch.  Grid B * NC * H * ceil(N / 64).
//  3. State passing (ssd_pass_kernel), elementwise over P * N per (batch,
//     head) and sequential over the NC chunks: h_c = exp(ltot_c) h_{c-1} +
//     s_c from zero, rewriting each chunk's state as the h_prev it enters
//     with, and writing h_final.
//  4. Chunk outputs, one block per (batch, chunk, head, 64 rows t), the
//     heaviest (last) row tiles first: exp(lc_t) C . h_prev^T, then, column
//     tile by column tile, the masked matrix (CB (.) exp(lc_t - lc_s)) dt_s
//     times x.
// Passes 1, 2 and 4 take 256 threads, 8 warps of 16 x 32 (or 16 x P / 2)
// output tiles, and copy their operand tiles with cp.async; pass 4 copies
// the next column tile's x, and reads its CB into registers, while the
// current tile is multiplied.
//
// bf16 x/B/C (the main paths) run on the tensor cores: mma.sync.m16n8k16
// with f32 accumulation, fragments read with ldmatrix from bf16 tiles whose
// rows are padded to 16 bytes past a multiple of 128 (no bank conflicts).
// C . B^T has two bf16 operands and is exact per product.  The other
// products have one f32 operand (dt-weighted x, h_prev, the masked matrix),
// which is rounded once into bf16 hi + lo tiles in shared memory and issued
// as two mmas (about 2^-16 relative); the masked matrix takes the SFU's
// exp (__expf) there.  f32 inputs keep the passes and the
// grid and run the same tiles as f32 FMAs (`warp_fma`), which keeps f32
// parity with the plain version.
// Rules kept: the mask is applied before the exponential (exp(lc_t - lc_s)
// is evaluated only for s <= t < Q: for s > t it may overflow, and inf * 0
// is NaN); any Q from 1 to 256 (rows and columns past Q are zero-filled and
// never written); P, N <= 128; dt = 0 steps stay exact; the wrapper
// allocates every scratch buffer; no atomics, and every sum in a fixed
// order, so two calls give the same bits.  No library call: every product
// is the code below.

#include "attn_common.cuh"
#include "mma.cuh"

namespace valet {

using bf16 = __nv_bfloat16;

constexpr int kSsdThreads = 256;          // 8 warps: 4 of rows x 2 of columns
constexpr int kSsdMaxChunk = 256;
constexpr int kSsdMaxDim = 128;           // P, N <= 128
constexpr int kTile = 64;                 // rows t (or steps s) per tile
constexpr int kLdTile = kTile + 8;        // a padded row of 64 values
constexpr int kLoads = 8;                 // loads in flight per thread
constexpr int kLcHeads = 8;               // heads per block of pass 0

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Copy rows x cols values of T (row r at src + r * stride) into shared
// memory rows of stride ld, zero-filled for r >= rows_valid or c >=
// cols_valid.  With 16-byte rows (cols, cols_valid, stride and ld multiples
// of the vector, src 16-byte aligned) the copy is asynchronous (cp.async,
// completed by the caller's wait); otherwise it is done here, a value at a
// time.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                                          long long stride, int rows_valid, int cols_valid,
                                          int rows, int cols) {
  constexpr int V = Vec<T>::N;
  if (cols % V == 0 && cols_valid % V == 0 && stride % V == 0 && ld % V == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int cpr = cols / V;
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = (e - r * cpr) * V;
      const bool ok = r < rows_valid && c < cols_valid;
      cp_async16(dst + r * ld + c, ok ? src + (long long)r * stride + c : src, ok ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ld + c] = r < rows_valid && c < cols_valid ? src[(long long)r * stride + c]
                                                       : zero<T>();
  }
}

// The warp's place in passes 1, 2 and 4: (wr, wc) = 4 rows x 2 columns.
struct WarpPos {
  int g, tq, wr, wc;
  __device__ __forceinline__ WarpPos() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    g = lane >> 2, tq = lane & 3, wr = warp & 3, wc = warp >> 2;
  }
};

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Store acc (the mma accumulator layout of 16 x 8 tiles at rows r0.. and
// columns c0 + 8 j, j < nt) into out[r * ld + c] for r < rows, c < cols.
template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], float* out, long long ld,
                                          int r0, int rows, int c0, int cols, int nt) {
  const WarpPos w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + w.g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      const int c = c0 + 8 * j + 2 * w.tq;
      if (c < cols) out[r * ld + c] = acc[j][2 * h];
      if (c + 1 < cols) out[r * ld + c + 1] = acc[j][2 * h + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: f32 tiles, f32 FMAs
// ---------------------------------------------------------------------------

// Operands of warp_fma, pairs (k, k + 1) of f32 shared memory.  KMajor:
// element (row, k) at p[row * ld + k]; KRows: at p[k * ld + row], times w[k]
// when w is given.
struct KMajor {
  const float* p;
  int ld;
  __device__ __forceinline__ float2 pair(int row, int k) const {
    return *reinterpret_cast<const float2*>(p + row * ld + k);
  }
};
struct KRows {
  const float* p;
  int ld;
  const float* w;
  __device__ __forceinline__ float2 pair(int row, int k) const {
    float2 v = make_float2(p[k * ld + row], p[(k + 1) * ld + row]);
    if (w != nullptr) v.x *= w[k], v.y *= w[k + 1];
    return v;
  }
};

// acc[j] += A . B^T over k in [0, K) (K even) for the warp's 16 x 8 output
// tiles at rows m0.. and columns n0 + 8 j (j < nt), in the mma accumulator
// layout, as f32 FMAs in k order.
template <int NT, typename OA, typename OB>
__device__ __forceinline__ void warp_fma(float (&acc)[NT][4], OA a, int m0, OB b, int n0,
                                         int nt, int K) {
  const WarpPos w;
  for (int k = 0; k < K; k += 2) {
    const float2 a0 = a.pair(m0 + w.g, k), a1 = a.pair(m0 + w.g + 8, k);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      const int c = n0 + 8 * j + 2 * w.tq;
      const float2 b0 = b.pair(c, k), b1 = b.pair(c + 1, k);
      acc[j][0] = fmaf(a0.y, b0.y, fmaf(a0.x, b0.x, acc[j][0]));
      acc[j][1] = fmaf(a0.y, b1.y, fmaf(a0.x, b1.x, acc[j][1]));
      acc[j][2] = fmaf(a1.y, b0.y, fmaf(a1.x, b0.x, acc[j][2]));
      acc[j][3] = fmaf(a1.y, b1.y, fmaf(a1.x, b1.x, acc[j][3]));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: bf16 tiles, ldmatrix + mma.sync
// ---------------------------------------------------------------------------

// Fragments from a bf16 tile of row stride ld (ld / 8 odd: the 8 rows of an
// ldmatrix matrix fall in distinct banks).  A (16 x 16 at m0, k0) from a tile
// stored [m][k] (A_MK) or [k][m]; B for the two 8-column tiles n0, n0 + 8
// (b[0..1], b[2..3]) over k0..k0+15 from a tile stored [n][k] (B_NK) or
// [k][n].
template <bool A_MK>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  if constexpr (A_MK)
    ldmatrix_x4(a, t + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
  else
    ldmatrix_x4_trans(a, t + (k0 + (l & 7) + ((l >> 4) << 3)) * ld + m0 + ((l >> 3) & 1) * 8);
}
template <bool B_NK>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* t, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31;
  if constexpr (B_NK)
    ldmatrix_x4(b, t + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + ((l >> 3) & 1) * 8);
  else
    ldmatrix_x4_trans(b, t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

// acc[j] += A . B over k in [0, K) (K a multiple of 16) for the warp's 16 x 8
// tiles at rows m0.. and columns n0 + 8 j, j < 2 NP.  A = a (+ a_lo when
// A_LO), B = b (+ b_lo when B_LO): a lo tile is the bf16 remainder of an
// f32 operand, issued as a second mma.  Everything but K is fixed at
// compile time, so the warp runs no per-tile branch.
template <int NP, bool A_MK, bool B_NK, bool A_LO, bool B_LO>
__device__ __forceinline__ void warp_mma(float (&acc)[2 * NP][4], const bf16* a,
                                         const bf16* a_lo, int lda, int m0, const bf16* b,
                                         const bf16* b_lo, int ldb, int n0, int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t ah[4], al[4];
    frag_a<A_MK>(ah, a, lda, m0, k0);
    if constexpr (A_LO) frag_a<A_MK>(al, a_lo, lda, m0, k0);
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      uint32_t bh[4];
      frag_b<B_NK>(bh, b, ldb, n0 + 16 * jp, k0);
      mma_bf16(acc[2 * jp], ah, bh[0], bh[1]);
      mma_bf16(acc[2 * jp + 1], ah, bh[2], bh[3]);
      if constexpr (A_LO) {
        mma_bf16(acc[2 * jp], al, bh[0], bh[1]);
        mma_bf16(acc[2 * jp + 1], al, bh[2], bh[3]);
      }
      if constexpr (B_LO) {
        uint32_t bl[4];
        frag_b<B_NK>(bl, b_lo, ldb, n0 + 16 * jp, k0);
        mma_bf16(acc[2 * jp], ah, bl[0], bl[1]);
        mma_bf16(acc[2 * jp + 1], ah, bl[2], bl[3]);
      }
    }
  }
}

// Two f32 values rounded to bf16 hi + lo, stored as pairs.
__device__ __forceinline__ void store_split(float2 v, bf16* hi, bf16* lo) {
  uint32_t h, l;
  split_bf16(v, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

// src (rows x cols f32, row stride cols) rounded once into bf16 hi + lo
// tiles of rows_pad x cols_pad (row stride ld), zero-padded; kLoads loads
// of 4 values in flight per thread.
__device__ __forceinline__ void split_tile(const float* __restrict__ src, int rows, int cols,
                                           int rows_pad, int cols_pad, bf16* hi, bf16* lo,
                                           int ld) {
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int cpr = cols_pad / 4, total = rows_pad * cpr;
  for (int base = threadIdx.x; base < total; base += blockDim.x * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * blockDim.x, r = e / cpr, c = (e - r * cpr) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e >= total || r >= rows || c >= cols) continue;
      const float* at = src + (long long)r * cols + c;
      if (vec) {
        v[u] = *reinterpret_cast<const float4*>(at);
      } else {
        v[u].x = at[0];
        if (c + 1 < cols) v[u].y = at[1];
        if (c + 2 < cols) v[u].z = at[2];
        if (c + 3 < cols) v[u].w = at[3];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * blockDim.x, r = e / cpr, c = (e - r * cpr) * 4;
      if (e >= total) break;
      store_split(make_float2(v[u].x, v[u].y), hi + r * ld + c, lo + r * ld + c);
      store_split(make_float2(v[u].z, v[u].w), hi + r * ld + c + 2, lo + r * ld + c + 2);
    }
  }
}

// ---- pass 0: lc = cumsum(dt * A) per (batch, chunk, head) ----------------
// blockIdx.x: 8 heads; blockIdx.y: b * NC + c.  The (Q x 8) slab of dt is
// read with coalesced loads; thread h then sums its head in step order.
__global__ void __launch_bounds__(kSsdThreads)
ssd_lc_kernel(const float* __restrict__ dt, const float* __restrict__ A,
              float* __restrict__ lc, int S, int H, int Q, int NC) {
  __shared__ float slab[kSsdMaxChunk][kLcHeads + 1];
  const int bc = blockIdx.y, h0 = blockIdx.x * kLcHeads;
  const int b = bc / NC, c = bc % NC;
  const long long row0 = (long long)b * S + (long long)c * Q;
  const int total = Q * kLcHeads;
  for (int base = threadIdx.x; base < total; base += kSsdThreads * kLoads) {
    float v[kLoads];                        // kLoads loads in flight per thread
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * kSsdThreads, t = e / kLcHeads, hl = e % kLcHeads;
      v[u] = e < total && h0 + hl < H ? dt[(row0 + t) * H + h0 + hl] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * kSsdThreads;
      if (e < total) slab[e / kLcHeads][e % kLcHeads] = v[u];
    }
  }
  __syncthreads();
  if (threadIdx.x < kLcHeads && h0 + (int)threadIdx.x < H) {
    const int hl = threadIdx.x;
    const float a = A[h0 + hl];
    float acc = 0.f;
    for (int t0 = 0; t0 < Q; t0 += kLoads) {      // kLoads steps read, then summed
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) v[u] = t0 + u < Q ? slab[t0 + u][hl] : 0.f;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (t0 + u >= Q) break;
        acc = __fadd_rn(acc, __fmul_rn(v[u], a));
        slab[t0 + u][hl] = acc;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Q * kLcHeads; e += kSsdThreads) {
    const int hl = e / Q, t = e % Q;
    if (h0 + hl < H) lc[((long long)bc * H + h0 + hl) * Q + t] = slab[t][hl];
  }
}

// ---- pass 1: CB = C . B^T per (batch, chunk, group) ----------------------
// blockIdx.x: tile pair (ti, si), si <= ti, in row order; blockIdx.y:
// (b * NC + c) * G + g.  cb: (B, NC, G, Q, Q).  Warp (wr, wc): rows
// 16 wr .. + 15 and columns 32 wc .. + 31 of the 64 x 64 tile.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
ssd_cb_kernel(const T* __restrict__ Cm, const T* __restrict__ Bm, float* __restrict__ cb,
              int S, int G, int N, int Q, int NC) {
  extern __shared__ __align__(16) float smem[];
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int si = blockIdx.x - ti * (ti + 1) / 2;
  const int bcg = blockIdx.y, gi = bcg % G, bc = bcg / G;
  const int b = bc / NC, c = bc % NC;
  const int NK = round16(N), ld = NK + 8;
  T* cs = reinterpret_cast<T*>(smem);      // 64 x ld: C rows t
  T* bs = cs + kTile * ld;                 // 64 x ld: B rows s
  const long long rs = (long long)G * N;
  const long long row0 = (long long)b * S + (long long)c * Q;
  const int t0 = ti * kTile, s0 = si * kTile;
  load_tile(cs, ld, Cm + (row0 + t0) * rs + gi * N, rs, min(kTile, Q - t0), N, kTile, NK);
  load_tile(bs, ld, Bm + (row0 + s0) * rs + gi * N, rs, min(kTile, Q - s0), N, kTile, NK);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const WarpPos w;
  const int ncols = min(32, Q - s0 - 32 * w.wc);            // may be <= 0
  const int nt = ncols > 0 ? (ncols + 7) / 8 : 0;
  if (t0 + w.wr * 16 >= Q || nt == 0) return;
  float acc[4][4];
  zero_acc(acc);
  if constexpr (sizeof(T) == 2)              // all 32 columns: B rows past Q are 0
    warp_mma<2, true, true, false, false>(acc, cs, nullptr, ld, w.wr * 16, bs, nullptr, ld,
                                          32 * w.wc, NK);
  else
    warp_fma(acc, KMajor{cs, ld}, w.wr * 16, KMajor{bs, ld}, 32 * w.wc, nt, NK);
  store_acc(acc, cb + (long long)bcg * Q * Q + s0, Q, t0 + w.wr * 16, Q, 32 * w.wc, Q - s0,
            nt);
}

// ---- pass 2: the chunk states ---------------------------------------------
// blockIdx.x: 64 columns of N; blockIdx.y: (b * NC + c) * H + h.
// states: (B, NC, H, P, N).  Warp (wr, wc) owns rows p = 16 wr (+ 64) and
// columns n0 + 32 wc .. + 31.  The chunk's x and B rows are copied while
// the weights w_s = exp(ltot - lc_s) dt_s are formed.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads, 2)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ lc, const T* __restrict__ Bm,
                 float* __restrict__ states, int S, int H, int P, int G, int N, int Q,
                 int NC) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kTc = sizeof(T) == 2;
  float* ws = smem;                         // QK: w_s, 0 past Q
  const int PK = round16(P), QK = round16(Q);
  const int ldx = kTc ? PK + 8 : PK + 4, ldb = kTc ? kLdTile : kTile + 4;
  T* xr = reinterpret_cast<T*>(ws + kSsdMaxChunk);   // QK x ldx: x rows s (bf16: hi of w x)
  T* br = xr + QK * ldx;                              // QK x ldb: B rows s
  bf16* xl = reinterpret_cast<bf16*>(br + QK * ldb);  // QK x ldx: bf16 lo of w x

  const int bch = blockIdx.y, h = bch % H, bc = bch / H;
  const int b = bc / NC, c = bc % NC, gi = h / (H / G);
  const int n0 = blockIdx.x * kTile, ncols = min(kTile, N - n0);
  const long long row0 = (long long)b * S + (long long)c * Q;
  const long long xs_stride = (long long)H * P, bs_stride = (long long)G * N;
  load_tile(xr, ldx, x + row0 * xs_stride + (long long)h * P, xs_stride, Q, P, QK, PK);
  load_tile(br, ldb, Bm + row0 * bs_stride + (long long)gi * N + n0, bs_stride, Q, ncols, QK,
            kTile);
  cp_async_commit();
  const float* lcc = lc + (long long)bch * Q;
  const float ltot = lcc[Q - 1];
  for (int t = threadIdx.x; t < QK; t += kSsdThreads)
    ws[t] = t < Q ? dt[(row0 + t) * H + h] * expf(ltot - lcc[t]) : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const WarpPos w;
  const int mt = (P > w.wr * 16) + (P > w.wr * 16 + kTile);
  const int ncols_w = min(32, ncols - 32 * w.wc);           // may be <= 0
  const int nt = ncols_w > 0 ? (ncols_w + 7) / 8 : 0;
  float* out = states + (long long)bch * P * N + n0;
  if constexpr (kTc) {
    // w_s x_s rounded once into bf16 hi (over x) + lo
    for (int e = threadIdx.x; e < QK * PK / 2; e += kSsdThreads) {
      const int s = e / (PK / 2), p = 2 * (e - s * (PK / 2));
      bf16* at = xr + s * ldx + p;
      float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
      v.x *= ws[s], v.y *= ws[s];
      store_split(v, at, xl + s * ldx + p);
    }
    __syncthreads();
    for (int i = 0; i < mt; ++i) {
      float acc[4][4];
      zero_acc(acc);
      if (nt > 0)                           // all 32 columns: B past N is 0
        warp_mma<2, false, false, true, false>(acc, xr, xl, ldx, w.wr * 16 + kTile * i, br,
                                               nullptr, ldb, 32 * w.wc, QK);
      store_acc(acc, out, N, w.wr * 16 + kTile * i, P, 32 * w.wc, ncols, nt);
    }
  } else {
    for (int i = 0; i < mt; ++i) {
      float acc[4][4];
      zero_acc(acc);
      warp_fma(acc, KRows{xr, ldx, ws}, w.wr * 16 + kTile * i, KRows{br, ldb, nullptr},
               32 * w.wc, nt, QK);
      store_acc(acc, out, N, w.wr * 16 + kTile * i, P, 32 * w.wc, ncols, nt);
    }
  }
}

// ---- pass 3: state passing over the chunks --------------------------------
// blockIdx.x: 256 elements of P * N; blockIdx.y: b * H + h.  Rewrites each
// chunk's state as the h_prev that chunk starts from; writes h_final.
__global__ void __launch_bounds__(kSsdThreads)
ssd_pass_kernel(const float* __restrict__ lc, float* __restrict__ states,
                float* __restrict__ h_final, int H, int P, int N, int Q, int NC) {
  const int e = blockIdx.x * kSsdThreads + threadIdx.x;
  if (e >= P * N) return;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long cstride = (long long)H * P * N;   // one chunk on, same head
  float* st = states + (long long)b * NC * cstride + (long long)h * P * N + e;
  const float* lt = lc + ((long long)b * NC * H + h) * Q + Q - 1;
  float run = 0.f;
  for (int c0 = 0; c0 < NC; c0 += kLoads) {       // kLoads chunks' loads in flight
    float s[kLoads], ltot[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (c0 + u < NC) {
        s[u] = st[(c0 + u) * cstride];
        ltot[u] = lt[(long long)(c0 + u) * H * Q];
      }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (c0 + u < NC) {
        st[(c0 + u) * cstride] = run;
        run = __fadd_rn(__fmul_rn(run, expf(ltot[u])), s[u]);
      }
  }
  h_final[(long long)bh * P * N + e] = run;
}

// ---- pass 4: the chunk outputs --------------------------------------------

// The masked matrix M[tl][sl] = CB[t][s] exp(lc_t - lc_s) dt_s for s <= t < Q
// (t = t0 + tl, s = s0 + sl), 0 elsewhere, over a 64 x 64 tile.  Each thread
// owns 4 runs of 4 columns: load_cb reads its CB values (issued ahead, so
// that they arrive while the tile before is multiplied), mask_cb forms M
// and hands each run to put(tl, sl, v).  FAST takes the SFU's exp.
__device__ __forceinline__ void load_cb(float (&v)[4][4], const float* __restrict__ cbb, int Q,
                                        int t0, int trows, int s0) {
  const bool vec = Q % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = threadIdx.x + kSsdThreads * i, tl = q >> 4, sl = (q & 15) * 4;
    const int t = t0 + tl;
    const float* row = cbb + (long long)t * Q + s0 + sl;
    if (tl < trows && vec && s0 + sl <= t) {
      const float4 f = *reinterpret_cast<const float4*>(row);
      v[i][0] = f.x, v[i][1] = f.y, v[i][2] = f.z, v[i][3] = f.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[i][u] = tl < trows && s0 + sl + u <= t ? row[u] : 0.f;
    }
  }
}

template <bool FAST, typename Put>
__device__ __forceinline__ void mask_cb(float (&v)[4][4], int t0, int trows, int s0,
                                        const float* lcs, const float* dts, Put put) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = threadIdx.x + kSsdThreads * i, tl = q >> 4, sl = (q & 15) * 4;
    const int t = t0 + tl;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = s0 + sl + u;
      const float d = tl < trows && s <= t ? lcs[t] - lcs[s] : 0.f;
      const float e = FAST ? __expf(d) : expf(d);
      v[i][u] = tl < trows && s <= t ? v[i][u] * e * dts[s] : 0.f;
    }
    put(tl, sl, v[i]);
  }
}

// blockIdx.x: 64 rows t, the last tile first; blockIdx.y: (b * NC + c) * H + h.
// Warp (wr, wc) owns rows t0 + 16 wr .. + 15 and columns PH wc .. + PH - 1,
// PH = round16(P) / 2 <= 8 NT.  The bf16 route multiplies all 8 NT columns
// (with NT = 2 ceil(round16(P) / 32) the reads stay inside the padded
// tiles) and stores the valid ones.
template <typename T, int NT>
__global__ void __launch_bounds__(kSsdThreads, 2)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ lc, const float* __restrict__ hprev,
               float* __restrict__ y, int S, int H, int P, int G, int N, int Q, int NC) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kTc = sizeof(T) == 2;
  const int NK = round16(N), PK = round16(P), ld1 = NK + 8;
  const int ldx = kTc ? PK + 8 : PK + 4, ldm = kLdTile;
  float* dts = smem;                                       // Q
  float* lcs = dts + kSsdMaxChunk;                         // Q
  float* ms = lcs + kSsdMaxChunk;                          // 64 x ldm, f32 route only
  // h_prev: f32 (f32 route), or its bf16 hi (hs) + lo (hl)
  T* hs = reinterpret_cast<T*>(kTc ? ms : ms + kTile * ldm);          // PK x ld1
  bf16* hl = reinterpret_cast<bf16*>(hs + PK * ld1);                  // PK x ld1
  T* cr = kTc ? reinterpret_cast<T*>(hl + PK * ld1) : hs + PK * ld1;  // 64 x ld1: C rows t
  bf16* mh = reinterpret_cast<bf16*>(cr + kTile * ld1);  // 64 x ldm: masked matrix, hi
  bf16* ml = mh + kTile * ldm;                            // 64 x ldm: and lo
  T* xr0 = kTc ? reinterpret_cast<T*>(ml + kTile * ldm) : cr + kTile * ld1;  // 2 x 64 x ldx

  const int bch = blockIdx.y, h = bch % H, bc = bch / H;
  const int b = bc / NC, c = bc % NC, gi = h / (H / G);
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int trows = min(kTile, Q - t0);
  const long long row0 = (long long)b * S + (long long)c * Q;
  const long long bs_stride = (long long)G * N, xs_stride = (long long)H * P;
  const float* cbb = cb + ((long long)bc * G + gi) * Q * Q;
  const float* hp = hprev + (long long)bch * P * N;
  auto load_x = [&](int s0, int st) {       // x rows of column tile s0 into stage st
    load_tile(xr0 + st * kTile * ldx, ldx, x + (row0 + s0) * xs_stride + (long long)h * P,
              xs_stride, min(kTile, Q - s0), P, kTile, PK);
  };
  load_tile(cr, ld1, Cm + (row0 + t0) * bs_stride + (long long)gi * N, bs_stride, trows, N,
            kTile, NK);
  if constexpr (!kTc) load_tile(hs, ld1, hp, (long long)N, P, N, PK, NK);
  load_x(0, 0);
  cp_async_commit();
  for (int t = threadIdx.x; t < Q; t += kSsdThreads) {
    dts[t] = dt[(row0 + t) * H + h];
    lcs[t] = lc[(long long)bch * Q + t];
  }
  if constexpr (kTc) split_tile(hp, P, N, PK, NK, hs, hl, ld1);
  float cbv[4][4];                          // CB of the next column tile
  load_cb(cbv, cbb, Q, t0, trows, 0);
  cp_async_wait<0>();
  __syncthreads();

  const WarpPos w;
  const int PH = PK / 2;
  const int ncols = min(PH, P - PH * w.wc);                 // may be <= 0
  const int nt = ncols > 0 ? (ncols + 7) / 8 : 0;
  const bool busy = w.wr * 16 < trows && nt > 0;
  float acc[NT][4];
  zero_acc(acc);
  // inter-chunk: exp(lc_t) * (C_t . h_prev)
  if (busy) {
    if constexpr (kTc)
      warp_mma<NT / 2, true, true, false, true>(acc, cr, nullptr, ld1, w.wr * 16, hs, hl, ld1,
                                                PH * w.wc, NK);
    else
      warp_fma(acc, KMajor{cr, ld1}, w.wr * 16, KMajor{hs, ld1}, PH * w.wc, nt, NK);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + w.wr * 16 + w.g + 8 * hh;
    const float e = t < Q ? expf(lcs[t]) : 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][2 * hh] *= e;
      acc[j][2 * hh + 1] *= e;
    }
  }

  // intra-chunk: the column tiles up to this tile's last row
  const int wrow_end = min(t0 + w.wr * 16 + 16, Q);       // this warp's rows end
  const int n_cols = (t0 + trows + kTile - 1) / kTile;
  for (int it = 0; it < n_cols; ++it) {
    const int s0 = it * kTile, st = it & 1;
    const bool next = it + 1 < n_cols;
    if (next) load_x(s0 + kTile, st ^ 1);
    cp_async_commit();
    if constexpr (kTc)
      mask_cb<true>(cbv, t0, trows, s0, lcs, dts, [&](int tl, int sl, const float (&v)[4]) {
        store_split(make_float2(v[0], v[1]), mh + tl * ldm + sl, ml + tl * ldm + sl);
        store_split(make_float2(v[2], v[3]), mh + tl * ldm + sl + 2, ml + tl * ldm + sl + 2);
      });
    else
      mask_cb<false>(cbv, t0, trows, s0, lcs, dts, [&](int tl, int sl, const float (&v)[4]) {
        *reinterpret_cast<float4*>(ms + tl * ldm + sl) = make_float4(v[0], v[1], v[2], v[3]);
      });
    if (next) load_cb(cbv, cbb, Q, t0, trows, s0 + kTile);   // lands during the product
    cp_async_wait<1>();                     // x of column tile it has landed
    __syncthreads();
    const int kw = min(kTile, wrow_end - s0);            // columns s <= this warp's rows
    const T* xs = xr0 + st * kTile * ldx;
    if (busy && kw > 0) {
      if constexpr (kTc)
        warp_mma<NT / 2, true, false, true, false>(acc, mh, ml, ldm, w.wr * 16, xs, nullptr,
                                                   ldx, PH * w.wc, round16(kw));
      else
        warp_fma(acc, KMajor{ms, ldm}, w.wr * 16, KRows{xs, ldx, nullptr}, PH * w.wc, nt,
                 round16(kw));
    }
    __syncthreads();                        // the masked tile and stage st are free
  }
  cp_async_wait<0>();
  if (busy)
    store_acc(acc, y + row0 * xs_stride + (long long)h * P, xs_stride, t0 + w.wr * 16, Q,
              PH * w.wc, P, nt);
}

template <typename T>
cudaError_t launch_ssd(const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, float* y, float* h_out, float* cb, float* lc,
                       float* states, int B, int S, int H, int P, int G, int N, int Q,
                       cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || Q > kSsdMaxChunk || S % Q || G <= 0 || H % G ||
      P <= 0 || P > kSsdMaxDim || N <= 0 || N > kSsdMaxDim)
    return cudaErrorInvalidValue;
  constexpr bool kTc = sizeof(T) == 2;
  const int NC = S / Q, nt = (Q + kTile - 1) / kTile;
  const size_t NK = round16(N), PK = round16(P), QK = round16(Q), ld1 = NK + 8;
  const size_t ldx = kTc ? PK + 8 : PK + 4, ldb = kTc ? kLdTile : kTile + 4;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  cudaError_t err;

  ssd_lc_kernel<<<dim3((H + kLcHeads - 1) / kLcHeads, B * NC), kSsdThreads, 0, stream>>>(
      dt, A, lc, S, H, Q, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_cb = sizeof(T) * 2 * kTile * ld1;
  err = allow_smem(ssd_cb_kernel<T>, smem_cb);
  if (err != cudaSuccess) return err;
  ssd_cb_kernel<T><<<dim3(nt * (nt + 1) / 2, B * NC * G), kSsdThreads, smem_cb, stream>>>(
      ct, bt, cb, S, G, N, Q, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_state = sizeof(float) * kSsdMaxChunk + sizeof(T) * QK * (ldx + ldb) +
                            (kTc ? sizeof(bf16) * QK * ldx : 0);
  err = allow_smem(ssd_state_kernel<T>, smem_state);
  if (err != cudaSuccess) return err;
  ssd_state_kernel<T><<<dim3((N + kTile - 1) / kTile, B * NC * H), kSsdThreads, smem_state,
                        stream>>>(xt, dt, lc, bt, states, S, H, P, G, N, Q, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_pass_kernel<<<dim3((P * N + kSsdThreads - 1) / kSsdThreads, B * H), kSsdThreads, 0,
                    stream>>>(lc, states, h_out, H, P, N, Q, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_out =
      sizeof(float) * 2 * kSsdMaxChunk +
      (kTc ? sizeof(bf16) * (2 * PK * ld1 + kTile * ld1 + 2 * kTile * kLdTile + 2 * kTile * ldx)
           : sizeof(float) * (kTile * kLdTile + PK * ld1 + kTile * ld1 + 2 * kTile * ldx));
  // 8 NT columns per warp, NT = 2 ceil(PK / 32) on the bf16 route
  auto out_kernel = ssd_out_kernel<T, 8>;
  if constexpr (kTc) {
    if (PK <= 32)
      out_kernel = ssd_out_kernel<T, 2>;
    else if (PK <= 64)
      out_kernel = ssd_out_kernel<T, 4>;
    else if (PK <= 96)
      out_kernel = ssd_out_kernel<T, 6>;
  }
  err = allow_smem(out_kernel, smem_out);
  if (err != cudaSuccess) return err;
  out_kernel<<<dim3(nt, B * NC * H), kSsdThreads, smem_out, stream>>>(
      xt, dt, ct, cb, lc, states, y, S, H, P, G, N, Q, NC);
  return cudaGetLastError();
}

}  // namespace valet

// C interface (bound with ctypes).  x: (B, S, H, P) and B/C: (B, S, G, N) in
// f32 or bf16 (`dtype`), contiguous; dt: (B, S, H) f32; A: (H,) f32;
// y: (B, S, H, P) f32; h_final: (B, H, P, N) f32.  S % chunk == 0.  Scratch,
// f32, allocated by the caller: cb (B, NC, G, chunk, chunk), lc (B, NC, H,
// chunk), states (B, NC, H, P, N), NC = S / chunk.  Launches the five passes
// on `stream` and returns the first failing cudaError_t (0 when all launched).
extern "C" int valet_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y, void* h_final,
                              void* cb, void* lc, void* states, int B, int S, int H, int P,
                              int G, int N, int chunk, int dtype, void* stream) {
  using namespace valet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_final);
  float* cbf = static_cast<float*>(cb);
  float* lcf = static_cast<float*>(lc);
  float* stf = static_cast<float*>(states);
  if (dtype == kF32)
    return launch_ssd<float>(x, dtf, Af, Bm, Cm, yf, hf, cbf, lcf, stf, B, S, H, P, G, N,
                             chunk, s);
  if (dtype == kBF16)
    return launch_ssd<bf16>(x, dtf, Af, Bm, Cm, yf, hf, cbf, lcf, stf, B, S, H, P, G, N,
                            chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
