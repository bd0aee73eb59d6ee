// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `paged_attention` / `_paged_kernel` in
// src/repro/kernels/paged_attention.py: one query token per sequence attends
// over KV pages scattered through the page pool, reached through the block
// table, with an online softmax (m, l, acc in f32).  A slot of -1 is skipped,
// positions at or beyond `length` are masked, and l is clamped at 1e-20.
//
// What bounds it on this card: bytes.  Each live KV element is read once
// and used for G (query heads per KV head) multiply-adds, far below the
// ~295 operations per byte where the H100's compute would be the limit.
//
// What the design does about it:
//  * One block per (sequence, KV head) serves all G query heads of the group,
//    so every K/V page tile is read from device memory exactly once.
//  * The block reads its own block-table row and length and walks the
//    sequence's pages in order, in chunks of up to 64 tokens, with 16-byte
//    coalesced loads (a token's D values are contiguous), several in flight
//    per thread.  No load is issued for a -1 slot or for tokens past the
//    length: those rows of the tile are zero-filled and masked.  No gathered
//    copy of the KV is ever written.
//  * Warp w owns query heads g = w, w + 4, ...; lane j owns token j of each
//    32-token step, so the score row of a head lives in one warp and m and l
//    are warp-reduced in registers; acc (G x D) is spread over the lanes'
//    registers (d = lane + 32 k).
//  * Shared-memory rows have a stride of D + 4 floats, so the lanes' 16-byte
//    reads of 32 different key rows hit distinct banks.
// Simple first: no split over the sequence and no cp.async pipelining yet,
// so with B * Hkv blocks below the SM count the card is not saturated.

#include "attn_common.cuh"

namespace valet {

constexpr int kMaxGroupPerWarp = 4;   // G <= 16
constexpr int kMaxCols = 8;           // D <= 256 (d = lane + 32 k)
constexpr int kMaxSteps = 8;          // chunk <= 256 tokens

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool, const int* __restrict__ block_table,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    int Hkv, int G, int D, int page, int P, int chunk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int SD = D + 4;
  float* qs = smem;                       // G x SD
  float* ks = qs + G * SD;                // chunk x SD
  float* vs = ks + chunk * SD;            // chunk x SD
  int* slots = reinterpret_cast<int*>(vs + chunk * SD);   // chunk / page

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const int length = lengths[b];
  const int ppc = chunk / page;
  const int steps = chunk / 32;

  // the group's G query rows: contiguous (G * D) values
  const QT* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  stage_rows<QT, 8>(qb, qs, nullptr, nullptr, G, D, SD,
                    [&](int g) { return (long long)g * D; });

  float m[kMaxGroupPerWarp], l[kMaxGroupPerWarp];
  float acc[kMaxGroupPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kMaxGroupPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  const int n_tok = min(length, P * page);
  for (int c0 = 0; c0 < n_tok; c0 += chunk) {
    __syncthreads();   // the previous chunk's tiles are consumed
    if (tid < ppc) {
      int pi = c0 / page + tid;
      slots[tid] = pi < P ? block_table[(size_t)b * P + pi] : -1;
    }
    __syncthreads();
    // token t's row in the pool, or -1 (zero-filled, no load issued) for a
    // -1 slot or a position past the length
    stage_rows<KT, 4>(k_pool, ks, v_pool, vs, chunk, D, SD, [&](int t) {
      const int slot = slots[t / page];
      return (slot >= 0 && c0 + t < length)
                 ? (long long)((((size_t)slot * page + t % page) * Hkv + h) * D)
                 : -1LL;
    });
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kMaxGroupPerWarp; ++r) {
      const int g = warp + kWarps * r;
      if (g >= G) break;                        // warp-uniform
      float s[kMaxSteps];
      float mx = kNegInf;
#pragma unroll
      for (int st = 0; st < kMaxSteps; ++st) {
        if (st >= steps) break;
        int t = st * 32 + lane;
        bool live = slots[t / page] >= 0 && c0 + t < length;
        s[st] = live ? dot_row(qs + g * SD, ks + t * SD, D) * scale : kNegInf;
        mx = fmaxf(mx, s[st]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int st = 0; st < kMaxSteps; ++st) {
        if (st >= steps) break;
        int t = st * 32 + lane;
        bool live = slots[t / page] >= 0 && c0 + t < length;
        s[st] = live ? expf(s[st] - m_new) : 0.f;   // s now holds p
        psum += s[st];
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int st = 0; st < kMaxSteps; ++st) {
        if (st >= steps) break;
        for (int j = 0; j < 32; ++j) {
          const float pj = __shfl_sync(0xffffffffu, s[st], j);
          const float* vrow = vs + (st * 32 + j) * SD;
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[r][c] = fmaf(pj, vrow[d], acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxGroupPerWarp; ++r) {
    const int g = warp + kWarps * r;
    if (g >= G) break;
    const float lc = fmaxf(l[r], 1e-20f);
    QT* o = out + ((size_t)b * Hq + (size_t)h * G + g) * D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store_out(o + d, acc[r][c] / lc);
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch_paged(const void* q, const void* k_pool, const void* v_pool,
                         const int* block_table, const int* lengths, void* out,
                         int B, int Hkv, int G, int D, int page, int P, int chunk,
                         float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, KT>;
  const size_t smem = sizeof(float) * (size_t)(G + 2 * chunk) * (D + 4) +
                      sizeof(int) * (size_t)(chunk / page);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), block_table, lengths, static_cast<QT*>(out),
      Hkv, G, D, page, P, chunk, scale);
  return cudaGetLastError();
}

}  // namespace valet

// C interface (bound with ctypes).  q/out: (B, Hkv*G, D) contiguous;
// pools: (n_slots, page, Hkv, D) contiguous; block_table: (B, P) int32;
// lengths: (B,) int32.  Returns the cudaError_t of the launch.
extern "C" int valet_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* block_table,
                                     const void* lengths, void* out, int B, int Hkv,
                                     int G, int D, int page, int P, int chunk,
                                     int q_dtype, int kv_dtype, float scale,
                                     void* stream) {
  using namespace valet;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_paged<float, float>(q, k_pool, v_pool, bt, ln, out, B, Hkv, G, D,
                                      page, P, chunk, scale, s);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch_paged<float, __nv_bfloat16>(q, k_pool, v_pool, bt, ln, out, B, Hkv,
                                              G, D, page, P, chunk, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch_paged<__nv_bfloat16, float>(q, k_pool, v_pool, bt, ln, out, B, Hkv,
                                              G, D, page, P, chunk, scale, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_paged<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, bt, ln, out,
                                                      B, Hkv, G, D, page, P, chunk,
                                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
