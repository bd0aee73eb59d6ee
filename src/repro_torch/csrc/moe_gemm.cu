// Grouped products of the dropless MoE over ragged per-expert row groups,
// bf16 in, f32 accumulate (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's MoE (src/repro/models/moe.py)
// dispatches into a capacity-bounded (E, cap + 1, d) buffer and leaves the
// expert products to XLA's batched einsums; no Pallas kernel belongs to it.
// The port's dropless path (models/moe.py, `moe_ffn_dropless`) routes every
// row over all experts and computes only the entries that land on the
// experts this chip holds, with no capacity: the entries, sorted by expert,
// form one ragged row group per held expert whose size only the device
// knows.  This kernel computes those groups' products without the host
// learning the sizes: the offsets stay on the device, the grid is sized by
// a bound on the entries that the host knows, and its surplus blocks exit
// at once.
//
// Group g holds entries [offsets[g], offsets[g + 1]); w is (G, K, N)
// row-major.  Two modes, one template:
//  * gated, the experts' gate and up projections with the SwiGLU between
//    them: h[i] = bf16(silu(bf16(a[rows[i]] . w0[g]))) * bf16(a[rows[i]] . w1[g]),
//    rounded as the plain version rounds;
//  * plain, the down projection: y[i] = bf16(a[i] . w0[g]) (a[rows[i]]
//    where rows is given).
// Entries at or past `n_rows` are neither read nor written.
//
// What bounds it on this card: bytes, in decode.  With 128 rows routed
// top-10 over 72 experts a held expert sees ~18 rows, so each of its three
// 4096 x 768 bf16 matrices (6.3 MB) is read for ~36 FLOPs a weight: ~18
// FLOP/B, far under the ~295 at which the tensor cores would bound it.  A
// 2048-token prefill gives an expert ~280 rows, near the ridge.
//
// What the design does about it:
//  * A block owns one tile of BM rows of one group and a BN = 64-column
//    slab of that expert's weights, and runs over all of K: in decode (a
//    group within BM rows) every weight byte is read once.  BM is 32, or
//    64 where the groups are expected to be long (the wrapper's choice).
//  * The block finds its (group, tile) by a walk over the G + 1 offsets;
//    the grid's y holds ceil(n_rows / BM) + G tiles, a bound on the tiles
//    of any split of n_rows entries into G groups.
//  * Tiles of A (gathered rows: each thread's source rows are found once)
//    and of the weights come in by cp.async into a ring of 3 stages, rows
//    past the group's end zero-filled, so that two tiles' loads are in
//    flight while the third is multiplied.  Rows are padded by 16 bytes in
//    shared memory: ldmatrix and the 16-byte copies are free of bank
//    conflicts.
//  * mma.sync.m16n8k16 (bf16 in, f32 accumulate), A by ldmatrix, the
//    row-major weight tile by ldmatrix.trans.  Four warps, as 2 x 2 (BM 32)
//    or 4 x 1 (BM 64) over the tile.
//  * No atomics, and each output element is summed over K in one fixed
//    order wherever its row sits in a tile, so a row's result does not
//    depend on the other rows, and two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace valet {

constexpr int kMoeBN = 64;         // output columns a block owns
constexpr int kMoeBK = 64;         // K a stage holds
constexpr int kMoeStages = 3;
constexpr int kMoeThreads = 128;

template <int BM, bool GATED>
struct MoeTile {
  static constexpr int LDA = kMoeBK + 8;    // bf16 row strides: 16 bytes of padding
  static constexpr int LDB = kMoeBN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = kMoeBK * LDB;
  static constexpr int STAGE = A_ELEMS + (GATED ? 2 : 1) * B_ELEMS;
  static constexpr int SMEM_BYTES = kMoeStages * STAGE * 2;
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <int BM, bool GATED>
__global__ void __launch_bounds__(kMoeThreads)
moe_gemm_kernel(const __nv_bfloat16* __restrict__ a, const int* __restrict__ rows,
                const int* __restrict__ offsets, int groups,
                const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
                __nv_bfloat16* __restrict__ out, int K, int N, int n_rows) {
  using T = MoeTile<BM, GATED>;
  constexpr int WM = BM / 16;             // warps along M
  constexpr int WN = 4 / WM;              // warps along N
  constexpr int WNW = kMoeBN / WN;        // columns a warp owns
  constexpr int NT = WNW / 8;             // its 8-column tiles
  constexpr int CPR_A = kMoeBK / 8;       // 16-byte chunks in a row of A's tile
  constexpr int CPR_B = kMoeBN / 8;
  constexpr int A_PER = BM * CPR_A / kMoeThreads;
  constexpr int B_PER = kMoeBK * CPR_B / kMoeThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // this block's (group, tile) among the groups' tiles, in group order
  int t = blockIdx.y, g = 0, lo = 0, hi = 0;
  for (; g < groups; ++g) {
    lo = offsets[g];
    hi = offsets[g + 1];
    const int tiles = (hi - lo + BM - 1) / BM;
    if (t < tiles) break;
    t -= tiles;
  }
  if (g == groups) return;
  const int r0 = lo + t * BM;
  const int r_end = min(hi, n_rows);
  if (r0 >= r_end) return;
  const int n0 = blockIdx.x * kMoeBN;
  const size_t w_off = static_cast<size_t>(g) * K * N;
  const __nv_bfloat16* wa = w0 + w_off;
  const __nv_bfloat16* wb = GATED ? w1 + w_off : nullptr;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;

  // each thread's A chunks: source row (found once) and whether it is live
  const __nv_bfloat16* a_src[A_PER];
  int a_bytes[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int c = tid + i * kMoeThreads;
    const int e = r0 + c / CPR_A;
    const bool live = e < r_end;
    const int src = live ? (rows != nullptr ? rows[e] : e) : 0;
    a_src[i] = a + static_cast<size_t>(src) * K + (c % CPR_A) * 8;
    a_bytes[i] = live ? 16 : 0;
  }

  auto load = [&](int stage, int kt) {
    __nv_bfloat16* As = smem + stage * T::STAGE;
    __nv_bfloat16* Bs = As + T::A_ELEMS;
    const int k0 = kt * kMoeBK;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * kMoeThreads;
      cp_async16(As + (c / CPR_A) * T::LDA + (c % CPR_A) * 8, a_src[i] + k0, a_bytes[i]);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int c = tid + i * kMoeThreads;
      const int r = c / CPR_B, cc = c % CPR_B;
      const size_t src = static_cast<size_t>(k0 + r) * N + n0 + cc * 8;
      cp_async16(Bs + r * T::LDB + cc * 8, wa + src, 16);
      if constexpr (GATED) cp_async16(Bs + T::B_ELEMS + r * T::LDB + cc * 8, wb + src, 16);
    }
  };

  float acc0[NT][4], acc1[GATED ? NT : 1][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      acc0[j][v] = 0.f;
      if constexpr (GATED) acc1[j][v] = 0.f;
    }

  const int KT = K / kMoeBK;
#pragma unroll
  for (int s = 0; s < kMoeStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kMoeStages - 2>();
    __syncthreads();            // stage kt is in; every warp is done with kt - 1's
    const int nk = kt + kMoeStages - 1;
    if (nk < KT) load(nk % kMoeStages, nk);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kt % kMoeStages) * T::STAGE;
    const __nv_bfloat16* Bs = As + T::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kMoeBK; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, As + (wm * 16 + (lane & 15)) * T::LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: (k 0-7, n j), (k 8-15, n j), (k 0-7, n j+1), (k 8-15, n j+1)
        const __nv_bfloat16* bp = Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LDB +
                                  wn * WNW + j * 8 + (lane >> 4) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bp);
        mma_bf16(acc0[j], af, bf[0], bf[1]);
        mma_bf16(acc0[j + 1], af, bf[2], bf[3]);
        if constexpr (GATED) {
          ldmatrix_x4_trans(bf, bp + T::B_ELEMS);
          mma_bf16(acc1[j], af, bf[0], bf[1]);
          mma_bf16(acc1[j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * WNW + j * 8 + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = r0 + wm * 16 + gr + h * 8;
      if (e >= r_end) continue;
      __nv_bfloat162 o;
      if constexpr (GATED) {
        const float2 gt = __bfloat1622float2(__floats2bfloat162_rn(acc0[j][2 * h], acc0[j][2 * h + 1]));
        const float2 up = __bfloat1622float2(__floats2bfloat162_rn(acc1[j][2 * h], acc1[j][2 * h + 1]));
        const float2 sg = __bfloat1622float2(__floats2bfloat162_rn(silu(gt.x), silu(gt.y)));
        o = __floats2bfloat162_rn(sg.x * up.x, sg.y * up.y);
      } else {
        o = __floats2bfloat162_rn(acc0[j][2 * h], acc0[j][2 * h + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(e) * N + col) = o;
    }
  }
}

template <int BM, bool GATED>
cudaError_t launch_moe_gemm(const __nv_bfloat16* a, const int* rows, const int* offsets,
                            int groups, const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                            __nv_bfloat16* out, int K, int N, int n_rows, int max_tiles,
                            cudaStream_t stream) {
  using T = MoeTile<BM, GATED>;
  auto kernel = moe_gemm_kernel<BM, GATED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kMoeBN, max_tiles);
  kernel<<<grid, kMoeThreads, T::SMEM_BYTES, stream>>>(a, rows, offsets, groups, w0, w1, out,
                                                       K, N, n_rows);
  return cudaGetLastError();
}

}  // namespace valet

// One grouped product (gated where w1 is not null) of `groups` ragged row
// groups.  K and N must be multiples of 64; `rows` may be null (entry i
// reads row i of a); `max_tiles` is the grid's tiles, at least
// ceil(n_rows / block_m) + groups; block_m is 32 or 64.
extern "C" int valet_moe_gemm(const void* a, const int* rows, const int* offsets, int groups,
                              const void* w0, const void* w1, void* out, int K, int N,
                              int n_rows, int max_tiles, int block_m, void* stream) {
  using bf = __nv_bfloat16;
  const bf* A = static_cast<const bf*>(a);
  const bf* W0 = static_cast<const bf*>(w0);
  const bf* W1 = static_cast<const bf*>(w1);
  bf* O = static_cast<bf*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block_m == 64) {
    err = W1 != nullptr
              ? valet::launch_moe_gemm<64, true>(A, rows, offsets, groups, W0, W1, O, K, N,
                                                 n_rows, max_tiles, s)
              : valet::launch_moe_gemm<64, false>(A, rows, offsets, groups, W0, W1, O, K, N,
                                                  n_rows, max_tiles, s);
  } else {
    err = W1 != nullptr
              ? valet::launch_moe_gemm<32, true>(A, rows, offsets, groups, W0, W1, O, K, N,
                                                 n_rows, max_tiles, s)
              : valet::launch_moe_gemm<32, false>(A, rows, offsets, groups, W0, W1, O, K, N,
                                                  n_rows, max_tiles, s);
  }
  return static_cast<int>(err);
}
