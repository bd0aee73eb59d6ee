// Paged decode attention for Hopper (sm_90a), split over the sequence
// ("flash-decoding") in two passes.
//
// Replaces the Pallas kernel `paged_attention` / `_paged_kernel` in
// src/repro/kernels/paged_attention.py: one query token per sequence attends
// over KV pages scattered through the page pool, reached through the block
// table, with an online softmax (m, l, acc in f32); q head i reads KV head
// i // G.  A slot of -1 is skipped, positions at or beyond `length` are
// masked, l is clamped at 1e-20 and the output is in q's dtype.  No gathered
// copy of the KV is ever written: the table lookup is fused into the loads.
//
// What bounds it on this card: bytes.  Each live KV element is read once and
// used for G (query heads per KV head, <= 16) multiply-adds, far below the
// ~295 operations per byte where the H100's compute would be the limit.  So
// the design keeps loads in flight on every SM and spends few instructions
// per FMA: on the card, the math's instruction count, not the loads, set
// the pace at G <= 5.
//
// What the design does about it:
//  * Pass 1, grid (Hkv, splits, B): each block takes one run of `run` tokens
//    (whole pages, whole tiles) of one (sequence, KV head) and
//    serves all G query heads of the group, so a KV tile is read from device
//    memory once.  The number of splits is a function of static shapes only
//    (the wrapper's `split_plan`): it fills the card whatever the batch, and
//    a row's result never depends on the other rows of its batch.  A block
//    whose run starts at or past its row's length exits before any load.
//  * The block reads its run's block-table entries once into shared memory
//    and turns them into one pool row per token (-1 for a -1 slot or a
//    position past the length).  K and V tiles of T tokens (32, or 64 when a
//    row is at most 256 bytes) then stream through a ring of kStages = 2
//    stages with 16-byte cp.async, the next tile's loads in flight while the
//    current tile is computed (a third stage measured no faster: it costs a
//    block per SM); a -1 row is zero-filled by the src-size-0 form, with no
//    load issued and no branch.  KV stays in its stored dtype in shared
//    memory (16-byte chunks swizzled so that the reads below are free of
//    bank conflicts) and is widened to f32 on read.
//  * Heads are padded to GM = 4, 8 or 16 (q = 0 for the padding, results
//    dropped), so that every loop over heads has a compile-time count: with
//    a runtime G, the unrolled loops compiled to a branch per head and more
//    moves than FMAs.
//  * Q.K^T: warp w takes tokens 8w..8w+7 (+ 32) of the tile; the 4 lanes of
//    a token split its chunks and sum all heads (q in shared memory), then
//    add across the 4 with two shuffles.  So each K element is read from
//    shared memory once, and the heads' FMA chains run side by side.
//  * The online softmax: warp w owns heads w, w + 4, ..., lane j tokens j
//    (and j + 32); max and sum are warp-reduced in registers.
//  * P.V: warps split the tile's tokens (and, for large G * D, the heads);
//    a lane owns 4-value slices of D for the warp's heads and walks the
//    warp's tokens (lane groups take tokens of their own when D / 4 < 32),
//    p read from shared memory 4 heads at a time.  Each V element is read
//    from shared memory once.  At the end of the run the warps' sums are
//    added in a fixed order.
//  * With one split the block writes the output.  Otherwise it writes its
//    partial (m, l, acc) in f32 to the wrapper's workspace, and pass 2
//    combines each (sequence, q head) over its live splits in split order, as
//    models/attention.py `combine_partials` does.  Every sum runs in a fixed
//    order and there are no atomics, so the kernel repeats bit for bit.

//
// The partial entry (`valet_paged_attention_partials`) is the same two passes
// for one peer of a sharded pool (src/repro/launch/serve_step.py: KV pages
// round-robin over `kvr` ranks): local page j of rank `my` holds absolute
// positions (j * kvr + my) * page + o, so the valid tokens of a row are
// still a prefix of its local pages (`local_tokens`), and the blocks and
// splits are planned over that prefix as above.  It returns the row's f32
// partial softmax (m, l, acc) unnormalised -- pass 2 combines the splits
// without the division -- for the peers' partials to be combined by one
// small collective.  Its pools may also be int8 with one scale per (slot,
// position, head) in q's dtype: a value is widened as the reference does
// (int8 -> q's dtype, times the scale rounded to q's dtype, then f32), on
// read from shared memory; the tile's scales are staged beside it.

#include <type_traits>

#include "attn_common.cuh"
#include "mma.cuh"

namespace valet {

constexpr int kPagedWarps = 4;         // warps of a pass-1 block
constexpr int kPagedThreads = 32 * kPagedWarps;
constexpr int kStages = 2;             // tiles in the cp.async ring

// Four stored values at p (aligned to their size) widened to f32.
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4_f32(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

// 16 stored bytes at p (16-byte aligned) widened to f32.
__device__ __forceinline__ void load16_f32(const float* p, float4 (&v)[1]) {
  v[0] = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* p, float4 (&v)[2]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  v[0] = make_float4(a.x, a.y, b.x, b.y);
  v[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ void load16_f32(const int8_t* p, float4 (&v)[4]) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = make_float4(c[e].x, c[e].y, c[e].z, c[e].w);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// An int8 value x times its scale s (both as f32) widened as the reference
// does: the product in the scale's type QT -- exact in f32 for an int8 times
// a bf16, then rounded once to bf16 -- then f32.
__device__ __forceinline__ float dequant(float x, float s, const float*) { return x * s; }
__device__ __forceinline__ float dequant(float x, float s, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x * s));
}
template <typename QT>
__device__ __forceinline__ float4 dequant4(float4 v, float s) {
  const QT* tag = nullptr;
  return make_float4(dequant(v.x, s, tag), dequant(v.y, s, tag), dequant(v.z, s, tag),
                     dequant(v.w, s, tag));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// s += a * b, element by element
__device__ __forceinline__ void fma4(float4 a, float4 b, float4& s) {
  s.x = fmaf(a.x, b.x, s.x);
  s.y = fmaf(a.y, b.y, s.y);
  s.z = fmaf(a.z, b.z, s.z);
  s.w = fmaf(a.w, b.w, s.w);
}
__device__ __forceinline__ void fma4(float a, float4 b, float4& s) {
  fma4(make_float4(a, a, a, a), b, s);
}

// One call's arguments on the host, unpacked into the kernels' parameters
// (kept separate and __restrict__: with a struct parameter the compiler
// gave up the read-only loads of q, the table and the lengths).
// Pools are (n_slots, page, Hkv, D); with int8 pools k_scale/v_scale are
// (n_slots, page, Hkv) in q's dtype.  `partial`: write the unnormalised f32
// partials to out_ml (B, Hq, 2: m, l) and out_acc (B, Hq, D) instead of the
// output to `out`.  Local page j holds absolute positions (j * kvr + my) *
// page + o, and a row's valid positions are those below its length.
struct PagedArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const int* block_table;
  const int* lengths;
  void* out;
  float* out_ml;
  float* out_acc;
  float* ws_ml;
  float* ws_acc;
  int B, Hkv, G, D, page, P, run, n_splits, kvr, my, partial;
  float scale;
};

// How many of a row's local tokens are valid: they are a prefix of its local
// pages, since the absolute position grows with the local index.  Absolute
// pages 0 .. full - 1 are whole and page `full` holds `rem` tokens; this
// rank holds the absolute pages my, my + kvr, ...
__device__ __forceinline__ int local_tokens(int len, int page, int P, int kvr, int my) {
  len = max(len, 0);
  if (kvr == 1) return min(len, P * page);
  const int full = len / page, rem = len - full * page;
  const int whole = full > my ? (full - my + kvr - 1) / kvr : 0;
  return min(whole * page + (full % kvr == my ? rem : 0), P * page);
}

// The geometry of pass 1 for one call, the same on the host (shared-memory
// size) and in the kernel.  GM is G rounded up to 4, 8 or 16: the padded
// heads have q = 0 and are computed and dropped, so that every loop over
// heads has a compile-time count and no branch.
struct Geometry {
  // K/V rows in shared memory: `cpr` 16-byte chunks of N stored values.
  // With cpr % 8 == 0, chunk k of row r sits at k ^ 4 (r & 1), so that the
  // 4 lanes reading 64 bytes of a token in Q.K^T and the 4 reading the next
  // token hit distinct banks; otherwise rows are padded by one chunk.
  int cpr, swz, rs;                            // rs: row stride in stored values
  // P.V: warps split the tile's tokens (n_tg groups) and the heads (n_hg
  // groups of hw heads); a lane holds hw * kd float4 sums (<= 8).  Lanes
  // form groups of `lw` (a power of 2 >= D / 4, at least 4), each group a
  // token of its own, so that D = 64 keeps every lane busy.
  int kd, n_hg, hw, lw;
  int kv, q, sc, p, c, sk, rows, slots, total;  // byte offsets in shared memory
  __host__ __device__ Geometry(int T, int st, int n_per16, int el, int GM, int D, int run,
                               int page, bool quant) {
    cpr = D / n_per16;
    swz = cpr % 8 == 0 ? 4 : 0;
    rs = (cpr + (swz ? 0 : 1)) * n_per16;
    kd = (D / 4 + 31) / 32;
    n_hg = 1;
    while (GM / n_hg * kd > 8) n_hg *= 2;
    hw = GM / n_hg;
    lw = 4;
    while (lw < 32 && lw < D / 4) lw *= 2;
    kv = st * T * rs * el;                       // one ring, K or V
    q = 2 * kv;                                  // GM x D f32
    sc = q + 4 * GM * D;                         // scores: GM x (T + 1) f32
    p = sc + (4 * GM * (T + 1) + 15) / 16 * 16;  // probabilities: T x GM f32
    c = p + 4 * T * GM;                          // GM f32: corr, then l
    sk = c + 4 * GM;                             // int8 pools: st x T K, then V, scales f32
    rows = sk + (quant ? 4 * 2 * st * T : 0);    // run int: pool row or -1
    slots = rows + 4 * run;                      // run / page int
    total = slots + 4 * (run / page + 1);
    // the end's reduction reuses the buffer from its start: n_tg x GM x D f32
    const int red = kPagedWarps / n_hg * GM * D * 4;
    if (total < red) total = red;
  }
};

// Pass 1.  T: tokens per staged tile (32 or 64, a multiple of 32: lane j of
// the softmax takes tokens j, j + 32, ...); ST: stages of the ring; GM: the
// padded head count.  QT: q's (and the output's and the scales') type, KT:
// the pools'.
// ws_ml/ws_acc: the workspace with several splits; for partials of one
// split, the outputs themselves (the launch passes out_ml/out_acc there).
template <typename QT, typename KT, int T, int ST, int GM>
__global__ void __launch_bounds__(kPagedThreads)
paged_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                   const KT* __restrict__ v_pool, const QT* __restrict__ k_scale,
                   const QT* __restrict__ v_scale, const int* __restrict__ block_table,
                   const int* __restrict__ lengths, QT* __restrict__ out,
                   float* __restrict__ ws_ml, float* __restrict__ ws_acc, int B, int Hkv,
                   int G, int D, int page, int P, int run, int n_splits, int kvr, int my,
                   bool partial, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int N = 16 / sizeof(KT);           // stored values per 16 bytes
  constexpr int TL = T / 32;                   // tokens per lane in the softmax
  constexpr int HPW = GM / kPagedWarps;        // softmax heads per warp
  static_assert(HPW >= 1 && GM % kPagedWarps == 0, "GM must be a multiple of the warps");
  // the partials go to the workspace (several splits) or the outputs
  // (partials of one split); with neither, the block writes `out`
  const bool to_ws = n_splits > 1 || partial;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const size_t head0 = (size_t)b * Hq + (size_t)h * G;    // the group's first q row
  const int n_tok = local_tokens(lengths[b], page, P, kvr, my);
  const int start = split * run;
  if (start >= n_tok) {
    if (n_splits == 1 && partial) {            // the partial of no token: (-inf, 0, 0)
      for (int i = tid; i < G; i += kPagedThreads) {
        ws_ml[2 * (head0 + i)] = kNegInf;
        ws_ml[2 * (head0 + i) + 1] = 0.f;
      }
      for (int i = tid; i < G * D; i += kPagedThreads) ws_acc[head0 * D + i] = 0.f;
    } else if (n_splits == 1) {                // nothing to attend: zeros, as l = 0
      for (int i = tid; i < G * D; i += kPagedThreads) store_out(out + head0 * D + i, 0.f);
    }
    return;
  }
  const int stop = min(start + run, n_tok);
  const int n_tiles = (stop - start + T - 1) / T;

  const Geometry geo(T, ST, N, sizeof(KT), GM, D, run, page, kQuant);
  const int RS = geo.rs, U = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* ks = reinterpret_cast<KT*>(smem);
  KT* vs = reinterpret_cast<KT*>(smem + geo.kv);
  float* qs = reinterpret_cast<float*>(smem + geo.q);
  float* ss = reinterpret_cast<float*>(smem + geo.sc);
  float* pt = reinterpret_cast<float*>(smem + geo.p);
  float* cs = reinterpret_cast<float*>(smem + geo.c);
  float* ksc = reinterpret_cast<float*>(smem + geo.sk);     // int8 pools only
  float* vsc = ksc + ST * T;
  int* rows = reinterpret_cast<int*>(smem + geo.rows);
  int* slots = reinterpret_cast<int*>(smem + geo.slots);
  // stored-value offset of 16-byte chunk k of row r
  auto chunk = [&](int r, int k) { return r * RS + (k ^ ((r & 1) * geo.swz)) * N; };

  // the run's block-table entries (start is a whole number of pages), and q
  // (heads G..GM-1 zero)
  const int first_page = start / page;
  for (int i = tid; i < (stop - start + page - 1) / page; i += kPagedThreads)
    slots[i] = block_table[(size_t)b * P + first_page + i];
  const QT* qb = q + head0 * D;
  for (int i = tid; i < GM * D; i += kPagedThreads) qs[i] = i < G * D ? to_f32(qb[i]) : 0.f;
  __syncthreads();
  // each token's row in the pool: (slot * page + offset), or -1
  for (int j = tid; j < n_tiles * T; j += kPagedThreads) {
    const int slot = start + j < stop ? slots[j / page] : -1;
    rows[j] = slot >= 0 ? slot * page + j % page : -1;
  }
  __syncthreads();

  // a tile's copies: thread tid moves 16-byte chunk `ck` of rows r0,
  // r0 + rstep, ... (every thread the same chunks in every tile); with int8
  // pools, threads 0..T-1 also stage the tile's scales (plain loads)
  const int rstep = kPagedThreads / geo.cpr;
  const int r0 = tid < rstep * geo.cpr ? tid / geo.cpr : T;
  const int ck = tid % geo.cpr;
  auto issue = [&](int tile) {
    KT* kd = ks + (tile % ST) * T * RS;
    KT* vd = vs + (tile % ST) * T * RS;
    const int* tr = rows + tile * T;
    for (int r = r0; r < T; r += rstep) {
      const int row = tr[r];
      const size_t off = ((size_t)max(row, 0) * Hkv + h) * D + ck * N;
      const int bytes = row >= 0 ? 16 : 0;
      cp_async16(kd + chunk(r, ck), k_pool + off, bytes);
      cp_async16(vd + chunk(r, ck), v_pool + off, bytes);
    }
    if constexpr (kQuant) {
      for (int r = tid; r < T; r += kPagedThreads) {
        const int row = tr[r];
        const size_t at = (size_t)max(row, 0) * Hkv + h;
        ksc[(tile % ST) * T + r] = row >= 0 ? to_f32(k_scale[at]) : 0.f;
        vsc[(tile % ST) * T + r] = row >= 0 ? to_f32(v_scale[at]) : 0.f;
      }
    }
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }

  // softmax state: warp w owns heads w, w + 4, ...
  float m[HPW], l[HPW];
#pragma unroll
  for (int r = 0; r < HPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  // P.V roles: warp (tg, hg) takes tokens tg * tpw.. of each tile for heads
  // g0..g0 + hw - 1; lane group `sub` of lw lanes takes every (32 / lw)-th
  // of those tokens, lane u of the group the 4-value units u and u + 32 of D
  const int n_tg = kPagedWarps / geo.n_hg;
  const int tg = warp % n_tg, g0 = (warp / n_tg) * geo.hw;
  const int tpw = T / n_tg;
  const int lw = max(geo.lw, 32 / tpw);        // every lane group gets tokens
  const int ts = 32 / lw, sub = lane / lw, u0 = lane % lw;
  float4 acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<ST - 2>();                   // this thread's copies of `tile` landed
    __syncthreads();                           // everyone's; the last P.V is done
    if (tile + ST - 1 < n_tiles) issue(tile + ST - 1);
    cp_async_commit();
    const KT* kt = ks + (tile % ST) * T * RS;
    const KT* vt = vs + (tile % ST) * T * RS;
    const float* kts = ksc + (tile % ST) * T;
    const float* vts = vsc + (tile % ST) * T;

    // Q.K^T: warp w takes tokens 8w..8w+7 (+ 32); the 4 lanes of a token
    // split its chunks and sum all GM heads, then add across the 4
#pragma unroll
    for (int t = 8 * warp + (lane >> 2); t < T; t += 8 * kPagedWarps) {
      const int c = lane & 3;
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll 2
      for (int k = c; k < geo.cpr; k += 4) {
        float4 kv[N / 4];
        load16_f32(kt + chunk(t, k), kv);
        if constexpr (kQuant) {
#pragma unroll
          for (int e = 0; e < N / 4; ++e) kv[e] = dequant4<QT>(kv[e], kts[t]);
        }
        const float* qk = qs + k * N;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
#pragma unroll
          for (int e = 0; e < N / 4; ++e)
            s[g] = dot4(*reinterpret_cast<const float4*>(qk + g * D + 4 * e), kv[e], s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
        if ((g & 3) == c) ss[g * (T + 1) + t] = s[g];
      }
    }
    __syncthreads();

    // online softmax of the tile: lane j takes tokens j, j + 32, ... of the
    // warp's heads
    {
      bool live[TL];
#pragma unroll
      for (int i = 0; i < TL; ++i) live[i] = rows[tile * T + lane + 32 * i] >= 0;
#pragma unroll
      for (int r = 0; r < HPW; ++r) {
        const int g = warp + kPagedWarps * r;
        float sc[TL], mx = kNegInf;
#pragma unroll
        for (int i = 0; i < TL; ++i) {
          sc[i] = live[i] ? ss[g * (T + 1) + lane + 32 * i] * scale : kNegInf;
          mx = fmaxf(mx, sc[i]);
        }
        const float m_new = fmaxf(m[r], warp_max(mx));
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < TL; ++i) {
          const float p = live[i] ? expf(sc[i] - m_new) : 0.f;
          psum += p;
          pt[(lane + 32 * i) * GM + g] = p;
        }
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(psum);
        m[r] = m_new;
        if (lane == 0) cs[g] = corr;
      }
    }
    __syncthreads();

    // P.V: acc = acc * corr + p . V over the lane group's tokens
    auto v_at = [&](int t, int u) {
      const float4 v = load4_f32(vt + chunk(t, (4 * u) / N) + (4 * u) % N);
      if constexpr (kQuant) return dequant4<QT>(v, vts[t]);
      else return v;
    };
    if (geo.kd == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = i < geo.hw ? cs[g0 + i] : 0.f;
        acc[i] = make_float4(acc[i].x * corr, acc[i].y * corr, acc[i].z * corr, acc[i].w * corr);
      }
      if (u0 < U) {
#pragma unroll 2
        for (int i = sub; i < tpw; i += ts) {
          const int t = tg * tpw + i;
          const float4 v = v_at(t, u0);
          const float* pr = pt + t * GM + g0;
          const float4 p4 = *reinterpret_cast<const float4*>(pr);
          fma4(p4.x, v, acc[0]);
          fma4(p4.y, v, acc[1]);
          fma4(p4.z, v, acc[2]);
          fma4(p4.w, v, acc[3]);
          if (geo.hw == 8) {
            const float4 p8 = *reinterpret_cast<const float4*>(pr + 4);
            fma4(p8.x, v, acc[4]);
            fma4(p8.y, v, acc[5]);
            fma4(p8.z, v, acc[6]);
            fma4(p8.w, v, acc[7]);
          }
        }
      }
    } else {                                   // kd == 2, hw == 4: acc[2 hh + k]
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = cs[g0 + i / 2];
        acc[i] = make_float4(acc[i].x * corr, acc[i].y * corr, acc[i].z * corr, acc[i].w * corr);
      }
      const int u1 = lane + 32;
#pragma unroll 2
      for (int i = 0; i < tpw; ++i) {
        const int t = tg * tpw + i;
        const float4 v0 = v_at(t, lane);
        const float4 v1 = u1 < U ? v_at(t, u1) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 p4 = *reinterpret_cast<const float4*>(pt + t * GM + g0);
        fma4(p4.x, v0, acc[0]);
        fma4(p4.x, v1, acc[1]);
        fma4(p4.y, v0, acc[2]);
        fma4(p4.y, v1, acc[3]);
        fma4(p4.z, v0, acc[4]);
        fma4(p4.z, v1, acc[5]);
        fma4(p4.w, v0, acc[6]);
        fma4(p4.w, v1, acc[7]);
      }
    }
  }
  cp_async_wait<0>();                          // only empty groups can be left
  __syncthreads();                             // the rings are free

  // the lane groups' sums, added pairwise in a fixed order
  for (int o = lw; o < 32; o *= 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i].x += __shfl_xor_sync(0xffffffffu, acc[i].x, o);
      acc[i].y += __shfl_xor_sync(0xffffffffu, acc[i].y, o);
      acc[i].z += __shfl_xor_sync(0xffffffffu, acc[i].z, o);
      acc[i].w += __shfl_xor_sync(0xffffffffu, acc[i].w, o);
    }
  }
  // the token groups' sums, added in group order; m and l of each head
  float* red = reinterpret_cast<float*>(smem);  // n_tg x GM x D f32
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int hh = geo.kd == 1 ? i : i / 2, u = geo.kd == 1 ? u0 : lane + 32 * (i & 1);
    if (sub == 0 && hh < geo.hw && u < U)
      *reinterpret_cast<float4*>(red + ((size_t)tg * GM + g0 + hh) * D + 4 * u) = acc[i];
  }
#pragma unroll
  for (int r = 0; r < HPW; ++r) {
    const int g = warp + kPagedWarps * r;
    if (lane == 0 && g < G) {
      cs[g] = l[r];
      if (to_ws) {
        float* ml = ws_ml + 2 * ((size_t)split * B * Hq + head0 + g);
        ml[0] = m[r];
        ml[1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * U; e += kPagedThreads) {
    const int g = e / U, d = 4 * (e - g * U);
    float4 x = *reinterpret_cast<const float4*>(red + (size_t)g * D + d);
    for (int i = 1; i < n_tg; ++i) {
      const float4 y = *reinterpret_cast<const float4*>(red + ((size_t)i * GM + g) * D + d);
      x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
    }
    const size_t at = (head0 + g) * D + d;
    if (to_ws) {
      *reinterpret_cast<float4*>(ws_acc + (size_t)split * B * Hq * D + at) = x;
    } else {
      const float lc = fmaxf(cs[g], 1e-20f);
      store_out(out + at, x.x / lc);
      store_out(out + at + 1, x.y / lc);
      store_out(out + at + 2, x.z / lc);
      store_out(out + at + 3, x.w / lc);
    }
  }
}

// Pass 2: thread i combines element i of the output, (sequence b, q head,
// column d), over the splits its row's length reached, in split order:
// m_glob = max m; corr = exp(m - m_glob); l = sum l * corr; acc = sum acc *
// corr; out = acc / max(l, 1e-20), or, for partials, (m_glob, l, acc) as
// they are.  Splits that never ran hold m = -inf in `combine_partials` and
// add exactly 0 there; here they are not read.
constexpr int kBatch = 16;

template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ ws_ml, const float* __restrict__ ws_acc,
                     const int* __restrict__ lengths, QT* __restrict__ out,
                     float* __restrict__ out_ml, float* __restrict__ out_acc, int B, int Hq,
                     int D, int page, int P, int run, int kvr, int my, bool partial) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * Hq * D) return;
  const int row = i / D, d = i - row * D, b = row / Hq;
  const int n_tok = local_tokens(lengths[b], page, P, kvr, my);
  const int n_live = (n_tok + run - 1) / run;
  const size_t per_split = (size_t)B * Hq;
  // the first kBatch splits' (m, l, acc) are read in one go, the rest (long
  // rows) after m_glob is known, kBatch at a time
  float m[kBatch], ls[kBatch], x[kBatch];
  auto read = [&](int s0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const size_t at = (s0 + j) * per_split + row;
      const bool ran = s0 + j < n_live;
      m[j] = ran ? ws_ml[2 * at] : kNegInf;
      ls[j] = ran ? ws_ml[2 * at + 1] : 0.f;
      x[j] = ran ? ws_acc[at * D + d] : 0.f;
    }
  };
  read(0);
  float m_glob = kNegInf;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) m_glob = fmaxf(m_glob, m[j]);
  for (int s0 = kBatch; s0 < n_live; s0 += kBatch) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      m_glob = fmaxf(m_glob, s0 + j < n_live ? ws_ml[2 * ((s0 + j) * per_split + row)] : kNegInf);
  }
  float l = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < n_live; s0 += kBatch) {
    if (s0 > 0) read(s0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (s0 + j >= n_live) break;
      const float corr = expf(m[j] - m_glob);
      l = __fadd_rn(l, __fmul_rn(ls[j], corr));
      acc = __fadd_rn(acc, __fmul_rn(x[j], corr));
    }
  }
  if (partial) {
    out_acc[i] = acc;
    if (d == 0) {
      out_ml[2 * row] = m_glob;
      out_ml[2 * row + 1] = l;
    }
  } else {
    store_out(out + i, acc / fmaxf(l, 1e-20f));
  }
}

template <typename QT, typename KT, int T, int GM>
cudaError_t launch_paged(const PagedArgs& a, cudaStream_t stream) {
  constexpr int ST = kStages;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  auto kernel = paged_split_kernel<QT, KT, T, ST, GM>;
  const size_t smem =
      Geometry(T, ST, 16 / sizeof(KT), sizeof(KT), GM, a.D, a.run, a.page, kQuant).total;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool direct = a.n_splits == 1;         // partials of one split: the outputs
  dim3 grid(a.Hkv, a.n_splits, a.B);
  kernel<<<grid, kPagedThreads, smem, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), static_cast<const QT*>(a.k_scale),
      static_cast<const QT*>(a.v_scale), a.block_table, a.lengths, static_cast<QT*>(a.out),
      direct ? a.out_ml : a.ws_ml, direct ? a.out_acc : a.ws_acc, a.B, a.Hkv, a.G, a.D,
      a.page, a.P, a.run, a.n_splits, a.kvr, a.my, a.partial != 0, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  const int n_out = a.B * a.Hkv * a.G * a.D;
  paged_combine_kernel<QT><<<(n_out + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.ws_ml, a.ws_acc, a.lengths, static_cast<QT*>(a.out), a.out_ml, a.out_acc, a.B,
      a.Hkv * a.G, a.D, a.page, a.P, a.run, a.kvr, a.my, a.partial != 0);
  return cudaGetLastError();
}

template <typename QT, typename KT, int T>
cudaError_t launch_heads(const PagedArgs& a, cudaStream_t stream) {
  if (a.G <= 4) return launch_paged<QT, KT, T, 4>(a, stream);
  if (a.G <= 8) return launch_paged<QT, KT, T, 8>(a, stream);
  return launch_paged<QT, KT, T, 16>(a, stream);
}

template <typename QT, typename KT>
cudaError_t launch_tile(int tile, const PagedArgs& a, cudaStream_t stream) {
  if (tile == 32) return launch_heads<QT, KT, 32>(a, stream);
  if (tile == 64) return launch_heads<QT, KT, 64>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t launch_pool(int tile, int kv_dtype, const PagedArgs& a, cudaStream_t stream) {
  if (kv_dtype == kF32) return launch_tile<QT, float>(tile, a, stream);
  if (kv_dtype == kBF16) return launch_tile<QT, __nv_bfloat16>(tile, a, stream);
  if (kv_dtype == kI8 && a.k_scale != nullptr && a.v_scale != nullptr)
    return launch_tile<QT, int8_t>(tile, a, stream);
  return cudaErrorInvalidValue;
}

inline int launch(int tile, int q_dtype, int kv_dtype, const PagedArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32) return static_cast<int>(launch_pool<float>(tile, kv_dtype, a, s));
  if (q_dtype == kBF16) return static_cast<int>(launch_pool<__nv_bfloat16>(tile, kv_dtype, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace valet

// C interface (bound with ctypes).  q/out: (B, Hkv*G, D) contiguous;
// pools: (n_slots, page, Hkv, D) contiguous; block_table: (B, P) int32;
// lengths: (B,) int32; with n_splits > 1, ws_ml: (n_splits, B, Hkv*G, 2) and
// ws_acc: (n_splits, B, Hkv*G, D) f32 workspace (unused with one split).
// `tile` (32 or 64) tokens per staged tile; `run` tokens per split, whole
// pages and whole tiles.  Returns the cudaError_t of the launches.
extern "C" int valet_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* block_table,
                                     const void* lengths, void* out, void* ws_ml,
                                     void* ws_acc, int B, int Hkv, int G, int D, int page,
                                     int P, int tile, int run, int n_splits, int q_dtype,
                                     int kv_dtype, float scale, void* stream) {
  valet::PagedArgs a{};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.block_table = static_cast<const int*>(block_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.ws_ml = static_cast<float*>(ws_ml);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.B = B, a.Hkv = Hkv, a.G = G, a.D = D, a.page = page, a.P = P;
  a.run = run, a.n_splits = n_splits, a.kvr = 1, a.my = 0, a.partial = 0;
  a.scale = scale;
  return valet::launch(tile, q_dtype, kv_dtype, a, stream);
}

// One peer's f32 partials (m, l, acc) over its pages of a pool sharded
// round-robin over `kvr` ranks (this one `my`): block_table (B, P) holds the
// rank's local pages, local page j holds absolute positions (j * kvr + my) *
// page + o, and positions below `lengths` are valid.  out_ml: (B, Hkv*G, 2)
// f32 (m, l); out_acc: (B, Hkv*G, D) f32; the workspace as above.  kv_dtype
// 2 (int8) takes k_scale/v_scale (n_slots, page, Hkv) in q's dtype.
extern "C" int valet_paged_attention_partials(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_table, const void* lengths, void* out_ml,
    void* out_acc, void* ws_ml, void* ws_acc, int B, int Hkv, int G, int D, int page, int P,
    int tile, int run, int n_splits, int kvr, int my, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  valet::PagedArgs a{};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.block_table = static_cast<const int*>(block_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out_ml = static_cast<float*>(out_ml);
  a.out_acc = static_cast<float*>(out_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.ws_acc = static_cast<float*>(ws_acc);
  a.B = B, a.Hkv = Hkv, a.G = G, a.D = D, a.page = page, a.P = P;
  a.run = run, a.n_splits = n_splits, a.kvr = kvr, a.my = my, a.partial = 1;
  a.scale = scale;
  return valet::launch(tile, q_dtype, kv_dtype, a, stream);
}
