// Page-major moves of whole KV pages between the paged layers' pools and a
// staging buffer on the card, for the host tier (sm_90a).
//
// Replaces no TPU kernel.  The JAX package moves a spilled page's bytes
// with `jax.device_put` to a `pinned_host` sharding
// (src/repro/core/device_ops.py:136), one transfer per layer, and XLA
// gathers the slots.  On this card a page of the host tier is one
// contiguous block of pinned memory holding every paged layer's K and V
// rows (`HostPageArena` in core/device_ops.py), so that it crosses PCIe
// as one copy; this kernel builds those blocks from the pools (gather) and
// takes them apart again (scatter), for all layers in one launch.
//
// Layout: `table` holds the device addresses of the R = 2 x (paged layers)
// pools in the arena's row order (layer 0's K, layer 0's V, layer 1's K,
// ...); row r of pool slot s starts at table[r] + s * row_bytes.  Page i
// of the staging buffer is R rows of row_bytes, contiguous:
//   stage + (i * R + r) * row_bytes.
//
// What bounds it: device memory bytes, a read and a write of each page
// (5,242,880 B a page at granite-3-8b's f32 pool); there is no arithmetic.
// What the design does about it: one block per (page row, page), so a
// launch of n pages has R x n independent blocks (80 x 64 at granite); 256
// threads copy a row in 16-byte vectors, neighbouring threads on
// neighbouring addresses, four loads in flight before their stores.
// Rows must be a multiple of 16 bytes and every base 16-byte aligned (the
// wrapper checks).  Pages go by value in the launch's parameters, up to 64
// a launch, so no index buffer is uploaded and nothing synchronises.
//
// `valet_host_pages_move` is the host tier's whole move of n pages through
// a staging buffer of `stage_pages` pages, in rounds: to the host, a
// gather launch and then one cudaMemcpyAsync per run of pages whose host
// blocks are adjacent; from the host, the copies and then a scatter
// launch.  Everything is issued on `stream` and nothing waits: a later
// reader or writer of the pool slots, the host blocks or the staging
// buffer on the same stream runs after the move.  The host blocks must be
// pinned for the copies to run on the copy engines without a wait.
#include <cuda_runtime.h>
#include <stdint.h>

namespace valet {

constexpr int kHostPagesMax = 64;       // pages a launch takes
constexpr int kHostPagesThreads = 256;

struct HostPageSlots {
  int slot[kHostPagesMax];
};

__global__ void __launch_bounds__(kHostPagesThreads)
host_pages_kernel(const unsigned long long* __restrict__ table, HostPageSlots slots,
                  uint4* __restrict__ stage, long long row_vecs, int to_stage) {
  const int r = blockIdx.x;
  const int i = blockIdx.y;
  const int rows = gridDim.x;
  uint4* pool_row = reinterpret_cast<uint4*>(table[r]) +
                    static_cast<long long>(slots.slot[i]) * row_vecs;
  uint4* stage_row = stage + (static_cast<long long>(i) * rows + r) * row_vecs;
  const uint4* __restrict__ src = to_stage ? pool_row : stage_row;
  uint4* __restrict__ dst = to_stage ? stage_row : pool_row;
  constexpr int T = kHostPagesThreads;
  long long j = threadIdx.x;
  for (; j + 3 * T < row_vecs; j += 4 * T) {
    const uint4 a = src[j], b = src[j + T], c = src[j + 2 * T], d = src[j + 3 * T];
    dst[j] = a;
    dst[j + T] = b;
    dst[j + 2 * T] = c;
    dst[j + 3 * T] = d;
  }
  for (; j < row_vecs; j += T) dst[j] = src[j];
}

// Launches over n pages whose staging rows start at `stage`, 64 pages a
// launch; returns the CUDA error and adds the launches to *launches.
static cudaError_t launch_pages(const void* table, const int* slots, int n, char* stage,
                                int rows, long long row_bytes, int to_stage,
                                cudaStream_t stream, int* launches) {
  const long long page_bytes = rows * row_bytes;
  for (int base = 0; base < n; base += kHostPagesMax) {
    const int m = n - base < kHostPagesMax ? n - base : kHostPagesMax;
    HostPageSlots s;
    for (int k = 0; k < m; ++k) s.slot[k] = slots[base + k];
    dim3 grid(rows, m);
    host_pages_kernel<<<grid, kHostPagesThreads, 0, stream>>>(
        static_cast<const unsigned long long*>(table), s,
        reinterpret_cast<uint4*>(stage + base * page_bytes), row_bytes / 16, to_stage);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

// One cudaMemcpyAsync per run of pages whose host blocks are adjacent;
// staging pages are adjacent by construction.
static cudaError_t copy_runs(const long long* host, int n, char* stage, long long page_bytes,
                             int to_host, cudaStream_t stream, int* copies) {
  int i = 0;
  while (i < n) {
    int j = i + 1;
    while (j < n && host[j] == host[j - 1] + page_bytes) ++j;
    char* h = reinterpret_cast<char*>(host[i]);
    char* d = stage + i * page_bytes;
    const size_t bytes = static_cast<size_t>(j - i) * page_bytes;
    const cudaError_t err =
        to_host ? cudaMemcpyAsync(h, d, bytes, cudaMemcpyDeviceToHost, stream)
                : cudaMemcpyAsync(d, h, bytes, cudaMemcpyHostToDevice, stream);
    if (err != cudaSuccess) return err;
    ++*copies;
    i = j;
  }
  return cudaSuccess;
}

}  // namespace valet

// The kernel alone: n pages between the pools and a staging buffer of n
// pages (to_stage 1 gathers, 0 scatters).  counts[0] += launches.
extern "C" int valet_host_pages(const void* table, const int* slots, int n, void* stage,
                                int rows, long long row_bytes, int to_stage, int* counts,
                                void* stream) {
  return valet::launch_pages(table, slots, n, static_cast<char*>(stage), rows, row_bytes,
                             to_stage, static_cast<cudaStream_t>(stream), &counts[0]);
}

// The host tier's move of n pages: pool slots `slots[i]` to or from the
// pinned host blocks at addresses `host[i]`, through a staging buffer of
// `stage_pages` pages.  counts[0] += launches, counts[1] += copies.
extern "C" int valet_host_pages_move(const void* table, const int* slots,
                                     const long long* host, int n, void* stage,
                                     int stage_pages, int rows, long long row_bytes,
                                     int to_host, int* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* st = static_cast<char*>(stage);
  const long long page_bytes = rows * row_bytes;
  for (int base = 0; base < n; base += stage_pages) {
    const int m = n - base < stage_pages ? n - base : stage_pages;
    cudaError_t err;
    if (to_host) {
      err = valet::launch_pages(table, slots + base, m, st, rows, row_bytes, 1, s,
                                &counts[0]);
      if (err == cudaSuccess)
        err = valet::copy_runs(host + base, m, st, page_bytes, 1, s, &counts[1]);
    } else {
      err = valet::copy_runs(host + base, m, st, page_bytes, 0, s, &counts[1]);
      if (err == cudaSuccess)
        err = valet::launch_pages(table, slots + base, m, st, rows, row_bytes, 0, s,
                                  &counts[0]);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
