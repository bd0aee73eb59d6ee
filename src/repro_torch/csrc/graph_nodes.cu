// The size of a captured CUDA graph, for the serving engine's log of its one
// capture of the decode step (serve/engine.py): no kernel.
#include <cuda_runtime.h>

// The number of nodes of a captured CUDA graph (a `cudaGraph_t`), in *count.
extern "C" int valet_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  const cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *count = n;
  return static_cast<int>(err);
}
