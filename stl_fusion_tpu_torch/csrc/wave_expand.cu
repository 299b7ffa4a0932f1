// wave_expand: one BFS level of the invalidation wave on bit-packed state.
//
// The counterpart of the XLA program stl_fusion_tpu/ops/wave.py::wave_step
// (a gather + scatter-max over every edge), which has no Pallas kernel: it is
// hand-written here because PyTorch has no scatter-OR into words, and its
// plain version has to unpack the frontier to bool, scatter, and pack again.
//
// One thread per live edge e (grid-stride):
//   fire = frontier bit of src  AND  node_epoch[dst] == edge_dst_epoch[e]
//          AND NOT invalid bit of dst  AND  dst < n_cap (the dummy slot);
//   if fire: atomicOr the bit of dst into next_w.
// Node i is bit (i & 31) of word (i >> 5). Setting a bit is idempotent, so
// duplicate edges and the order of the atomics cannot change the result.
//
// Bound on the H100: bytes. Each level streams the live edge arrays (12 B
// per edge; ~360 MB at 30M edges, ~110 us at 3.35 TB/s) plus random reads of
// the frontier word and, for edges whose source fires, of node_epoch and the
// invalid word of dst. The design reads edge_src first and touches the other
// two edge arrays only for firing sources, so a narrow frontier streams 4 B
// per edge, not 12; the bit vectors (2 MB at 16.7M nodes) stay in L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ bool bit(const int* __restrict__ words, int i) {
  return ((unsigned)__ldg(words + (i >> 5)) >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
wave_expand_kernel(const int* __restrict__ frontier_w, const int* __restrict__ invalid_w,
                   const int* __restrict__ node_epoch, const int* __restrict__ edge_src,
                   const int* __restrict__ edge_dst, const int* __restrict__ edge_dst_epoch,
                   int* next_w, long long n_edges, int n_cap) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n_edges;
       e += stride) {
    const int s = __ldg(edge_src + e);
    if (!bit(frontier_w, s)) continue;
    const int d = __ldg(edge_dst + e);
    if (d < 0 || d >= n_cap) continue;
    if (__ldg(node_epoch + d) != __ldg(edge_dst_epoch + e)) continue;
    if (bit(invalid_w, d)) continue;
    atomicOr(reinterpret_cast<unsigned int*>(next_w) + (d >> 5), 1u << (d & 31));
  }
}

}  // namespace

extern "C" int wave_expand_launch(const void* frontier_w, const void* invalid_w,
                                  const void* node_epoch, const void* edge_src,
                                  const void* edge_dst, const void* edge_dst_epoch,
                                  void* next_w, long long n_edges, int n_cap,
                                  void* stream) {
  long long blocks = (n_edges + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  wave_expand_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)frontier_w, (const int*)invalid_w, (const int*)node_epoch,
      (const int*)edge_src, (const int*)edge_dst, (const int*)edge_dst_epoch,
      (int*)next_w, n_edges, n_cap);
  return (int)cudaGetLastError();
}
