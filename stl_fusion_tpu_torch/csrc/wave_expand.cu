// wave_expand: one BFS level of the invalidation wave on bit-packed state.
//
// The counterpart of the XLA program stl_fusion_tpu/ops/wave.py::wave_step
// (a gather + scatter-max over every edge, then invalid |= next), which has
// no Pallas kernel: it is hand-written here because PyTorch has no
// scatter-OR into words, and its plain version has to unpack the frontier to
// bool, scatter, and pack again.
//
// For each live edge e (src -> dst):
//   fire = frontier bit of src  AND  dst < n_cap (not the dummy slot)
//          AND node_epoch[dst] == edge_dst_epoch[e]  AND NOT invalid bit of dst.
// Node i is bit (i & 31) of word (i >> 5).
//
// One kernel body, three instantiations:
// - pure  (wave_expand_launch): atomicOr the bit of each firing dst into
//   next_w; `invalid` is read only.
// - merge (wave_expand_merge_launch): the whole of wave_step. A firing edge
//   into d does prev = atomicOr(&invalid[d>>5], bit), and only when the bit
//   was clear in prev sets it in next_w and counts one. So next holds the
//   dependents that fire and were valid at the start of the level,
//   invalid |= next, and the count is popcount(next), whatever the order of
//   the atomics. `invalid` is read with a plain load, not __ldg, since the
//   kernel writes those words: a stale word only costs an atomic. Each block
//   reduces its count (warp shuffles, then shared memory) and makes one
//   64-bit atomicAdd.
// - shards (wave_expand_shards_launch): the merge form for every shard of a
//   one-card mesh in one launch, grid y = shard. Each shard's fixed tensors
//   come from a table in device memory built once per graph; shard y reads
//   frontier row y (row stride 0 when all shards share one gathered
//   frontier) and writes next row y; one count for all shards (the psum).
//
// Bound on the H100: bytes. A level streams edge_src (4 B per live edge;
// 120 MB at 30M edges, ~36 us at 3.35 TB/s) and, for each edge whose source
// is in the frontier, edge_dst and edge_dst_epoch (8 B) and, per distinct
// dependent, its epoch; plus the bit vectors (~2 MB each at 16.7M nodes,
// which stay in L2). The design keeps that stream in flight and the rare
// firing edges off its critical path:
// - each thread takes edges four at a time with one int4 load of edge_src,
//   kUnroll such loads before any frontier word is read, then issues those
//   frontier-word loads together (edges are sorted by source, so a warp's
//   loads mostly hit one or two words);
// - each warp compacts its firing edges into a queue in shared memory
//   (ballot + popcount), then its 32 lanes take them 32 at a time. Without
//   it a thread walked its own firing edges one after another, each a chain
//   of dependent loads and atomics, and the few warps holding a hub's
//   out-edges set the kernel's time;
// - a firing edge reads edge_dst and edge_dst_epoch together, then the
//   invalid word of its dependent (in L2) before its epoch (a random
//   device-memory read), which it skips for a dependent already invalid;
// - 32 registers a thread (launch bounds), so 8 blocks of 256 fit on an SM
//   and the grid fills every SM.
// The ragged tail of n_edges % 4 edges takes a scalar path; the wrapper
// checks that edge_src is 16-byte aligned.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;               // resident blocks per SM (caps registers at 32)
constexpr int kUnroll = 2;                  // int4 loads of edge_src in flight per thread
constexpr int kTile = kThreads * kUnroll;   // int4s a block takes per iteration
constexpr int kQueue = kUnroll * 4 * 32;    // firing edges a warp can queue per iteration

// One shard's fixed tensors: 64 bytes, one row of the wrapper's int64[n, 8]
// table (the field order is the wrapper's).
struct Shard {
  const int* edge_src;        // int32[n_edges], 16-byte aligned
  const int* edge_dst;        // int32[n_edges]
  const int* edge_dst_epoch;  // int32[n_edges]
  const int* node_epoch;      // int32[n_cap + 1]
  int* invalid;               // packed words covering n_cap + 1 bits
  long long n_edges;
  long long n_cap;
  long long unused;
};
static_assert(sizeof(Shard) == 64, "Shard must match the wrapper's int64[8] row");

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool has_bit(unsigned word, int i) { return (word >> (i & 31)) & 1u; }

__device__ __forceinline__ int lane_of(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Edge e's source is in the frontier: test the rest of `fire` and record it.
template <bool kMerge>
__device__ __forceinline__ void fire(const Shard& s, long long e, unsigned* next_w,
                                     unsigned long long& lit) {
  const int d = __ldg(s.edge_dst + e);
  const int epoch = __ldg(s.edge_dst_epoch + e);
  if ((unsigned)d >= (unsigned)s.n_cap) return;  // padding: the dummy slot
  const unsigned b = 1u << (d & 31);
  unsigned* inv = reinterpret_cast<unsigned*>(s.invalid) + (d >> 5);
  if constexpr (kMerge) {
    if (*inv & b) return;
    if (__ldg(s.node_epoch + d) != epoch) return;
    if (atomicOr(inv, b) & b) return;  // another edge lit d first
    atomicOr(next_w + (d >> 5), b);
    ++lit;
  } else {
    if (__ldg(inv) & b) return;
    if (__ldg(s.node_epoch + d) != epoch) return;
    atomicOr(next_w + (d >> 5), b);
  }
}

template <bool kMerge, bool kTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
wave_expand_kernel(const Shard one, const Shard* __restrict__ table,
                   const int* __restrict__ frontier_w, long long frontier_stride,
                   int* next_w, long long next_stride, unsigned long long* count) {
  __shared__ int queue[kThreads / 32][kQueue];  // per warp: firing edges of one iteration
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* q = queue[warp];
  const int y = blockIdx.y;
  const Shard s = kTable ? table[y] : one;
  const unsigned* fw = reinterpret_cast<const unsigned*>(frontier_w + y * frontier_stride);
  unsigned* nw = reinterpret_cast<unsigned*>(next_w + y * next_stride);
  unsigned long long lit = 0;

  const long long n_vec = s.n_edges >> 2;
  const int4* src4 = reinterpret_cast<const int4*>(s.edge_src);
  for (long long base = (long long)blockIdx.x * kTile; base < n_vec;
       base += (long long)gridDim.x * kTile) {
    int4 v[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      ok[u] = i < n_vec;
      v[u] = ok[u] ? __ldg(src4 + i) : make_int4(0, 0, 0, 0);
    }
    unsigned w[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) w[u][k] = ok[u] ? __ldg(fw + (lane_of(v[u], k) >> 5)) : 0u;
    // queue the warp's firing edges, as offsets from the tile's first edge
    int queued = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool hit = has_bit(w[u][k], lane_of(v[u], k));
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (hit) q[queued + __popc(mask & below)] = ((u * kThreads + threadIdx.x) << 2) + k;
        queued += __popc(mask);
      }
    __syncwarp();
    for (int j = lane; j < queued; j += 32) fire<kMerge>(s, (base << 2) + q[j], nw, lit);
    __syncwarp();  // the queue is refilled next iteration
  }
  // the ragged tail: the last n_edges % 4 edges, one thread each
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < (s.n_edges & 3)) {
    const long long e = (n_vec << 2) + t;
    const int src = __ldg(s.edge_src + e);
    if (has_bit(__ldg(fw + (src >> 5)), src)) fire<kMerge>(s, e, nw, lit);
  }

  if constexpr (kMerge) {
    __shared__ unsigned long long warp_sums[kThreads / 32];
    lit = warp_sum(lit);
    if (lane == 0) warp_sums[warp] = lit;
    __syncthreads();
    if (warp == 0) {
      lit = lane < kThreads / 32 ? warp_sums[lane] : 0ull;
      lit = warp_sum(lit);
      if (lane == 0 && lit) atomicAdd(count, lit);
    }
  }
}

// Blocks per shard: enough tiles for the longest shard, at most what fills
// every SM at this instantiation's occupancy (shared by the shards).
template <bool kMerge, bool kTable>
int launch(const Shard& one, const Shard* table, int n_shards, long long max_edges,
           const void* frontier_w, long long frontier_stride, void* next_w,
           long long next_stride, void* count, void* stream) {
  static int full_blocks = 0;  // SMs x resident blocks per SM
  if (full_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wave_expand_kernel<kMerge, kTable>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    full_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (n_shards < 1 || max_edges < 0) return (int)cudaErrorInvalidValue;
  long long need = ((max_edges >> 2) + kTile - 1) / kTile;
  long long cap = full_blocks / n_shards;
  if (cap < 1) cap = 1;
  if (need > cap) need = cap;
  if (need < 1) need = 1;  // block 0 also takes the ragged tail
  const dim3 grid((unsigned)need, (unsigned)n_shards);
  wave_expand_kernel<kMerge, kTable><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      one, table, (const int*)frontier_w, frontier_stride, (int*)next_w, next_stride,
      (unsigned long long*)count);
  return (int)cudaGetLastError();
}

Shard make_shard(const void* invalid_w, const void* node_epoch, const void* edge_src,
                 const void* edge_dst, const void* edge_dst_epoch, long long n_edges, int n_cap) {
  return Shard{(const int*)edge_src, (const int*)edge_dst, (const int*)edge_dst_epoch,
               (const int*)node_epoch, (int*)invalid_w, n_edges, n_cap, 0};
}

}  // namespace

// Pure: next_w (zeroed by the wrapper) receives the firing dependents.
extern "C" int wave_expand_launch(const void* frontier_w, const void* invalid_w,
                                  const void* node_epoch, const void* edge_src,
                                  const void* edge_dst, const void* edge_dst_epoch,
                                  void* next_w, long long n_edges, int n_cap,
                                  void* stream) {
  const Shard s = make_shard(invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch,
                             n_edges, n_cap);
  return launch<false, false>(s, nullptr, 1, n_edges, frontier_w, 0, next_w, 0, nullptr,
                              stream);
}

// Merge: as pure, and invalid_w |= next_w, count (u64, zeroed) += popcount(next_w).
extern "C" int wave_expand_merge_launch(const void* frontier_w, void* invalid_w,
                                        const void* node_epoch, const void* edge_src,
                                        const void* edge_dst, const void* edge_dst_epoch,
                                        void* next_w, long long n_edges, int n_cap,
                                        void* count, void* stream) {
  const Shard s = make_shard(invalid_w, node_epoch, edge_src, edge_dst, edge_dst_epoch,
                             n_edges, n_cap);
  return launch<true, false>(s, nullptr, 1, n_edges, frontier_w, 0, next_w, 0, count, stream);
}

// Shards: the merge form for n_shards shards; `table` is a DEVICE array of
// n_shards Shard rows, `max_edges` the longest shard's edge count.
extern "C" int wave_expand_shards_launch(const void* frontier_w, long long frontier_stride,
                                         const void* table, int n_shards, long long max_edges,
                                         void* next_w, long long next_stride, void* count,
                                         void* stream) {
  const Shard none{};
  return launch<true, true>(none, (const Shard*)table, n_shards, max_edges, frontier_w,
                            frontier_stride, next_w, next_stride, count, stream);
}
