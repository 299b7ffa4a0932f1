// ring_all_gather: the frontier exchange of the sharded wave, hop by hop.
//
// Replaces the Pallas kernel stl_fusion_tpu/ops/pallas_kernels.py:
// make_ring_all_gather / _ring_kernel. There each TPU device wrote its own
// chunk of frontier words into its output and its comm slot 0, then made
// n-1 hops: at step s it sent comm slot s%2 to device (i+1)%n by remote DMA
// into that device's slot 1-s%2, waited on DMA semaphores, and wrote the
// received chunk at owner (i-s-1) mod n of its output.
//
// Here the shards are n logical shards of one card, each with its own comm
// buffer (two slots) and its own output, reached through a pointer table
// passed by value. One launch covers one step for every shard (grid y =
// sending shard): step -1 places each shard's own chunk, step s >= 0 moves
// shard d's send slot into shard d+1's receive slot and into d+1's output at
// owner (d-s) mod n. Within a launch every read is from slot s%2 and every
// write to slot 1-s%2 or to a distinct output chunk, so nothing races; the
// launch boundary on the stream takes the place of the TPU's semaphores.
// The chunk is any whole number of int32 words (the TPU's 128-lane tiling
// does not apply).
//
// Bound on the H100: bytes. The all-gather must read n chunks and write n*n
// (n=8, 39,063 words: 1.25 MB in, 10 MB out, ~3.4 us at 3.35 TB/s). The hop
// schedule moves 3*n*n chunks instead (every hop reads a chunk and writes it
// twice) and pays n launches, so launch latency sets its time at this size;
// a single launch with a grid-wide barrier, or peer-to-peer writes between
// cards, is later work. Loads are plain coalesced 4-byte words: an owner's
// chunk starts at owner*chunk words, which is 16-byte aligned only when the
// chunk is a multiple of 4 words.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;
constexpr long long kMaxBlocksX = 132 * 4;

struct RingPtrs {
  const int* local[kMaxShards];
  int* comm[kMaxShards];  // int32[2 * chunk] per shard: slot 0, slot 1
  int* out[kMaxShards];   // int32[n * chunk] per shard
};

__global__ void __launch_bounds__(kThreads)
ring_step_kernel(const RingPtrs p, int n, long long chunk, int step) {
  const int d = blockIdx.y;
  const int* src;
  int* to_comm;
  int* to_out;
  if (step < 0) {  // own chunk: output slot d and comm slot 0
    src = p.local[d];
    to_comm = p.comm[d];
    to_out = p.out[d] + (long long)d * chunk;
  } else {
    const int to = (d + 1) % n;
    const int send = step & 1;
    const int owner = ((d - step) % n + n) % n;
    src = p.comm[d] + send * chunk;
    to_comm = p.comm[to] + (1 - send) * chunk;
    to_out = p.out[to] + (long long)owner * chunk;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < chunk; i += stride) {
    const int w = src[i];
    to_comm[i] = w;
    to_out[i] = w;
  }
}

}  // namespace

// local_ptrs, comm_ptrs, out_ptrs: HOST arrays of n device pointers each.
// Enqueues n launches (step -1, then steps 0..n-2) on `stream`.
extern "C" int ring_all_gather_launch(const void* local_ptrs, const void* comm_ptrs,
                                      const void* out_ptrs, int n, long long chunk,
                                      void* stream) {
  if (n < 1 || n > kMaxShards || chunk < 1) return (int)cudaErrorInvalidValue;
  RingPtrs p;
  for (int d = 0; d < n; ++d) {
    p.local[d] = static_cast<const int* const*>(local_ptrs)[d];
    p.comm[d] = static_cast<int* const*>(comm_ptrs)[d];
    p.out[d] = static_cast<int* const*>(out_ptrs)[d];
  }
  long long bx = (chunk + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid((unsigned)bx, (unsigned)n);
  for (int step = -1; step < n - 1; ++step) {
    ring_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, n, chunk, step);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
