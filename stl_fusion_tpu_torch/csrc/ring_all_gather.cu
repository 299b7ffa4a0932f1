// ring_all_gather: the frontier exchange of the sharded wave, in one launch.
//
// Replaces the Pallas kernel stl_fusion_tpu/ops/pallas_kernels.py:103
// (_ring_kernel, built by make_ring_all_gather). There each TPU device wrote
// its own chunk into its output, then made n-1 double-buffered hops: remote
// DMA of a comm slot to the next device, a wait on DMA semaphores, and a copy
// of the received chunk into the output. The result is an all-gather: every
// device ends with every chunk in device order.
//
// Here the n shards are logical shards of one card, so no chip-to-chip link
// exists for the hops to hide, and each hop would only copy a chunk through
// a comm buffer within the same memory. The kernel computes the all-gather
// directly: one launch, grid (tiles of the chunk) x (owner). Block (x, o)
// reads tile x of owner o's chunk once from device memory and writes it at
// offset o*c into all n outputs. No comm buffers, no barrier: every output
// word has exactly one writer. The hop schedule returns only with
// peer-to-peer writes between cards (ROADMAP A.10); ops/ring_all_gather.py
// keeps it as the plain version, the spec the TPU kernel is compared with.
//
// Bound on the H100: bytes, 4*n*c in and 4*n*n*c out. At n = 8 and
// c = 39,063 words that is 1.25 MB + 10 MB, 3.36 us at 3.35 TB/s. Stores are
// 16-byte vectors (int4) throughout. When c % 4 == 0 and every row and the
// output are 16-byte aligned, each owner's offset o*c is aligned too, and a
// thread moves one int4 from its owner's row into all n outputs. Otherwise
// (the sharded wave's chunk of n_local/32 words is odd) a block stages a
// tile of kTileWords words of its owner's chunk in shared memory with
// coalesced 4-byte loads, then writes it into each output as aligned int4s
// from four shared-memory words each, with at most 3 scalar words at either
// end of the tile.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;
constexpr int kTileWords = 1024;  // the scalar path's shared-memory tile
constexpr long long kMaxBlocks = 132 * 8;

struct Rows {
  const int* row[kMaxShards];  // owner o's chunk: int32[c]
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ring_gather_kernel(const Rows src, int* out, int n, long long c) {
  const int o = blockIdx.y;
  int4* out4 = reinterpret_cast<int4*>(out);
  if constexpr (kVec) {
    const int4* in = reinterpret_cast<const int4*>(src.row[o]);
    const long long c4 = c >> 2;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < c4;
         i += (long long)gridDim.x * kThreads) {
      const int4 x = __ldg(in + i);
#pragma unroll 8
      for (int d = 0; d < n; ++d) out4[((long long)d * n + o) * c4 + i] = x;
    }
  } else {
    __shared__ int tile[kTileWords];
    const int* in = src.row[o];
    for (long long i0 = (long long)blockIdx.x * kTileWords; i0 < c;
         i0 += (long long)gridDim.x * kTileWords) {
      const int len = (int)(c - i0 < kTileWords ? c - i0 : kTileWords);
      for (int k = threadIdx.x; k < len; k += kThreads) tile[k] = __ldg(in + i0 + k);
      __syncthreads();
      for (int d = 0; d < n; ++d) {
        // this tile's words land at [at, end) of the flat output
        const long long at = ((long long)d * n + o) * c + i0, end = at + len;
        const long long a0 = (at + 3) & ~3ll, a1 = end & ~3ll;  // the aligned span
        if (a0 >= end) {  // no aligned int4 inside: a tile of < 4 words
          if (threadIdx.x < len) out[at + threadIdx.x] = tile[threadIdx.x];
          continue;
        }
        if (threadIdx.x < a0 - at) out[at + threadIdx.x] = tile[threadIdx.x];
        if (threadIdx.x < end - a1) out[a1 + threadIdx.x] = tile[a1 - at + threadIdx.x];
        for (long long q = (a0 >> 2) + threadIdx.x; q < (a1 >> 2); q += kThreads) {
          const int k = (int)((q << 2) - at);
          out4[q] = make_int4(tile[k], tile[k + 1], tile[k + 2], tile[k + 3]);
        }
      }
      __syncthreads();  // the tile is refilled next iteration
    }
  }
}

int gather(const Rows& src, void* out, int n, long long c, void* stream) {
  if (n < 1 || n > kMaxShards || c < 1 || (size_t)out % 16) return (int)cudaErrorInvalidValue;
  bool vec = c % 4 == 0;
  for (int o = 0; o < n; ++o) vec = vec && (size_t)src.row[o] % 16 == 0;
  const long long per_block = vec ? 4ll * kThreads : kTileWords;
  long long bx = (c + per_block - 1) / per_block;
  if (bx > kMaxBlocks / n) bx = kMaxBlocks / n;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  if (vec)
    ring_gather_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(src, (int*)out, n, c);
  else
    ring_gather_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(src, (int*)out, n, c);
  return (int)cudaGetLastError();
}

}  // namespace

// The shards' chunks as rows of one 2-D tensor: row o at base + o*row_stride
// words. out: int32[n, n*c]. One launch on `stream`.
extern "C" int ring_all_gather_rows_launch(const void* base, long long row_stride, void* out,
                                           int n, long long c, void* stream) {
  if (n < 1 || n > kMaxShards) return (int)cudaErrorInvalidValue;
  Rows src{};
  for (int o = 0; o < n; ++o) src.row[o] = (const int*)base + o * row_stride;
  return gather(src, out, n, c, stream);
}

// The shards' chunks as separate tensors: `ptrs` is a HOST array of n device
// pointers. out: int32[n, n*c]. One launch on `stream`.
extern "C" int ring_all_gather_table_launch(const void* ptrs, void* out, int n, long long c,
                                            void* stream) {
  if (n < 1 || n > kMaxShards) return (int)cudaErrorInvalidValue;
  Rows src{};
  for (int o = 0; o < n; ++o) src.row[o] = static_cast<const int* const*>(ptrs)[o];
  return gather(src, out, n, c, stream);
}
