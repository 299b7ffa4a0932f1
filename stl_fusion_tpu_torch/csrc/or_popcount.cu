// or_popcount: merged = old | new, count += popcount(new & ~old), one pass.
//
// Replaces the Pallas kernel stl_fusion_tpu/ops/pallas_kernels.py:
// _or_popcount_kernel / _or_popcount_2d (the wave finalizer). On the TPU the
// grid ran in order and carried the count in an SMEM scalar between grid
// steps. Here blocks run in parallel and in no order, so nothing carries
// over between them: each thread sums its own words, a warp reduces with
// shuffles, the block reduces the warp sums in shared memory, and each block
// makes one atomicAdd into a u64 counter the wrapper zeroed.
//
// Bound on the H100: bytes. 12 B per word (two int32 reads, one write) and
// one popcount per word; at 524,289 words that is ~6.3 MB, ~1.9 us at
// 3.35 TB/s, so launch latency dominates. The design streams 16-byte vector
// loads (int4) in a grid-stride loop with a scalar tail for the ragged end
// (the wrapper checks 16-byte alignment), and keeps the reduction to one
// atomic per block.
//
// `merged` may alias `old`: every element is read before it is written, by
// the same thread, so neither pointer is __restrict__.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
or_popcount_kernel(const int* new_w, const int* old_w, int* merged, long long n,
                   unsigned long long* count) {
  const long long n_vec = n >> 2;
  const int4* new4 = reinterpret_cast<const int4*>(new_w);
  const int4* old4 = reinterpret_cast<const int4*>(old_w);
  int4* out4 = reinterpret_cast<int4*>(merged);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long local = 0;
  for (long long i = tid; i < n_vec; i += stride) {
    const int4 a = new4[i];
    const int4 b = old4[i];
    int4 m;
    m.x = a.x | b.x; m.y = a.y | b.y; m.z = a.z | b.z; m.w = a.w | b.w;
    out4[i] = m;
    local += __popc((unsigned)(a.x & ~b.x)) + __popc((unsigned)(a.y & ~b.y)) +
             __popc((unsigned)(a.z & ~b.z)) + __popc((unsigned)(a.w & ~b.w));
  }
  for (long long i = (n_vec << 2) + tid; i < n; i += stride) {
    const int a = new_w[i];
    const int b = old_w[i];
    merged[i] = a | b;
    local += __popc((unsigned)(a & ~b));
  }
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  local = warp_sum(local);
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    local = lane < kThreads / 32 ? warp_sums[lane] : 0ull;
    local = warp_sum(local);
    if (lane == 0 && local) atomicAdd(count, local);
  }
}

}  // namespace

extern "C" int or_popcount_launch(const void* new_w, const void* old_w, void* merged,
                                  long long n, void* count, void* stream) {
  const long long work = (n >> 2) > (n & 3) ? (n >> 2) : (n & 3);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  or_popcount_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)new_w, (const int*)old_w, (int*)merged, n,
      (unsigned long long*)count);
  return (int)cudaGetLastError();
}
