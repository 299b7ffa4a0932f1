// or_popcount: merge a new bit vector into an old one and count the newly
// lit bits, popcount(new & ~old), in one streaming pass and one launch.
//
// Replaces the Pallas kernel stl_fusion_tpu/ops/pallas_kernels.py:
// _or_popcount_kernel / _or_popcount_2d (the wave finalizer). On the TPU the
// grid ran in order and carried the count in an SMEM scalar between grid
// steps. Here blocks run in parallel and in no order, so nothing carries
// over between them: each thread sums its own words, the block reduces them
// (warp shuffles, then shared memory), and the block that finishes last
// writes the count (below). No caller zeroes anything first.
//
// Forms (template argument), one body:
//   0 merge   out = old | new                               -> count
//   1 gate    out = old | new, delta = new & ~old           -> count
//   2 delta   delta = new & ~old (no merge)                 -> count
//   3 shards  per shard d (grid y): invalid_d |= row d of new -> counts[d],
//             and their total in counts[n]; invalid_d is column 4 of the
//             int64[n, 8] shard table the sharded wave already holds
//             (ops/wave.py::ShardTable), the new row new + d * row_stride.
// Aliasing: `out` may be `old` and `delta` may be `new` (the callers do
// both): every word is read before it is written, by the same thread, at
// the same index, so no pointer is __restrict__.
//
// The count without a memset, a ticket in the count's own atomic: each
// block adds (its partial << 11) | 1 into its shard's 64-bit accumulator with
// one atomicAdd. The low 11 bits count the blocks that have added (a launch
// has at most 1,056 blocks a shard), the rest their sum, so the block that
// reads back gridDim.x - 1 blocks before it is the last: it holds the whole
// sum without reading any other memory, writes the int64 count and puts the
// accumulator back to 0 for the next launch. The shards form does the same
// once more over the shards' sums (16 bits of ticket) for the total. Sums
// stay below 2^45 bits, so neither shift overflows: the launcher takes fewer
// than 2^40 words in all.
// The accumulators belong to one (device, stream) pair (the wrapper keys
// them so): launches on one stream run one after another, so an accumulator
// is only ever used by one launch at a time, and two streams never share
// one. A launch captured in a CUDA graph would keep the capture stream's
// accumulators for every replay, on whatever stream it runs, so the wrapper
// refuses to launch under capture.
//
// Bound on the H100: bytes. 12 B per word for merge, delta and shards (two
// int32 reads, one write), 16 B for gate (two reads, two writes), and one
// popcount per word; at 524,289 words that is 6.3-8.4 MB, 1.9-2.5 us at
// 3.35 TB/s. The body streams 16-byte vector loads (int4) in a grid-stride
// loop with a scalar tail for the ragged end (the wrapper checks 16-byte
// alignment). At these sizes the host's launch path costs more than the
// kernel, which is why this is one launch with nothing around it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 8;  // a shard's blocks; < 2^kTicketBits
constexpr int kTicketBits = 11;
constexpr int kShardBits = 16;  // gridDim.y <= 65,535

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v, valid in thread 0; every thread must call it.
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v,
                                                        unsigned long long* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum(lane < kWarps ? smem[lane] : 0ull);
  return v;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
or_popcount_kernel(const int* new_w, long long row_stride, const int* old_w, int* out,
                   int* delta, const long long* shard_rows, long long n,
                   unsigned long long* scratch, long long* counts) {
  constexpr bool kMerge = kForm != 2;
  constexpr bool kDelta = kForm == 1 || kForm == 2;
  if (kForm == 3) {
    new_w += blockIdx.y * row_stride;
    int* inv = reinterpret_cast<int*>(shard_rows[blockIdx.y * 8 + 4]);
    old_w = inv;
    out = inv;
  }
  const long long n_vec = n >> 2;
  const int4* new4 = reinterpret_cast<const int4*>(new_w);
  const int4* old4 = reinterpret_cast<const int4*>(old_w);
  int4* out4 = reinterpret_cast<int4*>(out);
  int4* delta4 = reinterpret_cast<int4*>(delta);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long local = 0;
  for (long long i = tid; i < n_vec; i += stride) {
    const int4 a = new4[i];
    const int4 b = old4[i];
    int4 d;
    d.x = a.x & ~b.x; d.y = a.y & ~b.y; d.z = a.z & ~b.z; d.w = a.w & ~b.w;
    if (kMerge) {
      int4 m;
      m.x = a.x | b.x; m.y = a.y | b.y; m.z = a.z | b.z; m.w = a.w | b.w;
      out4[i] = m;
    }
    if (kDelta) delta4[i] = d;
    local += __popc((unsigned)d.x) + __popc((unsigned)d.y) + __popc((unsigned)d.z) +
             __popc((unsigned)d.w);
  }
  for (long long i = (n_vec << 2) + tid; i < n; i += stride) {
    const int a = new_w[i];
    const int b = old_w[i];
    if (kMerge) out[i] = a | b;
    if (kDelta) delta[i] = a & ~b;
    local += __popc((unsigned)(a & ~b));
  }

  __shared__ unsigned long long smem[kWarps];
  local = block_sum(local, smem);
  if (threadIdx.x != 0) return;
  unsigned long long* acc = scratch + 1 + blockIdx.y;
  const unsigned long long before = atomicAdd(acc, (local << kTicketBits) | 1ull);
  if ((before & ((1ull << kTicketBits) - 1)) != gridDim.x - 1) return;
  const unsigned long long sum = (before >> kTicketBits) + local;
  *acc = 0ull;  // the next launch on this stream starts from 0
  counts[blockIdx.y] = (long long)sum;
  if (kForm == 3) {
    const unsigned long long prior = atomicAdd(scratch, (sum << kShardBits) | 1ull);
    if ((prior & ((1ull << kShardBits) - 1)) != gridDim.y - 1) return;
    *scratch = 0ull;
    counts[gridDim.y] = (long long)((prior >> kShardBits) + sum);
  }
}

}  // namespace

// The launch's arguments, packed by the wrapper as 12 little-endian int64
// (one bytes object a call: ctypes converts one pointer, not 12 integers).
// form: 0 merge, 1 gate, 2 delta, 3 shards (n_rows shards, n words each).
// scratch: 1 + `slots` u64 accumulators, zeroed once when the wrapper made
// them and left at 0 by every launch; slots >= n_rows. counts: int64[1], or
// int64[n_rows + 1] for the shards form (the total last).
struct LaunchArgs {
  long long form, new_w, row_stride, old_w, out, delta, shard_rows, n_rows, n, scratch, slots,
      counts;
};

extern "C" int or_popcount_launch(const LaunchArgs* a, void* stream) {
  const long long form = a->form, n_rows = a->n_rows, n = a->n;
  if (form < 0 || form > 3 || n_rows < 1 || n_rows > 65535 || (form != 3 && n_rows != 1) ||
      a->slots < n_rows || n < 0 || n * n_rows >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  const long long work = (n >> 2) > (n & 3) ? (n >> 2) : (n & 3);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)n_rows);
  cudaStream_t s = (cudaStream_t)stream;
  const int* nw = (const int*)a->new_w;
  const long long row_stride = a->row_stride;
  const int* ow = (const int*)a->old_w;
  int* o = (int*)a->out;
  int* d = (int*)a->delta;
  const long long* rows = (const long long*)a->shard_rows;
  unsigned long long* sc = (unsigned long long*)a->scratch;
  long long* c = (long long*)a->counts;
  switch (form) {
    case 0: or_popcount_kernel<0><<<grid, kThreads, 0, s>>>(nw, row_stride, ow, o, d, rows, n, sc, c); break;
    case 1: or_popcount_kernel<1><<<grid, kThreads, 0, s>>>(nw, row_stride, ow, o, d, rows, n, sc, c); break;
    case 2: or_popcount_kernel<2><<<grid, kThreads, 0, s>>>(nw, row_stride, ow, o, d, rows, n, sc, c); break;
    default: or_popcount_kernel<3><<<grid, kThreads, 0, s>>>(nw, row_stride, ow, o, d, rows, n, sc, c); break;
  }
  return (int)cudaGetLastError();
}
