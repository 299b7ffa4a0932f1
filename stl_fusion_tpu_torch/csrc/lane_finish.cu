// lane_finish: the epilogue of a lane-packed mirror burst.
//
// The counterpart of the XLA program stl_fusion_tpu/ops/topo_wave.py::
// topo_mirror_finish_lanes_step (with _lane_counts_blocked; no Pallas kernel
// there). A burst packs 32*W independent command groups into the W int32
// words of each topo row (group l is bit l % 32 of word l / 32) and sweeps
// them in one pass; this kernel turns the swept bits into the burst's result.
// For each real row r (is_real[r]) whose node perm[r] was valid before the
// burst (its bit in the dense packed invalid words is clear):
//   newly[r, :]    = final[r, :]            (every other row contributes 0)
//   lane_counts[l] += bit l % 32 of newly[r, l / 32]
//   union: newly[r, :] has a set bit  ->  union_count += 1 and perm[r]'s bit
//          is OR'ed into the dense invalid words and into the newly mask.
// perm is injective over real rows, so each dense bit is read and set by
// exactly one row: reading it before the atomicOr is race-free, and virtual
// rows (clipped perm) are skipped by is_real before any read.
//
// Bound on the H100: bytes at W = 16 (each row's W words, is_real and perm
// read, each real row's pre-invalid word, two atomic words per union row, the
// mask written: ~0.8 GB at 11.3M rows, ~0.25 ms at 3.35 TB/s); the 32*W bit
// tests per row are ~5.8 G operations if done one by one. PyTorch has neither
// a per-bit column popcount (unpacking [rows, W, 32] is 5.8 G elements) nor a
// scatter-OR into packed words, hence the kernel. The design:
// - thread t owns word column t % W of rows (t / W) + k * (threads / W):
//   a warp reads 32 / W whole rows, 128 contiguous bytes; each thread keeps
//   kUnroll rows' loads in flight (with one row a thread per step, the
//   latency of its dependent loads, not the bytes, set the time);
// - lane counts are bit-sliced: each thread adds its masked words into
//   kPlanes carry-save bit planes (plane i holds bit i of all 32 lanes'
//   counts), 3 operations a plane per word instead of 32 bit tests, and
//   flushes the planes into per-lane shared counters every 2^kPlanes - 1
//   rows; one global atomicAdd per lane per block at the end;
// - a row's union test ORs its W words across the W threads of its warp
//   segment with shuffles; the segment's first thread does the two atomicOrs
//   and counts the row.
// Any W: a power of two <= 32 (the port's lane bursts pack 32 * 2^j groups,
// W = 16 on the main path) is the one launch above. Any other W splits a
// row's words into column chunks of power-of-two widths <= 32, one launch
// each over all rows, with its lane counters at the chunk's 32 * col0 lanes;
// those launches read the pre-burst dense words and OR each union row's bit
// into the newly mask only, so a later chunk still sees the state before the
// burst. A last launch (lane_finish_kernel_commit) then ORs the newly mask
// into the dense words and counts its bits: perm is injective over real
// rows, so the union's rows are exactly the mask's bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPlanes = 8;  // counts up to 255 between flushes
constexpr int kFlushEvery = (1 << kPlanes) - 1;
constexpr int kUnroll = 4;  // rows a thread has in flight
constexpr int kMaxBlocksPerSm = 4;
constexpr int kSms = 132;

__device__ __forceinline__ void flush_planes(unsigned (&c)[kPlanes], int* lane_sh, int w) {
  for (int b = 0; b < 32; ++b) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) n |= (int)((c[i] >> b) & 1u) << i;
    if (n) atomicAdd(&lane_sh[w * 32 + b], n);
  }
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) c[i] = 0;
}

// CHUNK: one column chunk of a wider row (row stride `stride`, columns from
// col0, no commit); without it the row is the W words themselves and the
// union commits, the code of a power-of-two W <= 32.
template <bool CHUNK>
__global__ void __launch_bounds__(kThreads)
lane_finish_kernel(const int* __restrict__ bits, const unsigned char* __restrict__ is_real,
                   const int* __restrict__ perm, int* g_inv, int* newly, int* lane_counts,
                   int* union_count, long long n_rows, int W, int stride, int col0) {
  const int row_stride = CHUNK ? stride : W;
  const int c0 = CHUNK ? col0 : 0;
  __shared__ int lane_sh[32 * 32];
  __shared__ int block_unions;
  const int L = 32 * W;
  for (int i = threadIdx.x; i < L; i += blockDim.x) lane_sh[i] = 0;
  if (threadIdx.x == 0) block_unions = 0;
  __syncthreads();
  const int w = threadIdx.x & (W - 1);
  const int rows_per_block = blockDim.x / W;
  const long long step = (long long)gridDim.x * rows_per_block;
  unsigned c[kPlanes];
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) c[i] = 0;
  int since_flush = 0, unions = 0;
  // kUnroll rows a thread per trip, their loads issued together: the chain
  // perm -> pre-invalid word is the only dependent one, and the words load
  // beside it. The loop bound is uniform across the block, so every thread
  // of a warp reaches the shuffles together.
  for (long long base = (long long)blockIdx.x * rows_per_block * kUnroll; base < n_rows;
       base += step * kUnroll) {
    unsigned v[kUnroll];
    int p[kUnroll];
    bool real[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + (long long)u * rows_per_block + threadIdx.x / W;
      const bool in = r < n_rows;
      real[u] = in && is_real[r];
      p[u] = in ? __ldg(perm + r) : 0;
      v[u] = in ? (unsigned)__ldg(bits + r * row_stride + c0 + w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (!real[u] || ((g_inv[p[u] >> 5] >> (p[u] & 31)) & 1)) v[u] = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned carry = v[u];  // carry-save add of v into the planes
#pragma unroll
      for (int i = 0; i < kPlanes; ++i) {
        const unsigned t = c[i] & carry;
        c[i] ^= carry;
        carry = t;
      }
      unsigned any = v[u];
      for (int off = W >> 1; off > 0; off >>= 1) any |= __shfl_xor_sync(0xffffffffu, any, off);
      if (w == 0 && any) {
        const int bit = (int)(1u << (p[u] & 31));
        if (!CHUNK) atomicOr(g_inv + (p[u] >> 5), bit);
        atomicOr(newly + (p[u] >> 5), bit);
        if (!CHUNK) ++unions;
      }
    }
    since_flush += kUnroll;
    if (since_flush > kFlushEvery - kUnroll) {
      flush_planes(c, lane_sh, w);
      since_flush = 0;
    }
  }
  flush_planes(c, lane_sh, w);
  if (unions) atomicAdd(&block_unions, unions);
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    if (lane_sh[i]) atomicAdd(lane_counts + 32 * c0 + i, lane_sh[i]);
  if (threadIdx.x == 0 && block_unions) atomicAdd(union_count, block_unions);
}

// The chunked form's commit: g_inv |= newly, union_count += popcount(newly).
__global__ void __launch_bounds__(kThreads)
lane_finish_kernel_commit(int* g_inv, const int* __restrict__ newly, int* union_count,
                          long long n_words) {
  __shared__ int block_unions;
  if (threadIdx.x == 0) block_unions = 0;
  __syncthreads();
  int unions = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_words;
       i += (long long)gridDim.x * blockDim.x) {
    const int x = __ldg(newly + i);
    if (x) {
      g_inv[i] |= x;
      unions += __popc((unsigned)x);
    }
  }
  if (unions) atomicAdd(&block_unions, unions);
  __syncthreads();
  if (threadIdx.x == 0 && block_unions) atomicAdd(union_count, block_unions);
}

template <bool CHUNK>
int launch_chunk(const int* bits, const unsigned char* is_real, const int* perm, int* g_inv,
                 int* newly, int* lane_counts, int* union_count, long long n_rows, int Wc,
                 int stride, int col0, cudaStream_t stream) {
  const long long rows_per_block = kThreads / Wc;
  long long blocks = (n_rows + rows_per_block * kUnroll - 1) / (rows_per_block * kUnroll);
  if (blocks > (long long)kSms * kMaxBlocksPerSm) blocks = (long long)kSms * kMaxBlocksPerSm;
  if (blocks < 1) blocks = 1;
  lane_finish_kernel<CHUNK><<<(unsigned)blocks, kThreads, 0, stream>>>(
      bits, is_real, perm, g_inv, newly, lane_counts, union_count, n_rows, Wc, stride, col0);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch. bits int32[n_rows, W] (the swept state), is_real uint8[n_rows],
// perm int32[n_rows] (each row's original id, clipped into the dense words),
// g_inv int32 dense words (updated in place), newly int32 mask words like
// g_inv, lane_counts int32[32 * W] and union_count int32[1]: the last three
// zeroed by the caller. n_words is the word count of g_inv and newly. W >= 1
// (checked by the wrapper); `launched` (host int) receives the CUDA launches
// made: 1 when W is a power of two <= 32, else one per column chunk + 1.
extern "C" int lane_finish_launch(const void* bits, const void* is_real, const void* perm,
                                  void* g_inv, void* newly, void* lane_counts, void* union_count,
                                  long long n_rows, int W, long long n_words, void* launched,
                                  void* stream) {
  const int* b = (const int*)bits;
  const unsigned char* real = (const unsigned char*)is_real;
  const int* p = (const int*)perm;
  cudaStream_t s = (cudaStream_t)stream;
  int* made = (int*)launched;
  *made = 0;
  if (W <= 32 && (W & (W - 1)) == 0) {
    *made = 1;
    return launch_chunk<false>(b, real, p, (int*)g_inv, (int*)newly, (int*)lane_counts,
                               (int*)union_count, n_rows, W, W, 0, s);
  }
  for (int col0 = 0; col0 < W;) {
    int wc = 32;
    while (wc > W - col0) wc >>= 1;
    const int err = launch_chunk<true>(b, real, p, (int*)g_inv, (int*)newly,
                                       (int*)lane_counts, (int*)union_count, n_rows, wc, W,
                                       col0, s);
    ++*made;
    if (err) return err;
    col0 += wc;
  }
  long long blocks = (n_words + kThreads - 1) / kThreads;
  if (blocks > (long long)kSms * kMaxBlocksPerSm) blocks = (long long)kSms * kMaxBlocksPerSm;
  if (blocks < 1) blocks = 1;
  lane_finish_kernel_commit<<<(unsigned)blocks, kThreads, 0, s>>>(
      (int*)g_inv, (const int*)newly, (int*)union_count, n_words);
  ++*made;
  return (int)cudaGetLastError();
}
