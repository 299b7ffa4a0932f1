// packed_pull: one BFS level of the bit-packed pull wave, over every row.
//
// The counterpart of two XLA programs (no Pallas kernel there):
// stl_fusion_tpu/parallel/packed_wave.py::build_packed_sharded_wave's level
// body (the shard_map'ed `body`: all_gather of the frontier words, the row
// gather, the epoch-masked OR-fold, the merge and the continuation psum) and
// stl_fusion_tpu/ops/pull_wave.py::_pull_wave32_impl's `body` (one shard,
// W = 1, the null row's fire forced to 0). Each row r holds its <= k in-slots
// (in_src[r, :], edge_epoch[r, :]) and W int32 words: 32*W packed waves, bit
// l % 32 of word l / 32 for wave l (lane 31 is the sign bit). Per row, with
// `before` its invalid words when the launch starts:
//   gather (a level):  fire = OR over slots j with edge_epoch[r, j] == node_epoch[r]
//                             of frontier[in_src[r, j], :]      (0 at null_row)
//   seed step:         fire = frontier[r, :]                    (the seed words)
//   fire &= ~before;   invalid[r, :] = before | fire;   next[r, :] = fire
//   counts[w] += popcount(fire[w])   (or of before | fire with count_all), real rows only
//   any fire anywhere sets *flag_out to 1.
// frontier and next are separate tensors (Jacobi, as JAX's while_loop): a
// level reads only the previous level's fire, so the level count and the
// per-level counts are JAX's. On a one-card mesh of logical shards the
// shards' frontier words are the row blocks of one [n_global, W] tensor, so
// the all-gather IS that tensor and the launch covers all shards' rows.
//
// Early exit: when flag_in is given and *flag_in == 0 (the previous level
// lit nothing), the launch returns at once. The host enqueues a group of
// levels, each reading the flag the one before it wrote, and reads the flags
// once per group (ops/packed_pull.py::pull_to_fixpoint).
//
// Bound on the H100: bytes. A level must read each row's in_src and
// edge_epoch rows (8k B), its epoch and is_real (5 B), its invalid words and
// (once) the frontier words (8W B), and write its next words (4W B) and the
// invalid words of the rows that fire (4W B each): rows * (8k + 5 + 12W) +
// lit_rows * 4W. At 10M rows, k = 8, W = 16 that is ~2.6 GB, ~0.78 ms at
// 3.35 TB/s. The gathers read the frontier once per LIVE slot, not once per
// row (~3 random 64 B rows a row on the power-law DAG: ~1.9 GB more), and a
// Jacobi level reads every row even when the frontier is a few hundred
// nodes (the tail levels; JAX answers that with the hybrid kernel, B.11).
// The design, the simple form first:
// - W % 4 == 0: W/4 threads a row, each one int4 (16 B) of the row's words
//   and of every gathered row (a 64 B row at W = 16 is one access of 4
//   lanes); otherwise one thread per word (W = 1: the pull wave);
// - a thread loads the epochs and ids of a chunk of kMaxK = 8 slots, then
//   issues the gathers of the live ones together; dead and pad slots gather
//   nothing; k > 8 repeats that per chunk (a separate instantiation);
// - the invalid row is written only when the row fires; next always;
// - counts per thread in registers over a grid-stride loop, then shared
//   memory atomics per block, then one global atomicAdd per word per block;
//   the flag is one plain store per block that lit something.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;
constexpr int kMaxK = 8;

template <int VEC>
__device__ __forceinline__ void load_row(const int* p, int (&w)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else {
    w[0] = *p;
  }
}

// read-only path: the frontier is not written by this launch
template <int VEC>
__device__ __forceinline__ void ldg_row(const int* p, int (&w)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else {
    w[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(int* p, const int (&w)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(w[0], w[1], w[2], w[3]);
  } else {
    *p = w[0];
  }
}

// CHUNKED (k > kMaxK) walks the slots in chunks of kMaxK; without it the
// chunk loop is one trip at j0 = 0, the code of k <= kMaxK.
template <int VEC, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
packed_pull_kernel(const int* __restrict__ in_src, const int* __restrict__ edge_epoch,
                   const int* __restrict__ node_epoch, const unsigned char* __restrict__ is_real,
                   const int* __restrict__ frontier, int* __restrict__ next, int* inv,
                   int* counts, const int* flag_in, int* flag_out, long long n_rows, int k,
                   int W, long long null_row, int gather, int count_all) {
  // the previous level lit nothing: the wave has ended (uniform per launch)
  if (flag_in != nullptr && *flag_in == 0) return;
  extern __shared__ int block_counts[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) block_counts[i] = 0;
  __syncthreads();

  const int tpr = W / VEC;                    // threads per row; blockDim is a multiple
  const int rows_per_block = blockDim.x / tpr;
  const int g = threadIdx.x % tpr;            // this thread's word group, fixed
  int local[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) local[c] = 0;
  int lit = 0;

  const long long step = (long long)gridDim.x * rows_per_block;
  for (long long r = (long long)blockIdx.x * rows_per_block + threadIdx.x / tpr; r < n_rows;
       r += step) {
    const long long off = r * W + (long long)g * VEC;
    int before[VEC], fire[VEC];
    load_row<VEC>(inv + off, before);
    if (gather) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) fire[c] = 0;
      if (r != null_row) {
        const int own = __ldg(node_epoch + r);
        for (int j0 = 0; j0 < (CHUNKED ? k : 1); j0 += kMaxK) {
          int src[kMaxK];
#pragma unroll
          for (int j = 0; j < kMaxK; ++j) {
            src[j] = -1;
            if (j0 + j < k && __ldg(edge_epoch + r * k + j0 + j) == own) {
              const int s = __ldg(in_src + r * k + j0 + j);
              if (s >= 0 && s < n_rows) src[j] = s;  // JAX clamps; a valid table never needs it
            }
          }
#pragma unroll
          for (int j = 0; j < kMaxK; ++j) {
            if (src[j] >= 0) {
              int v[VEC];
              ldg_row<VEC>(frontier + (long long)src[j] * W + (long long)g * VEC, v);
#pragma unroll
              for (int c = 0; c < VEC; ++c) fire[c] |= v[c];
            }
          }
        }
      }
    } else {
      ldg_row<VEC>(frontier + off, fire);  // the seed words
    }
    int any = 0;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      fire[c] &= ~before[c];
      any |= fire[c];
    }
    store_row<VEC>(next + off, fire);
    int after[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) after[c] = before[c] | fire[c];
    if (any) store_row<VEC>(inv + off, after);
    if (is_real[r]) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) local[c] += __popc((unsigned)(count_all ? after[c] : fire[c]));
    }
    lit |= any;
  }
#pragma unroll
  for (int c = 0; c < VEC; ++c)
    if (local[c]) atomicAdd(&block_counts[g * VEC + c], local[c]);
  if (__syncthreads_or(lit) && threadIdx.x == 0 && flag_out != nullptr) *flag_out = 1;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    if (block_counts[i]) atomicAdd(counts + i, block_counts[i]);
}

template <int VEC, bool CHUNKED>
int launch_level(const int* in_src, const int* edge_epoch, const int* node_epoch,
                 const unsigned char* is_real, const int* frontier, int* next, int* inv,
                 int* counts, const int* flag_in, int* flag_out, long long n_rows, int k, int W,
                 long long null_row, int gather, int count_all, cudaStream_t stream) {
  const int tpr = W / VEC;
  const int threads = (kThreads / tpr) * tpr;
  const int rows_per_block = threads / tpr;
  long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  packed_pull_kernel<VEC, CHUNKED><<<(unsigned)blocks, threads, W * sizeof(int), stream>>>(
      in_src, edge_epoch, node_epoch, is_real, frontier, next, inv, counts, flag_in, flag_out,
      n_rows, k, W, null_row, gather, count_all);
  return (int)cudaGetLastError();
}

}  // namespace

// One level (gather = 1) or the seed step (gather = 0: `frontier` holds the
// seed words). flag_in / flag_out may be null (no early exit / no flag);
// null_row < 0 is no null row. Requires W / (vec4 ? 4 : 1) <= 256 and, with
// vec4, 16-byte aligned word tensors (checked by the wrapper); any k.
extern "C" int packed_pull_launch(const void* in_src, const void* edge_epoch,
                                  const void* node_epoch, const void* is_real,
                                  const void* frontier, void* next, void* inv, void* counts,
                                  const void* flag_in, void* flag_out, long long n_rows, int k,
                                  int W, long long null_row, int gather, int count_all, int vec4,
                                  void* stream) {
  auto* f = vec4 ? (k > kMaxK ? launch_level<4, true> : launch_level<4, false>)
                 : (k > kMaxK ? launch_level<1, true> : launch_level<1, false>);
  return f((const int*)in_src, (const int*)edge_epoch, (const int*)node_epoch,
           (const unsigned char*)is_real, (const int*)frontier, (int*)next, (int*)inv,
           (int*)counts, (const int*)flag_in, (int*)flag_out, n_rows, k, W, null_row, gather,
           count_all, (cudaStream_t)stream);
}
