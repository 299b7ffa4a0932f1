// topo_sweep: the depth-free topological sweep of the invalidation wave.
//
// The counterpart of the XLA program stl_fusion_tpu/ops/topo_wave.py::
// _topo_sweep_impl (no Pallas kernel there). Rows are nodes renumbered into
// topological level order, so every live in-edge of a level points at a
// strictly lower level; one pass over the levels in ascending order computes
// the whole transitive closure of 32*W packed waves. Per row r of a level and
// each of its W int32 words:
//   eff_j  = in_src[r, j] if edge_epoch[r, j] == node_epoch[r], else the null row
//   out[r] = before[r] | seed[r] | OR_j out[eff_j]
// and per word the count of real rows' newly lit bits,
//   counts[w] += popcount((seed | gathered) & ~before)   (over is_real rows).
// A row is written exactly once per sweep, so counting at write time is exact.
// The null row n_tot ends 0 and is never gathered (it reads as 0).
// Optionally `changed` (one device int) is set to 1 when any row, real or
// virtual, gets a bit it lacked before the sweep: the stop test of the
// adaptive multi-pass sweep (JAX `_sweep_adaptive` compares the whole state
// before and after a pass; the counts above cover real rows only, and a
// pass that lights only virtual collector rows still feeds real rows on the
// next one).
//
// Launches: one per non-empty level, enqueued by topo_sweep_launch from the
// host's level_starts with no sync between them (stream order makes level l
// see the final rows of levels < l). Levels below start_level are merged with
// their seeds and not gathered (level 0 has no in-edges by construction). The
// rows past the last level (quantization pads and the null row) ride the
// first launch as a second row range, merged with their seeds, never gathered.
//
// Bound on the H100: bytes. Per sweep each row reads its in_src and
// edge_epoch rows (4k B each), its epoch, is_real, its W words and their
// seed words, and writes its W words; each live in-slot gathers a W-word
// row of an earlier level. At 10M rows, k=4 and W=16 that is ~4.2 GB,
// ~1.25 ms at 3.35 TB/s, and the gathers are random 64 B rows. The design:
// - W % 4 == 0: W/4 threads a row, each with one int4 (16 B) of the row's
//   words, so a row's 64 B are one contiguous access of 4 lanes and each
//   gather is one 64 B row read; otherwise one thread per word (W = 1, the
//   live mirror's form, k = 6 through its two slack columns);
// - a thread first loads the ids and epochs of up to kMaxK = 8 slots, then
//   issues the gathers of the live ones together; pad slots and dead edges
//   load nothing; a row of k > 8 slots repeats that per chunk of 8 (a
//   separate instantiation, so k <= 8 keeps its code and registers);
// - counts: per thread in registers across a grid-stride loop, then shared
//   memory atomics per block, then one global atomicAdd per word per block.
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

// read-only path: rows of earlier levels and seeds are not written by this launch
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

// Rows [r0, r0+n0) (gathered when `gather`), then rows [r1, r1+n1) (merged only).
// CHUNKED (k > kMaxK) walks the slots in chunks of kMaxK; without it the
// chunk loop is one trip at j0 = 0, the code of k <= kMaxK.
template <int VEC, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
topo_sweep_kernel(const int* __restrict__ in_src, const int* __restrict__ edge_epoch,
                  const int* __restrict__ node_epoch, const unsigned char* __restrict__ is_real,
                  const int* __restrict__ seed, int* inv, int* counts, int* changed,
                  long long r0, long long n0, long long r1, long long n1,
                  int k, int W, long long n_tot, int gather) {
  extern __shared__ int block_counts[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) block_counts[i] = 0;
  __syncthreads();

  const int tpr = W / VEC;                    // threads per row; blockDim is a multiple
  const int rows_per_block = blockDim.x / tpr;
  const int g = threadIdx.x % tpr;            // this thread's word group, fixed
  int local[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) local[c] = 0;
  int lit = 0;  // some row of this thread gained a bit

  const long long total = n0 + n1;
  const long long step = (long long)gridDim.x * rows_per_block;
  for (long long i = (long long)blockIdx.x * rows_per_block + threadIdx.x / tpr; i < total;
       i += step) {
    const long long r = i < n0 ? r0 + i : r1 + (i - n0);
    const long long off = r * W + (long long)g * VEC;
    int before[VEC], fire[VEC];
    load_row<VEC>(inv + off, before);
    if (r == n_tot) {  // the null row: always 0, never counted
#pragma unroll
      for (int c = 0; c < VEC; ++c) fire[c] = 0;
      store_row<VEC>(inv + off, fire);
      continue;
    }
    if (seed != nullptr) {
      ldg_row<VEC>(seed + off, fire);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) fire[c] = 0;
    }
    if (gather && i < n0) {
      const int own = __ldg(node_epoch + r);
      // the in-slots in chunks of kMaxK (one chunk when k <= kMaxK): a
      // chunk's ids and epochs load together, then its live gathers
      for (int j0 = 0; j0 < (CHUNKED ? k : 1); j0 += kMaxK) {
        int src[kMaxK];
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          src[j] = (int)n_tot;
          if (j0 + j < k) {
            const int s = __ldg(in_src + r * k + j0 + j);
            if (s != (int)n_tot && __ldg(edge_epoch + r * k + j0 + j) == own) src[j] = s;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (src[j] != (int)n_tot) {
            int v[VEC];
            ldg_row<VEC>(inv + (long long)src[j] * W + (long long)g * VEC, v);
#pragma unroll
            for (int c = 0; c < VEC; ++c) fire[c] |= v[c];
          }
        }
      }
    }
    int out[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      out[c] = before[c] | fire[c];
      lit |= fire[c] & ~before[c];
    }
    store_row<VEC>(inv + off, out);
    if (is_real[r]) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) local[c] += __popc((unsigned)(fire[c] & ~before[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < VEC; ++c)
    if (local[c]) atomicAdd(&block_counts[g * VEC + c], local[c]);
  if (__syncthreads_or(lit) && threadIdx.x == 0 && changed != nullptr) atomicOr(changed, 1);
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    if (block_counts[i]) atomicAdd(counts + i, block_counts[i]);
}

template <int VEC, bool CHUNKED>
int launch_rows(const int* in_src, const int* edge_epoch, const int* node_epoch,
                const unsigned char* is_real, const int* seed, int* inv, int* counts,
                int* changed, long long r0, long long n0, long long r1, long long n1, int k,
                int W, long long n_tot, int gather, cudaStream_t stream) {
  const int tpr = W / VEC;
  const int threads = (kThreads / tpr) * tpr;
  const int rows_per_block = threads / tpr;
  long long blocks = (n0 + n1 + rows_per_block - 1) / rows_per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  topo_sweep_kernel<VEC, CHUNKED><<<(unsigned)blocks, threads, W * sizeof(int), stream>>>(
      in_src, edge_epoch, node_epoch, is_real, seed, inv, counts, changed, r0, n0, r1, n1, k,
      W, n_tot, gather);
  return (int)cudaGetLastError();
}

}  // namespace

// One sweep: a launch per non-empty level (levels < start_level merged, not
// gathered); the rows [tail, n_tot] ride the first launch, merged only (a
// whole sweep passes tail = level_starts[n_levels]: the pads past the last
// level and the null row; tail = n_tot + 1 is no tail). `seed` may be null (no
// seeds); `changed` may be null (no changed flag). `level_starts` is a HOST
// array of n_levels+1 int64; `launched` (host int) receives the number of
// launches made. Requires W / (vec4 ? 4 : 1) <= 256 (checked by the
// wrapper); any k.
extern "C" int topo_sweep_launch(const void* in_src, const void* edge_epoch,
                                 const void* node_epoch, const void* is_real, const void* seed,
                                 void* inv, void* counts, void* changed,
                                 const void* level_starts, int n_levels,
                                 int start_level, int k, int W, long long n_tot, long long tail,
                                 int vec4, void* launched, void* stream) {
  const long long* starts = (const long long*)level_starts;
  long long tail_n = n_tot + 1 - tail;
  int made = 0;
  int err = 0;
  auto run = [&](long long a, long long n, int gather) {
    const long long r1 = tail, n1 = tail_n;
    tail_n = 0;  // only the first launch takes the tail
    auto* f = vec4 ? (k > kMaxK ? launch_rows<4, true> : launch_rows<4, false>)
                   : (k > kMaxK ? launch_rows<1, true> : launch_rows<1, false>);
    return f((const int*)in_src, (const int*)edge_epoch, (const int*)node_epoch,
             (const unsigned char*)is_real, (const int*)seed, (int*)inv, (int*)counts,
             (int*)changed, a, n, r1, n1, k, W, n_tot, gather, (cudaStream_t)stream);
  };
  for (int l = 0; l < n_levels && err == 0; ++l) {
    const long long a = starts[l], b = starts[l + 1];
    if (a == b) continue;
    err = run(a, b - a, l >= start_level ? 1 : 0);
    ++made;
  }
  if (made == 0 && err == 0 && tail_n > 0) {  // no non-empty level: the tail alone
    err = run(0, 0, 0);
    ++made;
  }
  *(int*)launched = made;
  return err;
}
