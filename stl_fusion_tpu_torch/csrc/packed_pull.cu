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
// The fired summary: one bit a row, int32 words [ceil(rows / 32)], bit
// r % 32 of word r / 32 set when row r fired. Frontier row s is non-zero
// exactly when s fired in the level before, so a level given the previous
// level's summary (sum_in) gathers slot j only when its source s is in
// range, s's bit is set and the slot's epoch matches: a zero frontier row
// is never read, and no bit of the result changes. A launch given sum_out
// writes this launch's summary (whole words, one store each: no memset)
// and writes next ONLY for the rows that fire; a reader treats every row
// whose bit is clear as zero and never reads it. Without sum_out every
// row's next is written, as before the summary existed.
//
// Early exit: when flag_in is given and *flag_in == 0 (the previous level
// lit nothing), the launch returns at once, writing nothing. The host
// enqueues a group of levels, each reading the flag the one before it
// wrote, and reads the flags once per group
// (ops/packed_pull.py::run_pull_wave).
//
// Bound on the H100: bytes, and what a level must move depends on its
// frontier. Every level reads each row's slot ids (4k B) and the summary
// (rows / 8 B, 1.25 MB at 10M rows, resident in the 50 MB L2) and writes its
// own summary; a row with a live slot whose source fired also reads its
// slots' epochs, node_epoch, its invalid words (4W B) and 4W B per gathered
// row; a row that fires writes its invalid and next words and reads
// is_real. A level lighting 48,023 of 10M rows thus needs ~0.4 GB
// (~0.12 ms at 3.35 TB/s), where a full-table pass moves ~2.6 GB.
// The design:
// - a warp owns one summary word: 32 consecutive rows. Phase 1 (the scan):
//   lane l takes row 32w + l, loads its slot ids as 16- or 8-byte vectors
//   (one int4 per 4 slots when k % 4 == 0 and the tables are aligned),
//   tests each source's summary bit first (an L2 hit), and only for slots
//   whose source fired loads the epochs (vectors again) and node_epoch:
//   a mask of the slots to gather, up to 32 slots (slots past 32 are
//   tested in phase 2). A ballot says which rows have any;
// - phase 2 (the words): W/4 lanes a row with 16-byte loads when
//   W % 4 == 0, else one lane a word (rounded up to a power of two, <= 32
//   lanes; wider rows loop over word groups). The passes take only the
//   rows with a slot to gather, 32 / tpr a pass in row order (in a gated
//   level; a seed step, an ungated or a count_all launch takes every
//   row): a tail level runs nearly no pass, and at W = 16 a warp with at
//   most 8 rows to gather runs one pass of the 4 a dense warp runs. The
//   rows that fire OR their bits into the word (a warp reduction). At
//   W = 1 (tpr = 1) a lane keeps its scan row: one pass. The row's mask and
//   (k <= 8) its slot ids come from the scan lane by shuffle, so no slot
//   is loaded twice (k > 8 reloads the live ones);
// - at W % 4 == 0 the kernel is held to 64 registers, 4 blocks an SM: more
//   warps in flight on the dense levels (PERF.md §6 has the A/B);
// - the invalid row is written only when the row fires; next only when it
//   fires (with sum_out) or always (without);
// - counts per lane in registers over the grid-stride loop, then shared
//   memory atomics per block, then one global atomicAdd per word per block;
//   the flag is one plain store per block that lit something.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 8;
constexpr int kMaxK = 8;         // slots a lane holds in registers at once
constexpr int kMaskSlots = 32;   // slots the scan's mask covers
constexpr unsigned kFull = 0xffffffffu;

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

// SV consecutive slots (ids or epochs) in one load
template <int SV>
__device__ __forceinline__ void ldg_slots(const int* p, int* v) {
  if constexpr (SV == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (SV == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// the position of the n-th (from 0) set bit of x, n < popc(x)
__device__ __forceinline__ int nth_set_bit(unsigned x, int n) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int low = __popc(x & ((1u << half) - 1u));
    if (n >= low) {
      n -= low;
      x >>= half;
      pos += half;
    }
  }
  return pos;
}

// did source s fire in the level before? (no summary: every source may have)
__device__ __forceinline__ bool fired(const unsigned* summary, int s) {
  return summary == nullptr || ((__ldg(summary + (s >> 5)) >> (s & 31)) & 1u);
}

// Phase 1 for row r: the mask of its first min(k, 32) slots to gather (in
// range, source fired, epoch live), epochs and node_epoch loaded only for
// slots whose source fired; `first` gets its first kMaxK slot ids. CHUNKED
// (k > kMaxK) walks the slots in chunks.
template <int SV, bool CHUNKED>
__device__ __forceinline__ unsigned scan_row(const int* __restrict__ in_src,
                                             const int* __restrict__ edge_epoch,
                                             const int* __restrict__ node_epoch,
                                             const unsigned* __restrict__ sum_in, long long r,
                                             long long n_rows, int k, int (&first)[kMaxK]) {
  unsigned m = 0;
  int own = 0;
  bool have_own = false;
  const long long base = r * k;
  const int kc = k < kMaskSlots ? k : kMaskSlots;
  for (int c0 = 0; c0 < (CHUNKED ? kc : 1); c0 += kMaxK) {
    int s[kMaxK];
#pragma unroll
    for (int v = 0; v < kMaxK; v += SV) {
      if (c0 + v < kc) {
        ldg_slots<SV>(in_src + base + c0 + v, s + v);
      } else {
#pragma unroll
        for (int t = 0; t < SV; ++t) s[v + t] = -1;
      }
    }
    if (c0 == 0) {
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) first[j] = s[j];
    }
    unsigned f = 0;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)  // JAX clamps; a valid table never needs it
      if (s[j] >= 0 && s[j] < n_rows && fired(sum_in, s[j])) f |= 1u << j;
    if (f) {
      if (!have_own) {
        own = __ldg(node_epoch + r);
        have_own = true;
      }
#pragma unroll
      for (int v = 0; v < kMaxK; v += SV) {
        if ((f >> v) & ((1u << SV) - 1u)) {
          int e[SV];
          ldg_slots<SV>(edge_epoch + base + c0 + v, e);
#pragma unroll
          for (int t = 0; t < SV; ++t)
            if (((f >> (v + t)) & 1u) && e[t] == own) m |= 1u << (c0 + v + t);
        }
      }
    }
  }
  return m;
}

// Phase 2's gathers for row r and this lane's words [col, col + VEC): the
// slots of mask m (ids from the scan lane when k <= kMaxK, else reloaded),
// and slots past kMaskSlots tested here in full.
template <int VEC, bool CHUNKED>
__device__ __forceinline__ void gather_row(const int* __restrict__ in_src,
                                           const int* __restrict__ edge_epoch,
                                           const int* __restrict__ node_epoch,
                                           const unsigned* __restrict__ sum_in,
                                           const int* __restrict__ frontier, long long r,
                                           long long n_rows, int k, int W, int col, unsigned m,
                                           const int (&ids)[kMaxK], int (&fire)[VEC]) {
  const long long base = r * k;
  for (int j0 = 0; j0 < (CHUNKED ? k : 1); j0 += kMaxK) {
    int src[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      const int jj = j0 + j;
      src[j] = -1;
      if (jj < k) {
        if (jj < kMaskSlots) {
          if ((m >> jj) & 1u) src[j] = CHUNKED ? __ldg(in_src + base + jj) : ids[j];
        } else {
          const int s = __ldg(in_src + base + jj);
          if (s >= 0 && s < n_rows && fired(sum_in, s) &&
              __ldg(edge_epoch + base + jj) == __ldg(node_epoch + r))
            src[j] = s;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (src[j] >= 0) {
        int v[VEC];
        ldg_row<VEC>(frontier + (long long)src[j] * W + col, v);
#pragma unroll
        for (int c = 0; c < VEC; ++c) fire[c] |= v[c];
      }
    }
  }
}

template <int VEC, int SV, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, VEC == 4 ? 4 : 1)
packed_pull_kernel(const int* __restrict__ in_src, const int* __restrict__ edge_epoch,
                   const int* __restrict__ node_epoch, const unsigned char* __restrict__ is_real,
                   const int* __restrict__ frontier, int* __restrict__ next, int* inv,
                   int* counts, const int* flag_in, int* flag_out,
                   const unsigned* __restrict__ sum_in, unsigned* __restrict__ sum_out,
                   long long n_rows, int k, int W, long long null_row, int gather, int count_all,
                   int tpr, int n_groups) {
  // the previous level lit nothing: the wave has ended (uniform per launch)
  if (flag_in != nullptr && *flag_in == 0) return;
  extern __shared__ int block_counts[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) block_counts[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane & (tpr - 1);         // this lane's word group within its row
  const int slot = lane / tpr;            // this lane's row within a pass
  const int rows_per_pass = 32 / tpr;
  const int n_gb = (n_groups + tpr - 1) / tpr;  // word groups a lane walks (1 unless W/VEC > 32)
  const bool gated = sum_out != nullptr;
  // a pass with no slot to gather can be skipped only in a gated level
  // that counts its fire: elsewhere every row is read or written
  const bool every_row = !gated || !gather || count_all || k > kMaskSlots;
  int local[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) local[c] = 0;
  int lit = 0;

  const long long n_words = (n_rows + 31) >> 5;
  const long long warp_step = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); w < n_words;
       w += warp_step) {
    const long long row0 = w << 5;
    // phase 1: lane l scans row row0 + l
    unsigned m = 0;
    int first[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) first[j] = -1;
    if (gather && row0 + lane < n_rows && row0 + lane != null_row)
      m = scan_row<SV, CHUNKED>(in_src, edge_epoch, node_epoch, sum_in, row0 + lane, n_rows, k,
                                first);
    const unsigned cand = every_row ? kFull : __ballot_sync(kFull, m != 0);
    const int n_cand = __popc(cand);
    unsigned bits = 0;  // the word's summary
    for (int gb = 0; gb < n_gb; ++gb) {
      const int col = (g + gb * tpr) * VEC;
      // the passes take the candidate rows in order, rows_per_pass at a
      // time: rows with nothing to gather cost no pass
      for (int first_cand = 0; first_cand < n_cand; first_cand += rows_per_pass) {
        // (a lane a row, tpr == 1: one pass, each lane its own row)
        const int nth = first_cand + slot;
        const bool in_pass = tpr == 1 ? (cand >> lane) & 1u : nth < n_cand;
        const int rl = tpr == 1 ? lane : in_pass ? nth_set_bit(cand, nth) : 0;
        const long long r = row0 + rl;
        const unsigned mr = __shfl_sync(kFull, m, rl);
        int ids[kMaxK];
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) ids[j] = CHUNKED ? -1 : __shfl_sync(kFull, first[j], rl);
        const bool has = in_pass && r < n_rows && col < W;  // this lane holds words of a row
        const long long off = r * W + col;
        int fire[VEC], before[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c) fire[c] = before[c] = 0;
        if (has) {
          if (gather) {
            const bool live = r != null_row && (mr != 0 || k > kMaskSlots);
            if (live || count_all) load_row<VEC>(inv + off, before);
            if (live)
              gather_row<VEC, CHUNKED>(in_src, edge_epoch, node_epoch, sum_in, frontier, r,
                                       n_rows, k, W, col, mr, ids, fire);
          } else {
            ldg_row<VEC>(frontier + off, fire);  // the seed words
            int raw = 0;
#pragma unroll
            for (int c = 0; c < VEC; ++c) raw |= fire[c];
            if (raw || count_all) load_row<VEC>(inv + off, before);
          }
        }
        int any = 0, after[VEC], counted = 0;
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          fire[c] &= ~before[c];
          any |= fire[c];
          after[c] = before[c] | fire[c];
          counted |= count_all ? after[c] : fire[c];
        }
        if (any) store_row<VEC>(inv + off, after);
        int row_any = any;  // the row fires when any of its lanes does
        for (int o = 1; o < tpr; o <<= 1) row_any |= __shfl_xor_sync(kFull, row_any, o);
        if (has && (!gated || n_gb > 1 || row_any)) store_row<VEC>(next + off, fire);
        bits |= __reduce_or_sync(kFull, row_any != 0 && g == 0 && has ? 1u << rl : 0u);
        if (counted && is_real[r]) {
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            local[c] += __popc((unsigned)(count_all ? after[c] : fire[c]));
        }
        lit |= any;
      }
      if (n_gb > 1) {  // the next word group: flush this one's counts
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          if (local[c]) atomicAdd(&block_counts[col + c], local[c]);
          local[c] = 0;
        }
      }
    }
    if (gated && lane == 0) sum_out[w] = bits;
  }
#pragma unroll
  for (int c = 0; c < VEC; ++c)
    if (local[c]) atomicAdd(&block_counts[g * VEC + c], local[c]);
  if (__syncthreads_or(lit) && threadIdx.x == 0 && flag_out != nullptr) *flag_out = 1;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    if (block_counts[i]) atomicAdd(counts + i, block_counts[i]);
}

using LaunchFn = int (*)(const int*, const int*, const int*, const unsigned char*, const int*,
                         int*, int*, int*, const int*, int*, const unsigned*, unsigned*,
                         long long, int, int, long long, int, int, cudaStream_t);

template <int VEC, int SV, bool CHUNKED>
int launch_level(const int* in_src, const int* edge_epoch, const int* node_epoch,
                 const unsigned char* is_real, const int* frontier, int* next, int* inv,
                 int* counts, const int* flag_in, int* flag_out, const unsigned* sum_in,
                 unsigned* sum_out, long long n_rows, int k, int W, long long null_row,
                 int gather, int count_all, cudaStream_t stream) {
  const int groups = W / VEC;
  int tpr = 1;
  while (tpr < groups && tpr < 32) tpr <<= 1;
  long long blocks = ((n_rows + 31) / 32 + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  packed_pull_kernel<VEC, SV, CHUNKED><<<(unsigned)blocks, kThreads, W * sizeof(int), stream>>>(
      in_src, edge_epoch, node_epoch, is_real, frontier, next, inv, counts, flag_in, flag_out,
      sum_in, sum_out, n_rows, k, W, null_row, gather, count_all, tpr, groups);
  return (int)cudaGetLastError();
}

template <int VEC, int SV>
LaunchFn pick_chunked(bool chunked) {
  return chunked ? launch_level<VEC, SV, true> : launch_level<VEC, SV, false>;
}

template <int VEC>
LaunchFn pick_slots(int slot_vec, bool chunked) {
  return slot_vec == 4   ? pick_chunked<VEC, 4>(chunked)
         : slot_vec == 2 ? pick_chunked<VEC, 2>(chunked)
                         : pick_chunked<VEC, 1>(chunked);
}

}  // namespace

// One level (gather = 1) or the seed step (gather = 0: `frontier` holds the
// seed words). flag_in / flag_out may be null (no early exit / no flag);
// sum_in (levels only) / sum_out may be null (every source may have fired /
// no summary, next written for every row); null_row < 0 is no null row.
// Requires W <= 1024; with vec4, W % 4 == 0 and 16-byte aligned word
// tensors; with slot_vec 4 or 2, k % slot_vec == 0 and in_src / edge_epoch
// aligned to 4 * slot_vec bytes (all checked by the wrapper); any k.
extern "C" int packed_pull_launch(const void* in_src, const void* edge_epoch,
                                  const void* node_epoch, const void* is_real,
                                  const void* frontier, void* next, void* inv, void* counts,
                                  const void* flag_in, void* flag_out, const void* sum_in,
                                  void* sum_out, long long n_rows, int k, int W,
                                  long long null_row, int gather, int count_all, int vec4,
                                  int slot_vec, void* stream) {
  const bool chunked = k > kMaxK;
  LaunchFn f = vec4 ? pick_slots<4>(slot_vec, chunked) : pick_slots<1>(slot_vec, chunked);
  return f((const int*)in_src, (const int*)edge_epoch, (const int*)node_epoch,
           (const unsigned char*)is_real, (const int*)frontier, (int*)next, (int*)inv,
           (int*)counts, (const int*)flag_in, (int*)flag_out, (const unsigned*)sum_in,
           (unsigned*)sum_out, n_rows, k, W, null_row, gather, count_all, (cudaStream_t)stream);
}
