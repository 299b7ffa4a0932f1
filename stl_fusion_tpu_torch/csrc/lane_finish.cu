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
// exactly one row: reading a word while other rows' bits are OR'ed into it
// is race-free. Without perm (the identity form: row r is node r, the packed
// mesh burst's map) row r's bit is bit r % 32 of word r / 32.
//
// Bound on the H100: bytes at W = 16 (each row's W words, is_real and perm
// read, each real row's pre-invalid word, the union's words, the mask
// written: ~0.8 GB at 11.3M rows, ~0.25 ms at 3.35 TB/s); the 32*W bit tests
// per row are ~5.8 G operations if done one by one. PyTorch has neither a
// per-bit column popcount (unpacking [rows, W, 32] is 5.8 G elements) nor a
// scatter-OR into packed words, hence the kernel. The design:
// - a warp owns tiles of 32 consecutive rows (tile t: rows 32t .. 32t + 31),
//   tiles strided over the grid's warps; its tiles' words stream into a ring
//   of kStages tiles in shared memory by cp.async, 16 bytes a lane (4 bytes
//   where the rows are not 16-byte aligned or a column chunk is narrow), so
//   kStages - 1 tiles are in flight while one is counted;
// - each lane loads one row's perm entry and is_real byte two tiles ahead
//   and its pre-invalid word one tile ahead: the dependent lookup waits
//   behind a whole tile's work, never in front of the stream;
// - the pre-invalid test is one ballot (bit i: row i of the tile counts);
//   the union test ORs a row's words across the W / 4 lanes that hold them
//   (a shuffle step per doubling) and one more ballot gives the union rows;
// - the union is committed per run of tile rows whose nodes share a dense
//   word (a segmented OR over the warp): one atomicOr a run into the dense
//   words and one into the mask. In the identity form a tile is one dense
//   word: it is read with one load and written with one store each, no
//   atomics, and every mask word is written, so the mask needs no memset;
// - lane counts are bit-sliced: each lane holds 4 word columns (W >= 4; its
//   own row's W words otherwise) and adds each tile's words into kPlanes
//   carry-save bit planes a column (plane i holds bit i of all 32 lanes'
//   counts; a carry-save tree adds a tile's words at once), flushed into
//   per-lane shared counters when they could overflow and at the end; one
//   global atomicAdd per lane per block at the end.
// Any W: a power of two <= 32 (the port's lane bursts pack 32 * 2^j groups,
// W = 16 on the main path) is the one launch above. Any other W splits a
// row's words into column chunks of power-of-two widths <= 32, one launch
// each over all rows, with its lane counters at the chunk's 32 * col0 lanes;
// those launches read the pre-burst dense words and OR each union row's bit
// into the newly mask only, so a later chunk still sees the state before the
// burst. A last launch (lane_finish_kernel_commit) then ORs the newly mask
// into the dense words and counts its bits: perm is injective over real
// rows, so the union's rows are exactly the mask's bits.
//
// LANE_FINISH_SPLIT (a timing diagnostic, 4 by default) builds the kernel up
// to a stage: 1 the row stream alone (the ring, perm and is_real), 2 plus
// the pre-invalid test, 3 plus the union commit, 4 plus the lane planes and
// their flushes (the whole kernel). Builds below 4 give wrong results.
#include <cuda_runtime.h>

#ifndef LANE_FINISH_SPLIT
#define LANE_FINISH_SPLIT 4
#endif

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;  // tiles in a warp's ring
constexpr int kPlanes = 10;  // counts up to 1023 between flushes
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* bits;             // int32 rows, `stride` words apart; this chunk at col0
  const unsigned char* is_real;
  const int* perm;             // nullptr: the identity row map
  int* g_inv;                  // dense invalid words (updated unless chunk)
  int* newly;                  // newly mask words
  int* lane_counts;            // int32[32 * W]: this chunk's lanes at 32 * col0
  int* union_count;            // int32[1] (not written by a chunk)
  long long n_rows, n_words, n_tiles;
  int stride, col0, chunk, first, vec;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile t's rows (their WC words from col0) into `stage`, dense [32][WC]:
// 16-byte pieces when `vec` (WC >= 4, stride and col0 multiples of 4, the
// base 16-byte aligned), else words. Rows past n_rows are not copied (the
// counting masks them).
template <int WC>
__device__ __forceinline__ void issue_tile(const Args& a, long long t, int* stage, int lane) {
  const long long r0 = t * 32;
  const long long left = a.n_rows - r0;
  const int rows = left >= 32 ? 32 : (left > 0 ? (int)left : 0);
  if constexpr (WC >= 4) {
    if (a.vec) {
      constexpr int kPer = WC / 4;  // 16-byte pieces a row
      for (int i = lane; i < rows * kPer; i += 32) {
        const int r = i / kPer, q = i % kPer;
        cp_async16(stage + 4 * i, a.bits + (r0 + r) * a.stride + a.col0 + 4 * q);
      }
      return;
    }
  }
  for (int i = lane; i < rows * WC; i += 32) {
    const int r = i / WC, q = i % WC;
    cp_async4(stage + i, a.bits + (r0 + r) * a.stride + a.col0 + q);
  }
}

// Add M words of weight 1 into the bit planes c (a carry-save tree: each
// full adder takes two words and the plane, leaves the sum in the plane and
// passes one carry word to the next plane). x is consumed.
template <int M>
__device__ __forceinline__ void add_words(unsigned (&c)[kPlanes], unsigned (&x)[M]) {
  int n = M;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    int k = 0;
#pragma unroll
    for (int i = 0; i + 1 < M; i += 2) {
      if (i + 1 < n) {
        const unsigned s = c[p], u = x[i], v = x[i + 1];
        c[p] = s ^ u ^ v;
        x[k++] = (s & u) | (s & v) | (u & v);
      }
    }
    if (n & 1) {
      const unsigned u = x[n - 1];
      x[k++] = c[p] & u;
      c[p] ^= u;
    }
    n = k;
  }
}

// The planes of one column into the block's per-lane counters.
__device__ __forceinline__ void flush_planes(unsigned (&c)[kPlanes], int* lane_sh) {
  for (int b = 0; b < 32; ++b) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) n |= (int)((c[i] >> b) & 1u) << i;
    if (n) atomicAdd(&lane_sh[b], n);
  }
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) c[i] = 0;
}

// WC: the words of a row this launch counts (a power of two <= 32).
template <int WC>
__global__ void __launch_bounds__(kThreads)
lane_finish_kernel(const Args a) {
  constexpr int kCols = WC < 4 ? WC : 4;  // word columns a lane counts
  constexpr int kLoads = WC < 4 ? 1 : WC / 4;  // a lane's reads of a tile
  constexpr int kLanesPerRow = WC < 4 ? 1 : WC / 4;
  constexpr int kRowsPerLoad = 32 / kLanesPerRow;
  extern __shared__ int4 ring_raw[];
  __shared__ int lane_sh[32 * WC];
  __shared__ int block_unions;
  for (int i = threadIdx.x; i < 32 * WC; i += blockDim.x) lane_sh[i] = 0;
  if (threadIdx.x == 0) block_unions = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* ring = reinterpret_cast<int*>(ring_raw) + warp * kStages * 32 * WC;
  const long long tw = (long long)gridDim.x * kWarps;  // the grid's warps: the tile stride
  const long long t0 = (long long)blockIdx.x * kWarps + warp;
  const bool ident = a.perm == nullptr;
  // the first column this lane counts, and its rows in each read
  const int col = WC < 4 ? 0 : (4 * lane) % WC;

  // prologue: tiles t0 .. t0 + (kStages - 2) tw in flight, one group each
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const long long t = t0 + s * tw;
    if (t < a.n_tiles) issue_tile<WC>(a, t, ring + s * 32 * WC, lane);
    cp_async_commit();
  }
  // a tile's row information: perm entry and is_real of row 32t + lane
  auto row_info = [&](long long t, int& p, bool& real) {
    const long long r = t * 32 + lane;
    real = t < a.n_tiles && r < a.n_rows && __ldg(a.is_real + r);
    p = ident ? (int)r : ((t < a.n_tiles && r < a.n_rows) ? __ldg(a.perm + r) : 0);
  };
  // its pre-invalid word: the row's node's word (row map) or the tile's (identity)
  auto pre_word = [&](long long t, int p, bool real) -> unsigned {
    if (ident) return t < a.n_words ? (unsigned)a.g_inv[t] : 0u;
#if LANE_FINISH_SPLIT >= 2
    return real ? (unsigned)a.g_inv[p >> 5] : 0u;
#else
    return 0u;
#endif
  };
  int p_cur, p_nxt;
  bool real_cur, real_nxt;
  row_info(t0, p_cur, real_cur);
  row_info(t0 + tw, p_nxt, real_nxt);
  unsigned pre_cur = pre_word(t0, p_cur, real_cur);

  unsigned c[kCols][kPlanes];
#pragma unroll
  for (int q = 0; q < kCols; ++q)
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) c[q][i] = 0;
  int since_flush = 0, unions = 0;
  unsigned sink = 0;  // the split builds' reads, kept live
  int stage = 0;
  for (long long t = t0; t < a.n_tiles; t += tw) {
    {  // the tile kStages - 1 ahead into the stage read last trip
      const long long ta = t + (kStages - 1) * tw;
      const int s = stage == 0 ? kStages - 1 : stage - 1;
      if (ta < a.n_tiles) issue_tile<WC>(a, ta, ring + s * 32 * WC, lane);
      cp_async_commit();
    }
    // the next tile's pre-invalid word and the one after's row information
    const unsigned pre_nxt = pre_word(t + tw, p_nxt, real_nxt);
    int p_nn;
    bool real_nn;
    row_info(t + 2 * tw, p_nn, real_nn);

    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int* tile = ring + stage * 32 * WC;
#if LANE_FINISH_SPLIT >= 2
    const unsigned pre_bit = ident ? (pre_cur >> lane) & 1u : (pre_cur >> (p_cur & 31)) & 1u;
    const unsigned ok = __ballot_sync(kFull, real_cur && !pre_bit);  // bit i: row i counts
#else
    const unsigned ok = __ballot_sync(kFull, real_cur);
#endif
    unsigned x[kCols][kLoads];
    unsigned any[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int row = WC < 4 ? lane : j * kRowsPerLoad + lane / kLanesPerRow;
      unsigned v[4] = {0u, 0u, 0u, 0u};
      if constexpr (WC >= 4) {
        const int4 w4 = reinterpret_cast<const int4*>(tile)[j * 32 + lane];
        v[0] = (unsigned)w4.x, v[1] = (unsigned)w4.y, v[2] = (unsigned)w4.z,
        v[3] = (unsigned)w4.w;
      } else {
#pragma unroll
        for (int q = 0; q < kCols; ++q) v[q] = (unsigned)tile[lane * WC + q];
      }
      const bool counts = (ok >> row) & 1u;
      any[j] = 0;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        x[q][j] = counts ? v[q] : 0u;
        any[j] |= x[q][j];
      }
    }
#if LANE_FINISH_SPLIT >= 3
    // the union rows: bit i of U is row i's any-word test
    unsigned sel = 0;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int off = 1; off < kLanesPerRow; off <<= 1)
        any[j] |= __shfl_xor_sync(kFull, any[j], off);
      const unsigned b = __ballot_sync(kFull, any[j] != 0);
      if (lane / kRowsPerLoad == j) sel = b;
    }
    const unsigned U =
        __ballot_sync(kFull, (sel >> ((lane % kRowsPerLoad) * kLanesPerRow)) & 1u);
    if (ident) {
      if (lane == 0 && t < a.n_words) {
        if (!a.chunk) {
          if (U) a.g_inv[t] = (int)(pre_cur | U);
          a.newly[t] = (int)U;
        } else {
          a.newly[t] = a.first ? (int)U : (a.newly[t] | (int)U);
        }
      }
    } else if (U) {
      // segmented OR over runs of rows whose nodes share a dense word
      const int w = p_cur >> 5;
      unsigned acc = (U >> lane) & 1u ? 1u << (p_cur & 31) : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_down_sync(kFull, acc, off);
        const int ow = __shfl_down_sync(kFull, w, off);
        if (lane + off < 32 && ow == w) acc |= o;
      }
      const int pw = __shfl_up_sync(kFull, w, 1);
      if ((lane == 0 || pw != w) && acc) {
        atomicOr(a.newly + w, (int)acc);
        if (!a.chunk) atomicOr(a.g_inv + w, (int)acc);
      }
    }
    unions += __popc(U);
#else
#pragma unroll
    for (int j = 0; j < kLoads; ++j) sink ^= any[j];
#endif
#if LANE_FINISH_SPLIT >= 4
    if (since_flush + kLoads > (1 << kPlanes) - 1) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) flush_planes(c[q], lane_sh + 32 * (col + q));
      since_flush = 0;
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) add_words<kLoads>(c[q], x[q]);
    since_flush += kLoads;
#else
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int j = 0; j < kLoads; ++j) sink += x[q][j];
#endif
    __syncwarp();  // every lane has read the stage before it is refilled
    p_cur = p_nxt, real_cur = real_nxt, pre_cur = pre_nxt;
    p_nxt = p_nn, real_nxt = real_nn;
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int q = 0; q < kCols; ++q) flush_planes(c[q], lane_sh + 32 * (col + q));
  if (sink == 0x9e3779b9u && a.n_rows < 0) a.newly[0] = (int)sink;  // never: keeps sink
  if (lane == 0 && unions) atomicAdd(&block_unions, unions);
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * WC; i += blockDim.x)
    if (lane_sh[i]) atomicAdd(a.lane_counts + 32 * a.col0 + i, lane_sh[i]);
  if (threadIdx.x == 0 && block_unions && !a.chunk) atomicAdd(a.union_count, block_unions);
}

// The chunked form's commit: g_inv |= newly, union_count += popcount(newly).
__global__ void __launch_bounds__(512)
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

// The SMs and, per width, the blocks an SM holds at the ring's shared
// memory (asked once; the first launch of a width is made outside CUDA
// graph capture on the port's paths, and a captured one asks nothing new).
int g_sms = 0;
int g_blocks_per_sm[6] = {0, 0, 0, 0, 0, 0};

template <int WC>
int launch_width(const Args& a, cudaStream_t stream) {
  constexpr int kLog = WC == 1 ? 0 : WC == 2 ? 1 : WC == 4 ? 2 : WC == 8 ? 3 : WC == 16 ? 4 : 5;
  const size_t ring = (size_t)kWarps * kStages * 32 * WC * sizeof(int);
  if (g_blocks_per_sm[kLog] == 0) {
    int err = (int)cudaFuncSetAttribute(lane_finish_kernel<WC>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring);
    if (err) return err;
    int n = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lane_finish_kernel<WC>,
                                                             kThreads, ring);
    if (err) return err;
    g_blocks_per_sm[kLog] = n > 0 ? n : 1;
  }
  long long blocks = (a.n_tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)g_sms * g_blocks_per_sm[kLog];
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  lane_finish_kernel<WC><<<(unsigned)blocks, kThreads, ring, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_chunk(Args a, int wc, cudaStream_t stream) {
  switch (wc) {
    case 1: return launch_width<1>(a, stream);
    case 2: return launch_width<2>(a, stream);
    case 4: return launch_width<4>(a, stream);
    case 8: return launch_width<8>(a, stream);
    case 16: return launch_width<16>(a, stream);
    default: return launch_width<32>(a, stream);
  }
}

}  // namespace

// bits int32[n_rows, W] (the swept state), is_real uint8[n_rows], perm
// int32[n_rows] (each row's original id, clipped into the dense words) or
// null for the identity map (then 32 * n_words >= n_rows), g_inv int32
// dense words (updated in place), newly int32 mask words like g_inv, counts
// int32[32 * W + 1]: the lane counts, then the union count. n_words is the
// word count of g_inv and newly. W >= 1 (checked by the wrapper). The entry
// zeroes the counts and, with a row map, the mask (memsets on the stream)
// before its launches; `launched` (host int) receives the CUDA kernel
// launches made: 1 when W is a power of two <= 32, else one per column
// chunk + 1.
extern "C" int lane_finish_launch(const void* bits, const void* is_real, const void* perm,
                                  void* g_inv, void* newly, void* counts, long long n_rows, int W,
                                  long long n_words, void* launched, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* made = (int*)launched;
  *made = 0;
  if (g_sms == 0) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
  }
  int err = (int)cudaMemsetAsync(counts, 0, (size_t)(32 * W + 1) * sizeof(int), s);
  if (!err && perm != nullptr) err = (int)cudaMemsetAsync(newly, 0, (size_t)n_words * 4, s);
  if (err) return err;
  Args a;
  a.bits = (const int*)bits;
  a.is_real = (const unsigned char*)is_real;
  a.perm = (const int*)perm;
  a.g_inv = (int*)g_inv;
  a.newly = (int*)newly;
  a.lane_counts = (int*)counts;
  a.union_count = (int*)counts + 32 * W;
  a.n_rows = n_rows;
  a.n_words = n_words;
  const long long row_tiles = (n_rows + 31) / 32;
  a.n_tiles = perm == nullptr && n_words > row_tiles ? n_words : row_tiles;
  a.stride = W;
  const bool aligned = ((unsigned long long)bits & 15ull) == 0 && W % 4 == 0;
  if (W <= 32 && (W & (W - 1)) == 0) {
    a.col0 = 0, a.chunk = 0, a.first = 1, a.vec = aligned && W >= 4;
    *made = 1;
    return launch_chunk(a, W, s);
  }
  for (int col0 = 0; col0 < W;) {
    int wc = 32;
    while (wc > W - col0) wc >>= 1;
    a.col0 = col0, a.chunk = 1, a.first = col0 == 0, a.vec = aligned && wc >= 4 && col0 % 4 == 0;
    err = launch_chunk(a, wc, s);
    ++*made;
    if (err) return err;
    col0 += wc;
  }
  long long blocks = (n_words + 511) / 512;
  if (blocks > (long long)g_sms * 4) blocks = (long long)g_sms * 4;
  if (blocks < 1) blocks = 1;
  lane_finish_kernel_commit<<<(unsigned)blocks, 512, 0, s>>>(
      (int*)g_inv, (const int*)newly, a.union_count, n_words);
  ++*made;
  return (int)cudaGetLastError();
}
