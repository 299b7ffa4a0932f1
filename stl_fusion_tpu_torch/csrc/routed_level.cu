// routed_level: one BFS level of the cluster-routed mesh wave, every shard of
// a one-card mesh in one launch.
//
// The counterpart of the XLA level of stl_fusion_tpu/parallel/routed_wave.py
// (`merge_fire` of `_wave`, :297-310, and the speculative `spec_body`,
// :314-327) and of its seed step (:292-295), which have no Pallas kernel:
// they are hand-written because PyTorch has no scatter-OR into packed words.
//
// Node state is global and bit-packed: row r = d * n_local + local row is
// bit (r & 31) of word (r >> 5); n_local is a multiple of 32, so shard d owns
// words [d * w_local, (d + 1) * w_local). Edges are sharded by destination
// owner: shard d's edges are slots [d * e_cap, d * e_cap + n_edges[d]) of
// the per-edge arrays (eprod, ebslot, ebit, edst, elsrc, eepoch).
//
// For each edge e of shard d (the `level` form):
//   word = the source word, looked up in the exchanged words as `_lookup`
//          does (routed_wave.py:261-280), with the capacities icap and hcap
//          as launch arguments so an in-place bucket resize rewrites no
//          per-edge array:
//            mode 0 (gather, tree): x[ebslot]
//            mode 1 (a2a):          x_d[eprod * icap + ebslot]
//            mode 2 (hier):         eprod < n_dev: x_d[(eprod % dph) * icap + ebslot]
//                                   else cross[((eprod - n_dev) * n_hosts + d / dph) * hcap + ebslot]
//          where x_d = x + d * x_stride (x_stride 0 when every shard reads one vector);
//   fire = bit ebit of word AND edst < n_local (not a pad)
//          AND nepoch[row] == eepoch AND NOT invalid bit of row.
// The `spec` form reads the source bit from the shard's own frontier words
// through elsrc (a local row; the pad n_local never fires).
// A firing edge ORs its row's bit into next; once every edge has fired, the
// launch merges next into invalid (and into acc, the async mode's ever-lit
// accumulator, when given) and counts it. So next holds the rows that fire
// and were valid at the start of the level, invalid |= next, and the count is
// popcount(next), whatever the order of the ORs.
//
// out[0 .. n_dev) receives each shard's newly count and out[n_dev] the total;
// out[n_dev + 1] is the `seed` form's any-seed flag. When `go` is given the
// launch returns at once if *go is 0: the wave has quiesced, so a chain can
// enqueue a fixed budget of levels and read nothing back in between.
//
// The `seed` form is the wave's first step over the words of all shards:
// fresh = seeds & ~invalid, invalid |= seeds, out[d] and out[n_dev] +=
// popcount(fresh), out[n_dev + 1] = 1 if any seed bit is set (a seed already
// invalid conducts and does not count). In a chain it first reads the
// previous stage's state: when that stage was skipped (prev_broken) or had
// not quiesced (*prev_last != 0) it skips itself and marks `broken`.
//
// Bound on the H100: bytes. A level reads the routing of every live edge
// (ebslot and ebit, and eprod outside mode 0: 8-12 B; the spec form elsrc,
// 4 B) and the source words once; for a source in the frontier edst,
// eepoch and the destination's epoch (12 B); the invalid words once; and
// writes each word it lit once in invalid and next (and acc). At 80M nodes
// (240M edges, a2a) the routing alone is 2.9 GB, so the level is a stream
// over the routing with sparse gathers behind it: PR 15's kernel (one edge a
// thread, scalar loads, every shard's blocks at once) took 27 % of that
// bound. The seed step reads the seed words once (19 MB at 80M) and the
// invalid word under each nonzero seed word.
//
// What the design does about it:
// - Warp tiles and 16-byte routing loads. A warp owns a tile of kTile = 128
//   consecutive live slots of one shard, 4 a lane, and reads eprod / ebslot /
//   ebit (spec: elsrc) as int4 loads with the streaming hint (they are read
//   once; L2 stays with nepoch, invalid, next and x); it issues the lane's
//   four source-word gathers before it uses any of them. Tiles start on the
//   16-byte boundary at or below d * e_cap (e_cap need not be a multiple of
//   4): the lanes whose four slots straddle a shard's first or last live slot
//   load those slots one by one.
// - Compacted firing. The slots whose source bit is set are compacted
//   within the warp (a __shfl_up prefix of the lanes' __popc counts into a
//   shared list of tile offsets), so the second phase runs on full lanes,
//   two candidates a lane at a time with their loads issued together: edst
//   and eepoch; the invalid and next words (L2: at 80M a shard's are 2.4 MB
//   each), whose bit set skips the edge; nepoch[row] (a shard's is 77 MB at
//   80M, past L2, so it is tested last); then a fire-and-forget OR into next.
//   No edge waits on a returning atomic: invalid keeps the level's starting
//   state until the merge.
// - A grid balanced over the shards. A persistent grid of the SMs times the
//   blocks an SM holds; the tiles are numbered over every shard's live slots
//   together (each block forms the prefix of the n_dev tile counts from
//   n_edges, so the host reads nothing), and warp w of the grid takes tiles
//   w, w + W, w + 2W, ... (W warps in all). A short shard no longer idles its
//   blocks while the longest one runs, and the grid works through one window
//   of consecutive tiles at a time, so the routing is a few streams and the
//   window's rows and source words (mostly one shard's) stay in L2.
// - One count a block. After a grid-wide barrier (the launch is cooperative:
//   every block is resident) the grid merges next into invalid and acc, a
//   word a thread; each thread counts the bits of the shard its words lie in
//   and adds them to the block's per-shard count in shared memory when it
//   moves on, and the block makes one atomicAdd per shard it touched and one
//   for the total. A launch takes at most kMaxDev shards.
// - The seed step streams the seed words as int4 loads (4 in flight a
//   thread) over one flat range of all shards' words, interleaved over the
//   grid the same way; only a nonzero seed word touches its invalid word.
//   The block reduces its fresh counts per shard and its any-seed flag, then
//   makes one atomic per touched shard, one for the total and one store of
//   the flag.
// - The C entries take one struct of 64-bit arguments (the wrapper packs the
//   per-layout part once per layout) and the stream.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLane = 4;             // slots a lane in a warp tile
constexpr int kTile = 32 * kLane;    // slots a warp tile
constexpr int kMaxDev = 64;          // shards a launch takes (two a lane in the prefix)
constexpr int kBatch = 2;            // candidates a lane takes at a time in the second phase
constexpr int kSeedUnroll = 4;       // int4 seed loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

// Timing diagnostics for perf/ab_routed_level.py (-D on the nvcc line; the
// results are then WRONG): ROUTED_LEVEL_SKIP skips the level's second phase
// (1) or its nepoch test (2).
#ifndef ROUTED_LEVEL_SKIP
#define ROUTED_LEVEL_SKIP 0
#endif

struct Level {
  const unsigned* x;        // exchanged words (level) or the frontier words (spec)
  long long x_stride;       // words between two shards' rows of x
  const unsigned* cross;    // hier: the host tree's words
  const int* eprod;
  const int* ebslot;
  const int* ebit;
  const int* edst;
  const int* elsrc;
  const int* eepoch;
  const int* n_edges;       // int32[n_dev], live edges of each shard
  const int* nepoch;        // int32[n_global]
  unsigned* invalid;        // packed words of all shards
  unsigned* next;           // packed words of all shards, zeroed
  unsigned* acc;            // optional
  unsigned long long* out;  // [n_dev + 2]
  const unsigned long long* go;  // optional
  long long e_cap;
  int n_local;
  int n_dev;
  int mode;
  int icap;
  int hcap;
  int dph;
  int n_hosts;
  int w_local;  // words a shard
};

// A per-edge array's entries, read once a level: the streaming hint (evict
// first) leaves L2 to nepoch, invalid, next and x.
__device__ __forceinline__ int4 ldg4(const int* p) {
  return __ldcs(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ int lde(const int* p) { return __ldcs(p); }

__device__ __forceinline__ void put4(int (&v)[kLane], const int4 a) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Warp 0: first[d] = the tiles of shards < d, first[n_dev] = all tiles, and
// live[d] = n_edges[d]. Shard d's tiles cut its live slots at multiples of
// kTile from the 16-byte boundary at or below d * e_cap.
__device__ __forceinline__ void tile_prefix(const int* n_edges, int e_cap, int n_dev, int* first,
                                            int* live) {
  const int lane = threadIdx.x & 31;
  int t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 2 * lane + h;
    const int n = d < n_dev ? n_edges[d] : 0;
    if (d < n_dev) live[d] = n;
    t[h] = n > 0 ? ((d * e_cap & 3) + n + kTile - 1) / kTile : 0;
  }
  int incl = t[0] + t[1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - t[0] - t[1];
  if (2 * lane < n_dev) first[2 * lane] = excl;
  if (2 * lane + 1 < n_dev) first[2 * lane + 1] = excl + t[0];
  if (lane == 31) first[n_dev] = incl;
}

// The block's per-shard counts (shared) into out: one atomicAdd per shard
// it touched and one for the total. Warp 0, after a __syncthreads.
__device__ __forceinline__ void flush_counts(const unsigned* cnt, int n_dev,
                                             unsigned long long* out) {
  const int lane = threadIdx.x & 31;
  const unsigned long long a = lane < n_dev ? cnt[lane] : 0ull;
  const unsigned long long b = lane + 32 < n_dev ? cnt[lane + 32] : 0ull;
  if (a) atomicAdd(out + lane, a);
  if (b) atomicAdd(out + lane + 32, b);
  const unsigned long long sum = warp_sum(a + b);
  if (lane == 0 && sum) atomicAdd(out + n_dev, sum);
}

// One warp tile's routing as the lane holds it: the tile's first slot and
// shard, which of the lane's four slots are live, and their entries (the
// level form: ebslot in a, ebit in b, eprod in c; the spec form: elsrc in a).
struct Route {
  int base, d;
  unsigned live;
  int a[kLane], b[kLane], c[kLane];
};

// Tile t's routing, its shard found from shard d on: int4 loads where the
// lane's four slots are all live, else one load a live slot.
template <bool kSpec>
__device__ __forceinline__ void load_route(const Level& p, const int* first, const int* n_live,
                                           int t, int d, Route& r) {
  while (t >= first[d + 1]) ++d;
  const int lo = d * (int)p.e_cap, hi = lo + n_live[d];
  r.d = d;
  r.base = (lo & ~3) + (t - first[d]) * kTile;
  const int g = r.base + kLane * (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < kLane; ++k) r.b[k] = r.c[k] = 0;
  if (g >= lo && g + kLane <= hi) {
    r.live = 0xfu;
    if constexpr (kSpec) {
      put4(r.a, ldg4(p.elsrc + g));
    } else {
      put4(r.a, ldg4(p.ebslot + g));
      put4(r.b, ldg4(p.ebit + g));
      if (p.mode != 0) put4(r.c, ldg4(p.eprod + g));
    }
  } else {
    r.live = 0u;
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const bool in = g + k >= lo && g + k < hi;
      r.live |= (unsigned)in << k;
      if constexpr (kSpec) {
        r.a[k] = in ? lde(p.elsrc + g + k) : 0;
      } else {
        r.a[k] = in ? lde(p.ebslot + g + k) : 0;
        r.b[k] = in ? lde(p.ebit + g + k) : 0;
        if (p.mode != 0) r.c[k] = in ? lde(p.eprod + g + k) : 0;
      }
    }
  }
}

// Fires one tile: its source words, the compaction of its candidates into
// the warp's list `pick`, and the second phase.
template <bool kSpec>
__device__ __forceinline__ void fire_tile(const Level& p, const Route& r, unsigned char* pick) {
  const int lane = threadIdx.x & 31;
  const unsigned* xd = p.x + (long long)r.d * p.x_stride;
  // phase 1: the lane's four source words, all in flight before any is used
  unsigned w[kLane], cand = 0;
  if constexpr (kSpec) {
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const bool on = ((r.live >> k) & 1u) && r.a[k] < p.n_local;
      w[k] = on ? __ldg(xd + (r.a[k] >> 5)) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kLane; ++k) cand |= ((w[k] >> (r.a[k] & 31)) & 1u) << k;
  } else {
    const unsigned* hx = p.cross + (long long)(r.d / p.dph) * p.hcap;
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const int slot = r.a[k], prod = r.c[k];
      const unsigned* src;
      if (p.mode == 0) {
        src = xd + slot;
      } else if (p.mode == 1) {
        src = xd + (long long)prod * p.icap + slot;
      } else if (prod < p.n_dev) {
        src = xd + (long long)(prod % p.dph) * p.icap + slot;
      } else {
        src = hx + (long long)(prod - p.n_dev) * p.n_hosts * p.hcap + slot;
      }
      w[k] = ((r.live >> k) & 1u) ? __ldg(src) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kLane; ++k) cand |= ((w[k] >> (r.b[k] & 31)) & 1u) << k;
  }

  // compaction: the tile's candidates as offsets, in lane order
  const int c = __popc(cand);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;
  int pos = incl - c;
#pragma unroll
  for (int k = 0; k < kLane; ++k)
    if ((cand >> k) & 1u) pick[pos++] = (unsigned char)(kLane * lane + k);
  __syncwarp();
#if ROUTED_LEVEL_SKIP == 1
  return;
#endif

  // phase 2 on full lanes, kBatch candidates a lane at a time
  const int row0 = r.d * p.n_local;
  for (int j0 = 0; j0 < total; j0 += 32 * kBatch) {
    bool on[kBatch];
    int dst[kBatch], ep[kBatch], row[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + 32 * u + lane;
      on[u] = j < total;
      const int e = r.base + (on[u] ? pick[j] : 0);
      dst[u] = on[u] ? lde(p.edst + e) : 0;
      ep[u] = on[u] ? lde(p.eepoch + e) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      on[u] = on[u] && (unsigned)dst[u] < (unsigned)p.n_local;  // else padding
      row[u] = row0 + (on[u] ? dst[u] : 0);
      if (on[u]) on[u] = !((__ldcg(p.invalid + (row[u] >> 5)) >> (row[u] & 31)) & 1u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (on[u]) on[u] = ROUTED_LEVEL_SKIP == 2 || __ldg(p.nepoch + row[u]) == ep[u];
    // invalid keeps the level's starting state until the merge, so every
    // edge that fires ORs its row into next, and the merge counts each once
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (on[u]) atomicOr(p.next + (row[u] >> 5), 1u << (row[u] & 31));
  }
  __syncwarp();  // the list is rewritten by the next tile
}

template <bool kSpec>
__global__ void __launch_bounds__(kThreads) routed_level_kernel(const Level p) {
  if (p.go != nullptr && *p.go == 0ull) return;  // quiesced: nothing to do
  __shared__ int s_first[kMaxDev + 1];
  __shared__ int s_live[kMaxDev];
  __shared__ unsigned s_lit[kMaxDev];
  __shared__ unsigned char s_pick[kWarps][kTile];  // a tile's candidates (offsets)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) tile_prefix(p.n_edges, (int)p.e_cap, p.n_dev, s_first, s_live);
  if (threadIdx.x < kMaxDev) s_lit[threadIdx.x] = 0u;
  __syncthreads();

  // warp w of the grid's W takes tiles w, w + W, w + 2W, ...: the grid works
  // through one window of consecutive tiles (and so mostly one shard's rows
  // and source words) at a time, which keeps the routing streams few and the
  // gathers in L2
  const int n_tiles = s_first[p.n_dev], t_step = gridDim.x * kWarps;
  unsigned char* pick = s_pick[warp];
  int d = 0;  // the shard of the warp's tile: tiles only move on to later shards
  for (int t = blockIdx.x * kWarps + warp; t < n_tiles; t += t_step) {
    Route r;
    load_route<kSpec>(p, s_first, s_live, t, d, r);
    d = r.d;
    fire_tile<kSpec>(p, r, pick);
  }

  // every block's ORs into next are done: merge next into invalid (and acc)
  // a word a thread, interleaved over the grid, counting each shard's bits
  cooperative_groups::this_grid().sync();
  const int n_words = p.n_dev * p.w_local;
  int sd = -1;
  unsigned bits = 0;  // this thread's lit bits in shard sd
  for (int w = blockIdx.x * kThreads + threadIdx.x; w < n_words; w += gridDim.x * kThreads) {
    const unsigned nw = __ldcg(p.next + w);
    if (nw == 0u) continue;
    p.invalid[w] = __ldcg(p.invalid + w) | nw;
    if (p.acc != nullptr) p.acc[w] |= nw;
    const int wd = w / p.w_local;
    if (wd != sd) {
      if (bits) atomicAdd(&s_lit[sd], bits);
      sd = wd;
      bits = 0;
    }
    bits += __popc(nw);
  }
  if (bits) atomicAdd(&s_lit[sd], bits);
  __syncthreads();
  if (warp == 0) flush_counts(s_lit, p.n_dev, p.out);
}

struct Seed {
  const unsigned* seeds;
  unsigned* invalid;
  unsigned long long* out;
  const unsigned long long* prev_last;  // chain only
  const int* prev_broken;
  int* broken;
  int n_words;  // n_dev * w_local
  int head;     // words before the seeds' first 16-byte boundary
  int w_local;
  int n_dev;
};

// One seed word i: fresh bits counted in the block's shard count.
__device__ __forceinline__ bool seed_word(const Seed& p, int i, unsigned s, unsigned* cnt) {
  if (s == 0u) return false;
  const unsigned old = p.invalid[i];
  const unsigned fresh = s & ~old;
  if (fresh) {
    p.invalid[i] = old | s;
    atomicAdd(&cnt[i / p.w_local], (unsigned)__popc(fresh));
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) routed_seed_kernel(const Seed p) {
  if (p.prev_last != nullptr && (*p.prev_broken != 0 || *p.prev_last != 0ull)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *p.broken = 1;
    return;
  }
  __shared__ unsigned s_fresh[kMaxDev];
  if (threadIdx.x < kMaxDev) s_fresh[threadIdx.x] = 0u;
  __syncthreads();
  // the words after the head as int4 groups, interleaved over the grid
  const int n4 = (p.n_words - p.head) >> 2, step = gridDim.x * kThreads;
  const uint4* s4 = reinterpret_cast<const uint4*>(p.seeds + p.head);
  bool any = false;
  for (int g0 = blockIdx.x * kThreads + threadIdx.x; g0 < n4; g0 += step * kSeedUnroll) {
    uint4 v[kSeedUnroll];
#pragma unroll
    for (int u = 0; u < kSeedUnroll; ++u) {
      const int g = g0 + u * step;
      v[u] = g < n4 ? __ldcs(s4 + g) : make_uint4(0u, 0u, 0u, 0u);  // read once
    }
#pragma unroll
    for (int u = 0; u < kSeedUnroll; ++u) {
      if ((v[u].x | v[u].y | v[u].z | v[u].w) == 0u) continue;
      const int i = p.head + 4 * (g0 + u * step);
      any |= seed_word(p, i, v[u].x, s_fresh);
      any |= seed_word(p, i + 1, v[u].y, s_fresh);
      any |= seed_word(p, i + 2, v[u].z, s_fresh);
      any |= seed_word(p, i + 3, v[u].w, s_fresh);
    }
  }
  if (blockIdx.x == 0) {  // the head and the tail, one word a thread
    const int tail = p.head + 4 * n4;
    const int k = threadIdx.x < 4 ? (int)threadIdx.x : tail + (int)threadIdx.x - 4;
    if ((threadIdx.x < 4 && k < p.head) || (threadIdx.x >= 4 && k < p.n_words))
      any |= seed_word(p, k, p.seeds[k], s_fresh);
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) p.out[p.n_dev + 1] = 1ull;
  if (threadIdx.x < 32) flush_counts(s_fresh, p.n_dev, p.out);
}

// SMs x the blocks of `kernel` an SM holds; 0 when the card cannot say.
template <typename K>
int full_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
          cudaSuccess)
    return 0;
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// The arguments of routed_level_launch, all 64-bit: the layout's part (the
// wrapper packs it once per layout), then the call's.
struct LevelArgs {
  long long eprod, ebslot, ebit, edst, elsrc, eepoch, n_edges, e_cap, max_edges, n_local, n_dev,
      mode, icap, hcap, dph, n_hosts;
  long long x, x_stride, cross, nepoch, invalid, next, acc, out, go, spec;
};

// The level (spec = 0) or the speculative local level (spec = 1) of every
// shard; max_edges is the longest shard's live edge count (it sizes the grid).
extern "C" int routed_level_launch(const LevelArgs* a, void* stream) {
  static const int full[2] = {full_blocks(routed_level_kernel<false>),
                              full_blocks(routed_level_kernel<true>)};
  const int spec = a->spec ? 1 : 0;
  if (full[spec] == 0) return (int)cudaGetLastError();
  // slots, rows and tiles are 32-bit in the kernel
  if (a->n_dev < 1 || a->n_dev > kMaxDev || a->max_edges < 0 || a->max_edges > a->e_cap ||
      a->mode < 0 || a->mode > 2 || a->dph < 1 || a->n_local < 32 || (a->n_local & 31) ||
      a->n_dev * a->e_cap >= (1ll << 31) || a->n_dev * a->n_local >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((a->eprod | a->ebslot | a->ebit | a->elsrc) & 15) return (int)cudaErrorMisalignedAddress;
  // every tile of the longest shard, for each shard: more blocks would idle
  const long long tiles = a->n_dev * ((a->max_edges + 3 + kTile - 1) / kTile);
  long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > full[spec]) blocks = full[spec];
  if (blocks < 1) blocks = 1;
  const Level p{(const unsigned*)a->x, a->x_stride, (const unsigned*)a->cross,
                (const int*)a->eprod, (const int*)a->ebslot, (const int*)a->ebit,
                (const int*)a->edst, (const int*)a->elsrc, (const int*)a->eepoch,
                (const int*)a->n_edges, (const int*)a->nepoch, (unsigned*)a->invalid,
                (unsigned*)a->next, (unsigned*)a->acc, (unsigned long long*)a->out,
                (const unsigned long long*)a->go, a->e_cap, (int)a->n_local, (int)a->n_dev,
                (int)a->mode, (int)a->icap, (int)a->hcap, (int)a->dph, (int)a->n_hosts,
                (int)(a->n_local >> 5)};
  // cooperative: every block resident at once (blocks <= full) for the
  // grid-wide barrier before the merge
  void* kernel = spec ? (void*)routed_level_kernel<true> : (void*)routed_level_kernel<false>;
  void* params[] = {(void*)&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks),
                                                      dim3(kThreads), params, 0,
                                                      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The arguments of routed_seed_launch, all 64-bit; prev_last, prev_broken
// and broken are all 0 outside a chain.
struct SeedArgs {
  long long seeds, invalid, w_local, n_dev, out, prev_last, prev_broken, broken;
};

// The seed step over every shard's words.
extern "C" int routed_seed_launch(const SeedArgs* a, void* stream) {
  static const int full = full_blocks(routed_seed_kernel);
  if (full == 0) return (int)cudaGetLastError();
  if (a->n_dev < 1 || a->n_dev > kMaxDev || a->w_local < 1 || (a->seeds & 3))
    return (int)cudaErrorInvalidValue;
  const long long n_words = a->n_dev * a->w_local;
  if (n_words >= (1ll << 31)) return (int)cudaErrorInvalidValue;  // 32-bit word indices
  long long head = ((16 - (a->seeds & 15)) & 15) >> 2;
  if (head > n_words) head = n_words;
  const long long n4 = (n_words - head) >> 2;
  long long blocks = (n4 + (long long)kThreads * kSeedUnroll - 1) / ((long long)kThreads * kSeedUnroll);
  if (blocks > full) blocks = full;
  if (blocks < 1) blocks = 1;
  const Seed p{(const unsigned*)a->seeds, (unsigned*)a->invalid, (unsigned long long*)a->out,
               (const unsigned long long*)a->prev_last, (const int*)a->prev_broken,
               (int*)a->broken, (int)n_words, (int)head, (int)a->w_local, (int)a->n_dev};
  routed_seed_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
