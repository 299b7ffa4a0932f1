// routed_level: one BFS level of the cluster-routed mesh wave, every shard of
// a one-card mesh in one launch (grid y = shard).
//
// The counterpart of the XLA level of stl_fusion_tpu/parallel/routed_wave.py
// (`merge_fire` of `_wave`, :297-310, and the speculative `spec_body`,
// :315-327), which has no Pallas kernel: it is hand-written because PyTorch
// has no scatter-OR into packed words.
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
// A firing edge does prev = atomicOr(&invalid[row >> 5], bit), and only the
// edge that found the bit clear sets it in next (and in acc, the async
// mode's ever-lit accumulator, when given) and counts one. So next holds the
// rows that fire and were valid at the start of the level, invalid |= next,
// and the count is popcount(next), whatever the order of the atomics.
//
// out[0 .. n_dev) receives each shard's newly count and out[n_dev] the total
// (one atomicAdd of each per warp); out[n_dev + 1] is the `seed` form's
// any-seed flag. When `go` is given the launch returns at once if *go is 0:
// the wave has quiesced, so a chain can enqueue a fixed budget of levels and
// read nothing back in between.
//
// The `seed` form is the wave's first step over the words of all shards
// (grid x over words): fresh = seeds & ~invalid, invalid |= seeds, out[d] and
// out[n_dev] += popcount(fresh), out[n_dev + 1] = 1 if any seed bit is set.
// In a chain it first reads the previous stage's state: when that stage was
// skipped (prev_broken) or had not quiesced (*prev_last != 0) it skips
// itself and marks `broken`.
//
// Bound on the H100: bytes. A level reads the routing of every live edge
// (ebslot and ebit, and eprod outside mode 0: 8-12 B; the spec form elsrc,
// 4 B) and the source words once; for a source in the frontier edst,
// eepoch and the destination's epoch (12 B); the invalid words once; and
// writes each word it lit once in invalid and next (and acc).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

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
};

__device__ __forceinline__ void count_warp(unsigned long long lit, unsigned long long* out,
                                           int y, int n_dev) {
  lit = warp_sum(lit);
  if ((threadIdx.x & 31) == 0 && lit) {
    atomicAdd(out + y, lit);
    atomicAdd(out + n_dev, lit);
  }
}

template <bool kSpec>
__global__ void __launch_bounds__(kThreads) routed_level_kernel(const Level p) {
  if (p.go != nullptr && *p.go == 0ull) return;  // quiesced: nothing to do
  const int y = blockIdx.y;
  const long long n = p.n_edges[y];
  const long long e0 = (long long)y * p.e_cap;
  const unsigned* xd = p.x + (long long)y * p.x_stride;
  const long long row0 = (long long)y * p.n_local;
  unsigned long long lit = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long e = e0 + i;
    bool on;
    if constexpr (kSpec) {
      const int ls = __ldg(p.elsrc + e);
      on = ls < p.n_local && ((__ldg(xd + (ls >> 5)) >> (ls & 31)) & 1u);
    } else {
      const int prod = __ldg(p.eprod + e);
      const int slot = __ldg(p.ebslot + e);
      unsigned w;
      if (p.mode == 0) {
        w = __ldg(xd + slot);
      } else if (p.mode == 1) {
        w = __ldg(xd + (long long)prod * p.icap + slot);
      } else if (prod < p.n_dev) {
        w = __ldg(xd + (long long)(prod % p.dph) * p.icap + slot);
      } else {
        const long long g = y / p.dph;
        w = __ldg(p.cross + ((long long)(prod - p.n_dev) * p.n_hosts + g) * p.hcap + slot);
      }
      on = (w >> (__ldg(p.ebit + e) & 31)) & 1u;
    }
    if (!on) continue;
    const int d = __ldg(p.edst + e);
    if ((unsigned)d >= (unsigned)p.n_local) continue;  // padding
    const long long row = row0 + d;
    const unsigned b = 1u << (row & 31);
    unsigned* inv = p.invalid + (row >> 5);
    if (*inv & b) continue;
    if (__ldg(p.nepoch + row) != __ldg(p.eepoch + e)) continue;
    if (atomicOr(inv, b) & b) continue;  // another edge lit it first
    atomicOr(p.next + (row >> 5), b);
    if (p.acc != nullptr) atomicOr(p.acc + (row >> 5), b);
    ++lit;
  }
  count_warp(lit, p.out, y, p.n_dev);
}

__global__ void __launch_bounds__(kThreads)
routed_seed_kernel(const unsigned* seeds, unsigned* invalid, int w_local, int n_dev,
                   unsigned long long* out, const unsigned long long* prev_last,
                   const int* prev_broken, int* broken) {
  if (prev_last != nullptr && (*prev_broken != 0 || *prev_last != 0ull)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *broken = 1;
    return;
  }
  // one shard a block row (grid y), so a warp's words share one shard
  const int y = blockIdx.y;
  const long long lo = (long long)y * w_local;
  unsigned long long fresh = 0;
  bool any = false;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < w_local;
       i += (long long)gridDim.x * kThreads) {
    const unsigned s = seeds[lo + i];
    if (s == 0u) continue;
    any = true;
    const unsigned old = invalid[lo + i];
    invalid[lo + i] = old | s;
    fresh += __popc(s & ~old);
  }
  if (__any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0) out[n_dev + 1] = 1ull;
  count_warp(fresh, out, y, n_dev);
}

int full_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    blocks = sms * (2048 / kThreads);
  }
  return blocks;
}

}  // namespace

// The level (spec = 0) or the speculative local level (spec = 1) of every
// shard; max_edges is the longest shard's live edge count.
extern "C" int routed_level_launch(const void* x, long long x_stride, const void* cross,
                                   const void* eprod, const void* ebslot, const void* ebit,
                                   const void* edst, const void* elsrc, const void* eepoch,
                                   const void* n_edges, const void* nepoch, void* invalid,
                                   void* next, void* acc, void* out, const void* go,
                                   long long e_cap, long long max_edges, int n_local, int n_dev,
                                   int mode, int icap, int hcap, int dph, int n_hosts, int spec,
                                   void* stream) {
  const int full = full_blocks();
  if (full == 0) return (int)cudaGetLastError();
  if (n_dev < 1 || max_edges < 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  long long need = (max_edges + kThreads - 1) / kThreads;
  long long cap = full / n_dev;
  if (cap < 1) cap = 1;
  if (need > cap) need = cap;
  if (need < 1) need = 1;
  const Level p{(const unsigned*)x, x_stride, (const unsigned*)cross, (const int*)eprod,
                (const int*)ebslot, (const int*)ebit, (const int*)edst, (const int*)elsrc,
                (const int*)eepoch, (const int*)n_edges, (const int*)nepoch, (unsigned*)invalid,
                (unsigned*)next, (unsigned*)acc, (unsigned long long*)out,
                (const unsigned long long*)go, e_cap, n_local, n_dev, mode, icap, hcap, dph,
                n_hosts};
  const dim3 grid((unsigned)need, (unsigned)n_dev);
  if (spec)
    routed_level_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    routed_level_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The seed step over every shard's words. prev_last, prev_broken and broken
// are all null outside a chain.
extern "C" int routed_seed_launch(const void* seeds, void* invalid, int w_local, int n_dev,
                                  void* out, const void* prev_last,
                                  const void* prev_broken, void* broken, void* stream) {
  const int full = full_blocks();
  if (full == 0) return (int)cudaGetLastError();
  if (n_dev < 1 || w_local < 1) return (int)cudaErrorInvalidValue;
  long long need = ((long long)w_local + kThreads - 1) / kThreads;
  long long cap = full / n_dev;
  if (cap < 1) cap = 1;
  if (need > cap) need = cap;
  const dim3 grid((unsigned)need, (unsigned)n_dev);
  routed_seed_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)seeds, (unsigned*)invalid, w_local, n_dev,
      (unsigned long long*)out, (const unsigned long long*)prev_last, (const int*)prev_broken,
      (int*)broken);
  return (int)cudaGetLastError();
}
