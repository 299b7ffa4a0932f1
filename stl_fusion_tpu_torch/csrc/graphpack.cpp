// graphpack — the port's host-side graph packer (C++, loaded with ctypes).
//
// The port's own copy of the single-sided ELL packer and the topological
// level pass of the JAX package's native packer (stl_fusion_tpu/native/
// graphpack.cpp: gp_build_ell, gp_fill_out, gp_topo_levels and the counting
// sort they share). Counting sorts make the 10M-node ELL build about a
// second of host time where the numpy layered construction takes ~28 s.
//
// Built at first use with the host compiler (g++ -O3 -shared -fPIC) into the
// git-ignored stl_fusion_tpu_torch/_build/ by ops/_build.py::load_host.
//
// Virtual-id NUMBERING differs from the numpy path in ops/ell_wave.py;
// reachability is the same (the tests compare like with like).
//
// C ABI (ctypes): gp_build_ell / gp_n_tot / gp_fill_out / gp_free,
// gp_topo_levels.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct EdgeList {
  std::vector<int64_t> src;
  std::vector<int64_t> dst;
};

struct Handle {
  int64_t n_tot = 0;
  EdgeList edges;  // final bounded edge list
};

// Group edge indices by key (counting sort). offsets has n_keys+1 entries.
void group_by(const std::vector<int64_t>& key, int64_t n_keys,
              std::vector<int64_t>& order, std::vector<int64_t>& offsets) {
  offsets.assign(static_cast<size_t>(n_keys) + 1, 0);
  for (int64_t k : key) offsets[static_cast<size_t>(k) + 1]++;
  for (int64_t i = 0; i < n_keys; i++) offsets[i + 1] += offsets[i];
  order.resize(key.size());
  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  for (int64_t e = 0; e < static_cast<int64_t>(key.size()); e++)
    order[cursor[key[e]]++] = e;
}

// Bound the degree of one side by layered chunking under fresh virtual ids.
// bound_src=true bounds out-degree (forwarding trees): big source s with
// targets {d_i} emits final (virtual_j -> d_i) chunks and requeues
// (s -> virtual_j). bound_src=false bounds in-degree (collector trees): big
// dest x with sources {s_i} emits final (s_i -> collector_j) chunks and
// requeues (collector_j -> x).
void bound_degree(EdgeList& cur, int64_t& n_tot, int k, bool bound_src,
                  EdgeList& out_final) {
  std::vector<int64_t> order, offsets;
  while (!cur.src.empty()) {
    const std::vector<int64_t>& key = bound_src ? cur.src : cur.dst;
    // snapshot the id space: n_tot grows as chunks mint virtual ids, but
    // this round's groups (and offsets) only cover ids < n_before
    const int64_t n_before = n_tot;
    group_by(key, n_before, order, offsets);
    EdgeList next;
    for (int64_t g = 0; g < n_before; g++) {
      int64_t begin = offsets[g], end = offsets[g + 1];
      int64_t deg = end - begin;
      if (deg == 0) continue;
      if (deg <= k) {
        for (int64_t i = begin; i < end; i++) {
          int64_t e = order[i];
          out_final.src.push_back(cur.src[e]);
          out_final.dst.push_back(cur.dst[e]);
        }
        continue;
      }
      // chunk under virtual ids
      for (int64_t off = begin; off < end; off += k) {
        int64_t v = n_tot++;
        int64_t stop = off + k < end ? off + k : end;
        for (int64_t i = off; i < stop; i++) {
          int64_t e = order[i];
          if (bound_src) {
            out_final.src.push_back(v);          // virtual -> target (≤ k out)
            out_final.dst.push_back(cur.dst[e]);
          } else {
            out_final.src.push_back(cur.src[e]);  // source -> collector (≤ k in)
            out_final.dst.push_back(v);
          }
        }
        if (bound_src) {
          next.src.push_back(g);  // s -> virtual, rebound next round
          next.dst.push_back(v);
        } else {
          next.src.push_back(v);  // collector -> x, rebound next round
          next.dst.push_back(g);
        }
      }
    }
    cur = std::move(next);
  }
}

}  // namespace

extern "C" {

int64_t gp_n_tot(void* handle) { return static_cast<Handle*>(handle)->n_tot; }

void gp_free(void* handle) { delete static_cast<Handle*>(handle); }

// Single-sided ELL: bound one side's degree at k (bound_src_flag != 0 →
// out-degree / forwarding trees, else in-degree / collector trees). The
// counterpart of ops/ell_wave.py::build_ell, whose numpy path costs
// repeated argsort+unique passes (~28 s at 10M nodes vs ~1 s here).
void* gp_build_ell(const int32_t* src, const int32_t* dst, int64_t m,
                   int64_t n_nodes, int k, int32_t bound_src_flag) {
  Handle* h = new Handle();
  h->n_tot = n_nodes;
  EdgeList cur;
  cur.src.assign(src, src + m);
  cur.dst.assign(dst, dst + m);
  bound_degree(cur, h->n_tot, k, bound_src_flag != 0, h->edges);
  return h;
}

// Fill a caller-allocated out-ELL table out_dst[(n_tot+1)*k]: row s holds
// its ≤ k targets, pad slots point at the null row n_tot.
int32_t gp_fill_out(void* handle, int32_t* out_dst, int32_t k) {
  Handle* h = static_cast<Handle*>(handle);
  const int64_t n_tot = h->n_tot;
  const int64_t rows = n_tot + 1;
  const int32_t pad = static_cast<int32_t>(n_tot);
  std::fill(out_dst, out_dst + rows * k, pad);
  std::vector<int32_t> slot(static_cast<size_t>(rows), 0);
  const size_t m = h->edges.src.size();
  for (size_t e = 0; e < m; e++) {
    int64_t s = h->edges.src[e];
    if (slot[s] >= k) return -1;
    out_dst[s * k + slot[s]++] = static_cast<int32_t>(h->edges.dst[e]);
  }
  return 0;
}

// Topological longest-path levels over a packed in-ELL table (Kahn sweep).
//
// in_src: int32[(n+1) * k] — row d's in-neighbors; entries >= n are pads.
// level (out): int32[n] — level[d] = 0 for source rows, else
//              1 + max(level of in-neighbors). Returns 0 on success,
//              -1 if the table contains a cycle (caller falls back).
//
// This feeds the topo-sweep invalidation kernel (ops/topo_wave.py): nodes
// renumbered in level order make the whole 32-wave cascade a single pass
// over the edge table instead of one full-graph gather per BFS level.
int32_t gp_topo_levels(const int32_t* in_src, int64_t n, int32_t k,
                       int32_t* level) {
  // out-adjacency via counting sort: edge (p -> d) per live entry
  std::vector<int64_t> off(static_cast<size_t>(n) + 1, 0);
  std::vector<int32_t> indeg(static_cast<size_t>(n), 0);
  for (int64_t d = 0; d < n; d++) {
    for (int32_t j = 0; j < k; j++) {
      int32_t p = in_src[d * k + j];
      if (p >= 0 && p < n) {
        off[static_cast<size_t>(p) + 1]++;
        indeg[d]++;
      }
    }
  }
  for (int64_t i = 0; i < n; i++) off[i + 1] += off[i];
  std::vector<int32_t> child(static_cast<size_t>(off[n]));
  {
    std::vector<int64_t> cursor(off.begin(), off.end() - 1);
    for (int64_t d = 0; d < n; d++)
      for (int32_t j = 0; j < k; j++) {
        int32_t p = in_src[d * k + j];
        if (p >= 0 && p < n) child[cursor[p]++] = static_cast<int32_t>(d);
      }
  }
  std::vector<int32_t> queue;
  queue.reserve(static_cast<size_t>(n));
  for (int64_t d = 0; d < n; d++) {
    level[d] = 0;
    if (indeg[d] == 0) queue.push_back(static_cast<int32_t>(d));
  }
  size_t head = 0;
  while (head < queue.size()) {
    int32_t u = queue[head++];
    int32_t lu = level[u];
    for (int64_t e = off[u]; e < off[u + 1]; e++) {
      int32_t d = child[e];
      if (level[d] < lu + 1) level[d] = lu + 1;
      if (--indeg[d] == 0) queue.push_back(d);
    }
  }
  return head == static_cast<size_t>(n) ? 0 : -1;
}

}  // extern "C"
