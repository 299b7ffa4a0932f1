// block_refresh: the columnar device refresh of a bound row block.
//
// The counterpart of the XLA program that stl_fusion_tpu/graph/backend.py::
// TpuGraphBackend.refresh_block_on_device jits (its `prog`; no Pallas kernel
// there). A table of n_rows rows is bound to the graph nodes
// [base, base + n_rows); its loader has already computed `fresh`, every row.
// For each row r, with bit = bit (base + r) of the graph's packed invalid words:
//   values[r] = bit ? fresh[r] : values[r]
//   valid[r] |= bit                                  (only when `valid` is given)
// and then every bit in [base, base + n_rows) is cleared; bits outside the
// range are untouched, including those that share the range's end words.
// JAX slices a bool invalid array; the port's invalid state is packed int32
// words, and no single PyTorch operation reads or clears a bit range at an
// unaligned node offset.
//
// Rows are moved as raw bytes in CH-byte chunks (16, 4 or 1: the wrapper
// takes the largest that divides the row's bytes and both pointers'
// alignment), so every dtype and row shape is taken.
//
// Bound on the H100: bytes. The words are read and written once; a stale
// row reads its fresh bytes and writes its value bytes and its valid byte;
// a row that is not stale moves nothing. At 10M float32 rows, most of them
// stale after a lane burst, that is ~90-140 MB, ~0.03-0.04 ms at 3.35 TB/s.
// The design:
// - a block owns kWords whole words (32 * kWords nodes), so the words it
//   reads are cleared by that block alone, after its threads have read them
//   from shared memory: one launch, no race between reading a bit and
//   clearing it; an unaligned base only shortens the first and last block;
// - its rows' bytes are one contiguous range, walked chunk by chunk by
//   consecutive threads (coalesced); a chunk never spans two rows;
// - a row that is not stale reads nothing but its bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 32;  // words a block owns: 1,024 nodes

template <int CH>
struct Chunk;
template <>
struct Chunk<16> { using T = int4; };
template <>
struct Chunk<4> { using T = int; };
template <>
struct Chunk<1> { using T = unsigned char; };

template <int CH>
__global__ void __launch_bounds__(kThreads)
block_refresh_kernel(int* words, const void* __restrict__ fresh, void* values,
                     unsigned char* valid, long long base, long long n_rows,
                     long long row_chunks) {
  using T = typename Chunk<CH>::T;
  __shared__ int sw[kWords];
  const long long end = base + n_rows;
  const long long w_end = (end + 31) >> 5;
  const long long w0 = (base >> 5) + (long long)blockIdx.x * kWords;
  const int t = threadIdx.x;
  if (t < kWords && w0 + t < w_end) sw[t] = words[w0 + t];
  __syncthreads();
  const long long node_lo = base > w0 * 32 ? base : w0 * 32;
  const long long node_hi = end < (w0 + kWords) * 32 ? end : (w0 + kWords) * 32;
  const long long r_lo = node_lo - base, r_hi = node_hi - base;
  const T* src = reinterpret_cast<const T*>(fresh);
  T* dst = reinterpret_cast<T*>(values);
  for (long long c = r_lo * row_chunks + t; c < r_hi * row_chunks; c += kThreads) {
    const long long node = base + (row_chunks == 1 ? c : c / row_chunks);
    if ((sw[(node >> 5) - w0] >> (node & 31)) & 1) dst[c] = src[c];
  }
  if (valid != nullptr) {
    for (long long r = r_lo + t; r < r_hi; r += kThreads) {
      const long long node = base + r;
      if ((sw[(node >> 5) - w0] >> (node & 31)) & 1) valid[r] = 1;
    }
  }
  // the block's own words, cleared over [base, end) only: no other block
  // reads them, and this block's threads read them from shared memory
  if (t < kWords && w0 + t < w_end) {
    const long long w = w0 + t;
    const long long lo = (base > w * 32 ? base : w * 32) - w * 32;
    const long long hi = (end < w * 32 + 32 ? end : w * 32 + 32) - w * 32;
    const unsigned span = hi - lo == 32 ? 0xffffffffu : ((1u << (hi - lo)) - 1u) << lo;
    words[w] = (int)((unsigned)sw[t] & ~span);
  }
}

template <int CH>
int launch(int* words, const void* fresh, void* values, unsigned char* valid, long long base,
           long long n_rows, long long row_chunks, cudaStream_t stream) {
  const long long n_words = ((base + n_rows + 31) >> 5) - (base >> 5);
  const long long blocks = (n_words + kWords - 1) / kWords;
  block_refresh_kernel<CH><<<(unsigned)blocks, kThreads, 0, stream>>>(
      words, fresh, values, valid, base, n_rows, row_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch. words: the graph's packed invalid words (int32, updated in
// place); fresh and values: n_rows rows of row_bytes each (values updated in
// place); valid: uint8[n_rows] (bool) or null to leave validity alone.
// chunk is 16, 4 or 1 and divides row_bytes and both row pointers'
// alignment (checked by the wrapper). n_rows >= 1.
extern "C" int block_refresh_launch(void* words, const void* fresh, void* values, void* valid,
                                    long long base, long long n_rows, long long row_bytes,
                                    int chunk, void* stream) {
  const long long row_chunks = row_bytes / chunk;
  unsigned char* v = (unsigned char*)valid;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk == 16) return launch<16>((int*)words, fresh, values, v, base, n_rows, row_chunks, s);
  if (chunk == 4) return launch<4>((int*)words, fresh, values, v, base, n_rows, row_chunks, s);
  if (chunk == 1) return launch<1>((int*)words, fresh, values, v, base, n_rows, row_chunks, s);
  return (int)cudaErrorInvalidValue;
}
