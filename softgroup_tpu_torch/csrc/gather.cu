// Row gather (K2) and sorted segment sum (K6, below) for Hopper.
//
// K2: out[i, :] = src[clamp(idx[i], 0, n_src - 1), :].
//
// Replaces softgroup_tpu/ops/gather_kernel.py:_gather_kernel (driven by
// monotone_row_gather / monotone_gather_f32): devoxelize, the grouping entry
// gather and the cell-label gather.  The TPU kernel needed non-decreasing
// indices (it DMAs one source window per block and selects rows with a
// one-hot matmul, exact only through a bf16x3 split for f32); here any index
// order works and the copy is exact for every dtype, since rows move as raw
// bytes.
//
// Bound on the H100: bytes only (one read of the indices and gathered rows,
// one write of the output).  Three routes, by row bytes and alignment:
//   * narrow: rows of 1, 2, 4 or 8 bytes (the int32 cell labels, the top_c
//     gather).  The sources are small (64 KB of cell labels) and stay in
//     L2, so a gather costs its launch and each thread's instructions: a
//     thread writes the 16 bytes of 16 / row_bytes consecutive output rows,
//     reading their indices with 16-byte loads, the rows with read-only
//     loads from the cached table, and storing one 16-byte vector; the
//     ragged tail and unaligned indices take a scalar loop;
//   * 16-byte: rows a multiple of 16 bytes on an aligned source
//     (devoxelize's 64-byte rows, the (P, 4) f32 entries): one thread per
//     16-byte vector of an output row, neighbouring threads on neighbouring
//     vectors, so a 64-byte row is one transaction; the row of a thread is
//     a shift of its index where the vectors a row are a power of two;
//   * word: every other row (12-byte ball candidates, 72- and 92-byte ++
//     heads, 76- and 140-byte proposal entries, 18- to 38-byte bf16 mask
//     scores, any row on a source view off alignment).  These gathers are
//     large (up to 510 MB out) and bound by the output's writes and the
//     index's reads.  A first design, one thread a 4-byte word that
//     reloaded its row's index, divided by the words a row and stored 4
//     bytes, lost to index_select.  Here a block owns a tile of 8 or 16
//     KB of output (word_tile: rows of any width, the first and last ones
//     maybe in part).  It reads the indices of the tile's rows once,
//     coalesced and clamped, into shared memory.  Its threads then load
//     the tile's words, each a W-byte word (W = 8, 4, 2 or 1: the widest
//     that divides the row bytes and the source's alignment), 8 to 32
//     words a thread, all in flight before the first is stored to a
//     shared-memory image of the tile.  A word's row is a multiply-high by
//     a reciprocal computed once a launch, with one correction step: exact
//     for every 32-bit word position.  The image goes out as coalesced
//     16-byte stores (the output is 16-byte aligned, as torch.empty gives
//     it, and a tile starts on a multiple of its size), the last tile's
//     ragged end in W-byte words.  Likely what is left of the bound (not
//     measured: the card's sandbox runs no ncu): the source's reads, where
//     a 12-byte row costs a whole 32-byte L2 sector, two where it
//     straddles one.
// All index math is 32-bit where it can be (the launcher refuses an output
// of 2^31 bytes or more), and the indices are read as int32 or int64 as
// given, so the caller casts nothing.  Clamping matches the reference's
// gather semantics and keeps every read in bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "staging.cuh"

namespace {

template <typename I>
__device__ __forceinline__ long long clamp_row(I j, int n_src) {
  return j < 0 ? 0 : (j >= (I)n_src ? n_src - 1 : (long long)j);
}

// one thread per 16-byte vector of an output row
template <typename I, bool POW2>
__global__ void row_gather_vec(const uint4* __restrict__ src,
                               const I* __restrict__ idx, int n_src,
                               int total, int vec_per_row, int shift,
                               uint4* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int i = POW2 ? t >> shift : t / vec_per_row;
  const int c = t - i * vec_per_row;
  out[t] = __ldg(src + clamp_row(__ldg(idx + i), n_src) * vec_per_row + c);
}

// rows of sizeof(E) < 16 bytes: a thread writes R = 16 / sizeof(E)
// consecutive output rows as one 16-byte store
template <typename E, typename I>
__global__ void row_gather_narrow(const E* __restrict__ src,
                                  const I* __restrict__ idx, int n_src,
                                  int n_out, bool idx_vec,
                                  E* __restrict__ out) {
  constexpr int R = 16 / sizeof(E);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (n_out + R - 1) / R) return;
  const int i0 = t * R;
  if (i0 + R <= n_out) {
    constexpr int IB = R * sizeof(I);  // bytes of indices: 8 .. 128
    __align__(16) I ix[R];
    if (idx_vec && IB % 16 == 0) {
#pragma unroll
      for (int q = 0; q < IB / 16; ++q)
        reinterpret_cast<uint4*>(ix)[q] =
            __ldg(reinterpret_cast<const uint4*>(idx + i0) + q);
    } else if (idx_vec) {  // IB == 8
      reinterpret_cast<uint2*>(ix)[0] =
          __ldg(reinterpret_cast<const uint2*>(idx + i0));
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) ix[r] = __ldg(idx + i0 + r);
    }
    __align__(16) E v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __ldg(src + clamp_row(ix[r], n_src));
    *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(v);
  } else {
    for (int i = i0; i < n_out; ++i)
      out[i] = __ldg(src + clamp_row(__ldg(idx + i), n_src));
  }
}

constexpr int GATHER_NT = 256;

// the word route: threads a block, and output bytes a block for W-byte
// words (a multiple of 16 and of 256 W): 16 KB of 4- or 8-byte words, 8 KB
// of 2- or 1-byte words (timed on the H100: 16 KB tiles are faster than 8
// KB for 4-byte words and slower for 2-byte ones, 32 a thread)
constexpr int WORD_NT = 256;
__host__ __device__ constexpr int word_tile(int w) {
  return w >= 4 ? 16384 : 8192;
}

// floor(p / d) for any 32-bit p and d >= 2, with m = floor(2^32 / d): the
// multiply-high is q or q - 1, and one step corrects it
__device__ __forceinline__ unsigned div_rcp(unsigned p, unsigned d,
                                            unsigned m) {
  unsigned q = __umulhi(p, m);
  if (p - q * d >= d) ++q;
  return q;
}

// block b writes output bytes [b * TILE, ...) (TILE = word_tile(W)):
// W-byte words, wpr of them a row (wpr >= 2 on this route), m = floor(2^32
// / wpr).  Shared memory: the tile's image (TILE bytes), then the clamped
// source row of each output row the tile touches (TILE / W / wpr + 2 at
// most)
template <typename W, typename I>
__global__ void __launch_bounds__(WORD_NT)
row_gather_words(const W* __restrict__ src, const I* __restrict__ idx,
                 int n_src, unsigned total_words, unsigned wpr, unsigned m,
                 uint4* __restrict__ out) {
  constexpr int TILE = word_tile(sizeof(W));
  constexpr int TW = TILE / sizeof(W);        // words a tile
  constexpr int U = TW / WORD_NT;             // words a thread
  extern __shared__ __align__(16) char smem[];
  W* image = reinterpret_cast<W*>(smem);
  int* rows = reinterpret_cast<int*>(smem + TILE);
  const int t = threadIdx.x;
  const unsigned w0 = blockIdx.x * (unsigned)TW;   // the tile's first word
  const int nw = (int)min((unsigned)TW, total_words - w0);
  const unsigned r0 = div_rcp(w0, wpr, m);         // its first row
  const unsigned c0 = w0 - r0 * wpr;               // and word in that row
  const int n_rows = (int)div_rcp(c0 + nw - 1, wpr, m) + 1;
  for (int r = t; r < n_rows; r += WORD_NT)
    rows[r] = (int)clamp_row(__ldg(idx + r0 + r), n_src);
  __syncthreads();
  W v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int w = t + u * WORD_NT;
    if (w < nw) {
      const unsigned p = c0 + w;
      const unsigned q = div_rcp(p, wpr, m);
      v[u] = __ldg(src + (long long)rows[q] * wpr + (p - q * wpr));
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int w = t + u * WORD_NT;
    if (w < nw) image[w] = v[u];
  }
  __syncthreads();
  const int bytes = nw * (int)sizeof(W);
  uint4* o = out + (size_t)blockIdx.x * (TILE / 16);
  const uint4* img = reinterpret_cast<const uint4*>(smem);
  for (int j = t; j < bytes / 16; j += WORD_NT) o[j] = img[j];
  // the last tile's bytes past its last 16-byte word, in W-byte words
  const int done = bytes / 16 * 16 / (int)sizeof(W);
  if (t < nw - done)
    reinterpret_cast<W*>(o + bytes / 16)[t] = image[done + t];
}

template <typename I>
int launch_vec(const void* src, const I* idx, int n_src, int n_out,
               long long row_bytes, void* out, cudaStream_t stream) {
  const long long vpr = row_bytes / 16;
  const long long total = (long long)n_out * vpr;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + GATHER_NT - 1) / GATHER_NT);
  if ((vpr & (vpr - 1)) == 0) {
    int shift = 0;
    while ((1LL << shift) < vpr) ++shift;
    row_gather_vec<I, true><<<blocks, GATHER_NT, 0, stream>>>(
        (const uint4*)src, idx, n_src, (int)total, (int)vpr, shift,
        (uint4*)out);
  } else {
    row_gather_vec<I, false><<<blocks, GATHER_NT, 0, stream>>>(
        (const uint4*)src, idx, n_src, (int)total, (int)vpr, 0,
        (uint4*)out);
  }
  return (int)cudaGetLastError();
}

template <typename W, typename I>
int launch_words(const void* src, const I* idx, int n_src, int n_out,
                 long long row_bytes, void* out, cudaStream_t stream) {
  const long long wpr = row_bytes / (long long)sizeof(W);
  const long long total = (long long)n_out * wpr;
  if ((long long)n_out * row_bytes > INT_MAX || wpr < 2 || wpr > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const unsigned m = (unsigned)((1ULL << 32) / (unsigned long long)wpr);
  constexpr int TILE = word_tile(sizeof(W));
  constexpr long long TW = TILE / sizeof(W);
  const unsigned blocks = (unsigned)((total + TW - 1) / TW);
  const int smem = TILE + 4 * (int)(TW / wpr + 2);
  row_gather_words<W, I><<<blocks, WORD_NT, smem, stream>>>(
      (const W*)src, idx, n_src, (unsigned)total, (unsigned)wpr, m,
      (uint4*)out);
  return (int)cudaGetLastError();
}

template <typename E, typename I>
int launch_narrow(const void* src, const I* idx, int n_src, int n_out,
                  void* out, cudaStream_t stream) {
  constexpr int R = 16 / sizeof(E);
  const long long threads = ((long long)n_out + R - 1) / R;
  const unsigned blocks = (unsigned)((threads + GATHER_NT - 1) / GATHER_NT);
  const int ib = R * (int)sizeof(I);
  const bool idx_vec = (uintptr_t)idx % (ib < 16 ? ib : 16) == 0;
  row_gather_narrow<E, I><<<blocks, GATHER_NT, 0, stream>>>(
      (const E*)src, idx, n_src, n_out, idx_vec, (E*)out);
  return (int)cudaGetLastError();
}

template <typename I>
int row_gather(const void* src, const I* idx, int n_src, int n_out,
               long long row_bytes, void* out, cudaStream_t s) {
  const uintptr_t as = (uintptr_t)src;
  if (row_bytes < 16 && as % row_bytes == 0) {
    switch (row_bytes) {
      case 1: return launch_narrow<uint8_t, I>(src, idx, n_src, n_out, out, s);
      case 2: return launch_narrow<uint16_t, I>(src, idx, n_src, n_out, out, s);
      case 4: return launch_narrow<uint32_t, I>(src, idx, n_src, n_out, out, s);
      case 8: return launch_narrow<uint2, I>(src, idx, n_src, n_out, out, s);
      default: break;
    }
  }
  if (row_bytes % 16 == 0 && as % 16 == 0)
    return launch_vec<I>(src, idx, n_src, n_out, row_bytes, out, s);
  // the word route: the widest word that divides the row and the source's
  // alignment
  const uintptr_t g = as | (uintptr_t)row_bytes;
  if (g % 8 == 0)
    return launch_words<uint2, I>(src, idx, n_src, n_out, row_bytes, out, s);
  if (g % 4 == 0)
    return launch_words<uint32_t, I>(src, idx, n_src, n_out, row_bytes, out,
                                     s);
  if (g % 2 == 0)
    return launch_words<uint16_t, I>(src, idx, n_src, n_out, row_bytes, out,
                                     s);
  return launch_words<uint8_t, I>(src, idx, n_src, n_out, row_bytes, out, s);
}

// ---------------------------------------------------------------------------
// K6: sorted segment sum (sg_segment_sum)
//
//   out[s, :] = sum of values[i, :] over the rows i with seg[i] == s,
//               seg non-decreasing; rows with seg outside [0, S) dropped;
//               summed in f32, rounded once to out's type (f32 or the
//               values')
//
// Replaces softgroup_tpu/ops/gather_kernel.py:_segsum_kernel (driven by
// monotone_segment_sum): the backward of a row gather (devoxelize, the
// proposal-entry gather, the mask gather).  The TPU kernel DMAs a window of
// rows per block of 256 segments and sums them with a one-hot matmul, with
// an XLA fallback when a block's rows overflow the window and a bf16x3
// split for f32.
//
// Bound on the H100: bytes (one read of values and seg, one write of out).
// Three things kept the first design far from it: a run of a chunk was
// summed by c threads only (one per column, every row in turn), so a chunk
// inside a long run (the mask gather's ~4e5 padded entries all land on one
// row) kept 19-35 of 256 threads busy; every load was one 2- or 4-byte
// element; and ``out`` was zeroed by a memset before the kernel wrote it.
// Here:
//   * a block owns a chunk of R consecutive rows (the wrapper picks R).  The
//     chunk's values are one contiguous span of R * c * elt bytes whatever
//     c is: the block copies it to shared memory with 16-byte cp.async (a
//     scalar head and tail where the span is not 16-byte aligned), and its
//     segs with the two neighbouring ones beside;
//   * a thread takes V columns of a row: 16 bytes (8 bf16, 4 f32) where the
//     width and pointers allow (c = 32), else one column (c = 19, 35: V
//     columns read and stored element by element at a stride of V would
//     leave a warp's stores uncoalesced; V = 7 for c = 35 ran 2.5x slower).
//     The chunk is cut into P = 256 / (c / V) strips of rows, and thread
//     (strip, columns) sums its strip in f32 in row order, whatever the
//     runs are, so every thread but 256 % (c / V) works, and the row test
//     and the store of a finished run are paid once per V columns.  A run inside a strip goes straight to ``out``; the piece of
//     a run that crosses the strip's first or last row goes to shared
//     memory, and one thread a column then joins the pieces strip by strip,
//     in order;
//   * a run that crosses the chunk's first row is written to a first-partial
//     slot, one that crosses its last row to a last-partial slot; a second
//     kernel finishes each segment that spans chunks in the block of the
//     chunk where it ends: its 256 threads read the partials of the chunks
//     between with coalesced loads (256 / c chunks a pass) and join them in
//     a fixed order, so a 1600-chunk run is not one thread's serial loop,
//     and finds the segment's first row by one warp's search;
//   * every row of ``out`` is written once, from the kernels: the first
//     blocks of the second kernel own 256-2048 output rows each (about
//     1024 blocks), find the rows
//     of seg that fall on them (two lower bounds, 32 probes a round by one
//     warp), mark the segments present and write zeros to the rest, 16
//     bytes a thread where they can, so the caller allocates ``out``
//     without zeroing it (the devoxelize backward zeroed 109 MB first).  They sit in the second kernel, whose blocks
//     need little shared memory, so they do not cut the chunk blocks'
//     occupancy nor take a chunk block's shared memory each;
// No window, no fallback, no atomics: two calls are bitwise equal.  A
// segment inside one strip is summed in index order, as a sequential CPU
// index_add_; a longer one strip by strip.
constexpr int SEG_NT = 256;     // threads per block
constexpr int SEG_ZQ = 2048;    // output rows per zero-fill block at most
constexpr int SEG_ZBLOCKS = 1024;  // zero-fill blocks to aim for
constexpr int SEG_MARK = 8192;  // a zero-fill block whose rows of seg are at
                                // most this many marks the present segments
                                // in one pass over them; more (a long run)
                                // and each output row is searched for

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements: with VEC, one 16-byte load or store each (the
// addresses are 16-byte aligned), else element by element
template <int V, bool VEC, typename T>
__device__ __forceinline__ void add_vec(float (&acc)[V], const T* p) {
  if constexpr (VEC) {
    __align__(16) T x[V];
    *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] += to_f32(x[u]);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] += to_f32(p[u]);
  }
}
// (out is f32 or the values' type: V columns are 16 or 32 bytes of out)
template <int V, bool VEC, typename O>
__device__ __forceinline__ void store_vec(O* p, const float (&acc)[V]) {
  if constexpr (VEC) {
    static_assert((V * sizeof(O)) % 16 == 0, "V columns: 16-byte words");
    __align__(16) O x[V];
#pragma unroll
    for (int u = 0; u < V; ++u) store_out(x + u, acc[u]);
#pragma unroll
    for (int q = 0; q < (int)(V * sizeof(O) / 16); ++q)
      reinterpret_cast<uint4*>(p)[q] = reinterpret_cast<const uint4*>(x)[q];
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) store_out(p + u, acc[u]);
  }
}

// a zero-fill block: writes zeros to the rows of out [z * zq, (z + 1) * zq)
// that no row of seg falls on (a flag a row in smem: 16 + SEG_ZQ bytes,
// zq <= SEG_ZQ).  Its output rows are one span of bytes: a thread writes
// 16 zero bytes where a 16-byte word of it lies in empty rows only, and
// element by element where a word meets a present row, so the stores stay
// coalesced whatever c is
template <typename O>
__device__ void zero_empty_rows(const int* __restrict__ seg, long long n,
                                int n_seg, int c, int zq, long long z,
                                O* __restrict__ out, char* smem) {
  long long* s_win = reinterpret_cast<long long*>(smem);
  unsigned char* present = reinterpret_cast<unsigned char*>(smem + 16);
  const long long a = z * zq;
  const int nr = (int)min((long long)zq, (long long)n_seg - a);
  const int t = threadIdx.x, warp = t / 32;
  for (int r = t; r < nr; r += SEG_NT) present[r] = 0;
  if (warp < 2) {
    const long long p = warp_lower_bound(seg, 0, n, a + (warp ? nr : 0));
    if ((t & 31) == 0) s_win[warp] = p;
  }
  __syncthreads();
  const long long lo = s_win[0], hi = s_win[1];
  if (hi - lo <= SEG_MARK) {
    for (long long i = lo + t; i < hi; i += SEG_NT) {
      const long long k = (long long)seg[i] - a;
      if (k >= 0 && k < nr) present[k] = 1;
    }
  } else {
    for (int r = t; r < nr; r += SEG_NT) {
      const int q = (int)(a + r);
      long long l = lo, h = hi;
      while (l < h) {
        const long long mid = (l + h) >> 1;
        if (seg[mid] < q) l = mid + 1; else h = mid;
      }
      present[r] = l < hi && seg[l] == q;
    }
  }
  __syncthreads();
  constexpr int EPW = 16 / sizeof(O);   // elements a 16-byte word
  O* base = out + a * c;
  const int n_e = nr * c;               // < 2^31: zq * c elements
  // elements before the first 16-byte aligned one, then whole words, then
  // the elements after the last word
  const int head =
      min(n_e, (int)((16 - (uintptr_t)base % 16) % 16 / sizeof(O)));
  const int words = (n_e - head) / EPW;
  const int tail0 = head + words * EPW;
  for (int e = t; e < head; e += SEG_NT)
    if (!present[e / c]) store_out(base + e, 0.f);
  for (int e = tail0 + t; e < n_e; e += SEG_NT)
    if (!present[e / c]) store_out(base + e, 0.f);
  for (int w = t; w < words; w += SEG_NT) {
    const int e0 = head + w * EPW;
    const int r0 = e0 / c, r1 = (e0 + EPW - 1) / c;
    bool all_empty = true, any_empty = false;
    for (int r = r0; r <= r1; ++r) {
      all_empty = all_empty && !present[r];
      any_empty = any_empty || !present[r];
    }
    if (all_empty) {
      *reinterpret_cast<uint4*>(base + e0) = make_uint4(0, 0, 0, 0);
    } else if (any_empty) {
#pragma unroll
      for (int u = 0; u < EPW; ++u)
        if (!present[(e0 + u) / c]) store_out(base + e0 + u, 0.f);
    }
  }
}

// Shared memory of a chunk block: the values (R * c * elt + 16 bytes,
// rounded to 16), the segs (R + 2 ints, rounded to 16), the strip pieces
// (head and tail: a strip's V columns a thread, max(256 * V, c) floats
// each).
__host__ __device__ __forceinline__ int seg_segs_at(int r, int c, int elt) {
  return (r * c * elt + 16 + 15) & ~15;
}
__host__ __device__ __forceinline__ int seg_pieces(int c, int v) {
  return c > SEG_NT * v ? c : SEG_NT * v;
}
__host__ __device__ __forceinline__ int seg_smem_bytes(int r, int c,
                                                       int elt, int v) {
  return seg_segs_at(r, c, elt) + (((r + 2) * 4 + 15) & ~15)
         + 2 * seg_pieces(c, v) * 4;
}

// block k sums chunk k.  T: values, O: out; V columns a thread (16-byte
// copies with VEC)
template <typename T, typename O, int V, bool VEC>
__global__ void __launch_bounds__(SEG_NT)
segment_sum_chunks(const T* __restrict__ values, const int* __restrict__ seg,
                   long long n, int n_seg, int c, int R,
                   O* __restrict__ out, float* __restrict__ first_part,
                   float* __restrict__ last_part) {
  extern __shared__ __align__(16) char smem[];
  using E = typename std::conditional<sizeof(T) == 2, uint16_t,
                                      uint32_t>::type;
  const long long chunk = blockIdx.x;
  const long long r0 = chunk * R;
  const int rows = (int)min((long long)R, n - r0);
  const int t = threadIdx.x;
  // s_seg[1 + i] = seg[r0 + i]; s_seg[0] and s_seg[rows + 1] the rows
  // before and after the chunk, where they exist
  int* s_seg = reinterpret_cast<int*>(smem + seg_segs_at(R, c, sizeof(T)));
  float* head = reinterpret_cast<float*>(
      smem + seg_segs_at(R, c, sizeof(T)) + (((R + 2) * 4 + 15) & ~15));
  float* tail = head + seg_pieces(c, V);
  const int shift = stage_async<E>(
      smem, reinterpret_cast<const char*>(values + r0 * c),
      (long long)rows * c * sizeof(T));
  for (int i = t; i < rows + 2; i += SEG_NT) {
    const long long g = r0 - 1 + i;
    if (g >= 0 && g < n) s_seg[i] = seg[g];
  }
  cp_async_wait_all();
  __syncthreads();
  const T* v = reinterpret_cast<const T*>(smem + shift);
  const bool has_prev = r0 > 0, has_next = r0 + rows < n;
  // does the run of chunk row i - 1 go on at row i (i in [0, rows])?
  auto joined = [&](int i) {
    return (i > 0 || has_prev) && (i < rows || has_next) &&
           s_seg[i] == s_seg[i + 1];
  };
  // thread (strip, V columns): c / V threads a row, 256 / (c / V) strips
  // (for c / V > 256 one strip, each thread every 256 * V-th column)
  const int nv = c / V;
  const int groups = nv <= SEG_NT ? SEG_NT / nv : 1;
  const int strip = nv <= SEG_NT ? t / nv : 0;
  const int col0 = (nv <= SEG_NT ? t - strip * nv : t) * V;
  const int col_step = nv <= SEG_NT ? c : SEG_NT * V;
  const int rps = (rows + min(groups, rows) - 1) / min(groups, rows);
  const int n_strips = (rows + rps - 1) / rps;
  if (strip < n_strips) {
    const int a = strip * rps, b = min(a + rps, rows);
    const bool open_l = joined(a), open_r = joined(b);
    for (int col = col0; col < c; col += col_step) {
      float acc[V];
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = 0.f;
      int start = a;
      for (int i = a; i <= b; ++i) {
        if (i == b || (i > a && s_seg[i + 1] != s_seg[i])) {
          // the piece [start, i) of one run ends
          const bool ol = start == a && open_l, orr = i == b && open_r;
          if (ol || orr) {
            float* piece = (ol ? head : tail) + strip * c + col;
#pragma unroll
            for (int u = 0; u < V; ++u) piece[u] = acc[u];
          } else if (s_seg[start + 1] >= 0 && s_seg[start + 1] < n_seg) {
            store_vec<V, VEC>(out + (long long)s_seg[start + 1] * c + col,
                              acc);
          }
          if (i == b) break;
#pragma unroll
          for (int u = 0; u < V; ++u) acc[u] = 0.f;
          start = i;
        }
        add_vec<V, VEC>(acc, v + i * c + col);
      }
    }
  }
  __syncthreads();
  // join the pieces of the runs that cross strips, strip by strip
  for (int col = t; col < c; col += SEG_NT) {
    float carry = 0.f;
    bool from_start = false;   // the open run began before the chunk
    auto finish = [&](float acc, int s, bool to_end) {
      if (s < 0 || s >= n_seg) return;
      if (from_start)
        first_part[chunk * c + col] = acc;
      else if (to_end)
        last_part[chunk * c + col] = acc;
      else
        store_out(out + (long long)s * c + col, acc);
    };
    for (int j = 0; j < n_strips; ++j) {
      const int a = j * rps, b = min(a + rps, rows);
      const bool ol = joined(a), orr = joined(b);
      if (ol) {
        const float h = head[j * c + col];
        carry = j == 0 ? h : carry + h;
        from_start = from_start || j == 0;
        if (orr && s_seg[a + 1] == s_seg[b]) continue;   // one open run
        finish(carry, s_seg[a + 1], false);
        from_start = false;
      }
      if (orr) carry = tail[j * c + col];
    }
    if (joined(rows)) finish(carry, s_seg[rows], true);
  }
}

// a segment that spans chunks c_lo..c_hi: P_last[c_lo] + P_first[c_lo + 1]
// + ... + P_first[c_hi], summed in the block of c_hi: one warp finds the
// segment's first row; group g of the 256 / c thread groups adds the
// chunks c_lo + 1 + g, + 256 / c, ... in order, SPAN_ILP partials of a
// column in flight (the groups read neighbouring partials); then one thread
// a column adds P_last[c_lo] and the groups' sums in group order
constexpr int SPAN_ILP = 8;

// blocks [0, n_zero) of the second kernel zero-fill one range of out each
// (small shared memory: apart from the chunk blocks, which hold a chunk);
// block n_zero + k - 1 finishes the span that ends in chunk k, if one does
template <typename O>
__global__ void __launch_bounds__(SEG_NT)
segment_sum_spans(const int* __restrict__ seg, long long n, int n_seg, int c,
                  int R, int zq, long long n_zero,
                  const float* __restrict__ first_part,
                  const float* __restrict__ last_part, O* __restrict__ out) {
  __shared__ __align__(16) char zsmem[16 + SEG_ZQ];
  __shared__ float red[SEG_NT];
  __shared__ long long s_lo;
  if ((long long)blockIdx.x < n_zero) {
    zero_empty_rows<O>(seg, n, n_seg, c, zq, blockIdx.x, out, zsmem);
    return;
  }
  const long long ch = blockIdx.x - n_zero + 1;  // chunk 0 starts no span
  const long long r0 = ch * R;
  if (r0 >= n) return;
  const int s = seg[r0];
  if (s < 0 || s >= n_seg || seg[r0 - 1] != s) return;
  const long long r_end = min(r0 + R, n);
  if (r_end < n && seg[r_end] == s) return;  // continues: not its end
  const int t = threadIdx.x;
  if (t < 32) {   // the segment's first row
    const long long lo = warp_lower_bound(seg, 0, r0, s);
    if (t == 0) s_lo = lo;
  }
  __syncthreads();
  const long long c_lo = s_lo / R;
  if (c > SEG_NT) {
    for (int col = t; col < c; col += SEG_NT) {
      float acc = last_part[c_lo * c + col];
      for (long long k = c_lo + 1; k <= ch; ++k)
        acc += first_part[k * c + col];
      store_out(out + (long long)s * c + col, acc);
    }
    return;
  }
  const int groups = SEG_NT / c, g = t / c, col = t - g * c;
  if (g < groups) {
    float acc = 0.f;
    long long k = c_lo + 1 + g;
    for (; k + (SPAN_ILP - 1) * groups <= ch; k += SPAN_ILP * groups) {
      float x[SPAN_ILP];
#pragma unroll
      for (int u = 0; u < SPAN_ILP; ++u)
        x[u] = first_part[(k + u * groups) * c + col];
#pragma unroll
      for (int u = 0; u < SPAN_ILP; ++u) acc += x[u];
    }
    for (; k <= ch; k += groups) acc += first_part[k * c + col];
    red[t] = acc;
  }
  __syncthreads();
  if (t < c) {
    float acc = last_part[c_lo * c + t];
    for (int k = 0; k < groups; ++k) acc += red[k * c + t];
    store_out(out + (long long)s * c + t, acc);
  }
}

template <typename T, typename O, int V, bool VEC>
int segment_sum(const void* values, const int* seg, long long n, int n_seg,
                int c, int R, void* out, float* fp, float* lp,
                cudaStream_t s) {
  const long long chunks = n > 0 ? (n + R - 1) / R : 0;
  // rows a zero-fill block: about SEG_ZBLOCKS blocks, 256 to SEG_ZQ rows
  int zq = 256;
  while (zq < SEG_ZQ && (long long)zq * SEG_ZBLOCKS < n_seg) zq *= 2;
  const long long n_zero = (n_seg + zq - 1) / zq;
  if (n_zero + chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = seg_smem_bytes(R, c, (int)sizeof(T), V);
  auto kern = segment_sum_chunks<T, O, V, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (chunks > 0)
    kern<<<(unsigned)chunks, SEG_NT, smem, s>>>(
        (const T*)values, seg, n, n_seg, c, R, (O*)out, fp, lp);
  const long long spans = chunks > 1 ? chunks - 1 : 0;
  segment_sum_spans<O><<<(unsigned)(n_zero + spans), SEG_NT, 0, s>>>(
      seg, n, n_seg, c, R, zq, n_zero, fp, lp, (O*)out);
  return (int)cudaGetLastError();
}

// columns a thread: 16 bytes of values where rows and pointers allow it,
// else one
template <typename T, typename O>
int segment_sum_v(const void* values, const int* seg, long long n, int n_seg,
                  int c, int R, void* out, float* fp, float* lp,
                  cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  if (c % W == 0 && (uintptr_t)values % 16 == 0 && (uintptr_t)out % 16 == 0)
    return segment_sum<T, O, W, true>(values, seg, n, n_seg, c, R, out, fp,
                                      lp, s);
  return segment_sum<T, O, 1, false>(values, seg, n, n_seg, c, R, out, fp,
                                     lp, s);
}

}  // namespace

// values (n, c) of dtype (0 = f32, 1 = bf16), seg (n,) int32
// non-decreasing -> out (n_seg, c) of out_dtype (0 = f32, 1 = the values'
// type, bf16 only), every row written (no zeroing needed); rows_per_chunk R
// in [1, 1024], with first_part and last_part f32 scratch of
// (ceil(n / R), c) each
extern "C" int sg_segment_sum(const void* values, const void* seg,
                              long long n, int n_seg, int c, int dtype,
                              int out_dtype, int rows_per_chunk, void* out,
                              void* first_part, void* last_part,
                              void* stream) {
  if (n_seg <= 0 || c <= 0) return (int)cudaGetLastError();
  if (n < 0 || rows_per_chunk < 1 || rows_per_chunk > 1024 ||
      (out_dtype == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* sg = (const int*)seg;
  float* fp = (float*)first_part;
  float* lp = (float*)last_part;
  const int r = rows_per_chunk;
  if (dtype == 1)
    return out_dtype == 1
        ? segment_sum_v<__nv_bfloat16, __nv_bfloat16>(values, sg, n, n_seg,
                                                       c, r, out, fp, lp, s)
        : segment_sum_v<__nv_bfloat16, float>(values, sg, n, n_seg, c, r,
                                              out, fp, lp, s);
  return segment_sum_v<float, float>(values, sg, n, n_seg, c, r, out, fp, lp,
                                     s);
}

// src (n_src, row_bytes) raw bytes, idx (n_out,) int32 or (idx64) int64 ->
// out (n_out, row_bytes), 16-byte aligned.  Refused (cudaErrorInvalidValue)
// when out is not 16-byte aligned, or when the launch's thread count or
// (word route) the output's bytes do not fit in 31 bits.
extern "C" int sg_row_gather(const void* src, const void* idx, int idx64,
                             int n_src, int n_out, long long row_bytes,
                             void* out, void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (n_src <= 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    return row_gather<long long>(src, (const long long*)idx, n_src, n_out,
                                 row_bytes, out, s);
  return row_gather<int>(src, (const int*)idx, n_src, n_out, row_bytes, out,
                         s);
}
