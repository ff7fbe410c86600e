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
// one write of the output).  The sources on the main path are small (64 KB
// of cell labels, a few MB of voxel features) and stay in L2, so a gather
// costs its launch plus the instructions and memory transactions of each
// thread; the design cuts both:
//   * rows of 1, 2, 4 or 8 bytes (the int32 cell labels, the top_c gather):
//     a thread writes the 16 bytes of 16 / row_bytes consecutive output
//     rows.  It reads their indices with 16-byte loads, the rows with
//     read-only loads from the cached table, and stores one 16-byte vector;
//     the ragged tail and unaligned indices take a scalar loop;
//   * wider rows: one thread per 16-byte vector of an output row (devoxelize's
//     64-byte rows, the (P, 4) f32 entries), or per 4-, 2- or 1-byte word
//     where the row size or a pointer does not allow 16; neighbouring
//     threads copy neighbouring vectors, so a 64-byte row is one
//     transaction.  The row of a thread is a shift of its index when the
//     vectors per row are a power of two, else one 32-bit division;
//   * all index math is 32-bit (the launcher refuses a launch whose thread
//     count does not fit), and the indices are read as int32 or int64 as
//     given, so the caller casts nothing.
// Clamping matches the reference's gather semantics and keeps every read in
// bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

template <typename I>
__device__ __forceinline__ long long clamp_row(I j, int n_src) {
  return j < 0 ? 0 : (j >= (I)n_src ? n_src - 1 : (long long)j);
}

// one thread per V-sized vector of an output row
template <typename V, typename I, bool POW2>
__global__ void row_gather_vec(const V* __restrict__ src,
                               const I* __restrict__ idx, int n_src,
                               int total, int vec_per_row, int shift,
                               V* __restrict__ out) {
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

template <typename V, typename I>
int launch_vec(const void* src, const I* idx, int n_src, int n_out,
               long long row_bytes, void* out, cudaStream_t stream) {
  const long long vpr = row_bytes / (long long)sizeof(V);
  const long long total = (long long)n_out * vpr;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + GATHER_NT - 1) / GATHER_NT);
  if ((vpr & (vpr - 1)) == 0) {
    int shift = 0;
    while ((1LL << shift) < vpr) ++shift;
    row_gather_vec<V, I, true><<<blocks, GATHER_NT, 0, stream>>>(
        (const V*)src, idx, n_src, (int)total, (int)vpr, shift, (V*)out);
  } else {
    row_gather_vec<V, I, false><<<blocks, GATHER_NT, 0, stream>>>(
        (const V*)src, idx, n_src, (int)total, (int)vpr, 0, (V*)out);
  }
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
  const uintptr_t as = (uintptr_t)src, ao = (uintptr_t)out;
  if (ao % 16 == 0 && row_bytes < 16 && as % row_bytes == 0) {
    switch (row_bytes) {
      case 1: return launch_narrow<uint8_t, I>(src, idx, n_src, n_out, out, s);
      case 2: return launch_narrow<uint16_t, I>(src, idx, n_src, n_out, out, s);
      case 4: return launch_narrow<uint32_t, I>(src, idx, n_src, n_out, out, s);
      case 8: return launch_narrow<uint2, I>(src, idx, n_src, n_out, out, s);
      default: break;
    }
  }
  const uintptr_t align = as | ao;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch_vec<uint4, I>(src, idx, n_src, n_out, row_bytes, out, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch_vec<uint32_t, I>(src, idx, n_src, n_out, row_bytes, out, s);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch_vec<uint16_t, I>(src, idx, n_src, n_out, row_bytes, out, s);
  return launch_vec<uint8_t, I>(src, idx, n_src, n_out, row_bytes, out, s);
}

// ---------------------------------------------------------------------------
// K6: sorted segment sum (sg_segment_sum)
//
//   out[s, :] = sum of values[i, :] over the rows i with seg[i] == s,
//               seg non-decreasing; rows with seg outside [0, S) dropped
//
// Replaces softgroup_tpu/ops/gather_kernel.py:_segsum_kernel (driven by
// monotone_segment_sum): the backward of a row gather (devoxelize, the
// proposal-entry gather, the mask gather).  The TPU kernel DMAs a window of
// rows per block of 256 segments and sums them with a one-hot matmul, with
// an XLA fallback when a block's rows overflow the window and a bf16x3
// split for f32.
//
// Here the rows are cut into chunks of SEG_R = 256; a block owns a chunk.
// It finds the chunk's runs of equal seg (a ballot scan in shared memory)
// and each thread sums (run, column) pairs in row order in f32, so
// neighbouring threads read neighbouring columns.  A run inside the chunk
// is a whole segment and goes straight to ``out``; a run that crosses the
// chunk's first row is written to a first-partial slot, one that crosses
// its last row to a last-partial slot.  A second kernel finishes each
// segment that spans chunks, in the block of the chunk where it ends, by
// adding its partials in chunk order.  Long runs (the dustbin row of the
// padded entries, ~4e5 rows) are thus summed by all the chunks they cover
// in parallel.  No window, no fallback, no atomics: the result is
// deterministic; a segment inside one chunk is summed in index order,
// exactly as a sequential CPU index_add_.  ``out`` must be zeroed first
// (empty segments get no write).
//
// Bound on the H100: bytes (one read of values and seg, one write of out).
constexpr int SEG_R = 256;   // rows per chunk, one chunk per block
constexpr int SEG_NT = 256;  // threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(SEG_NT)
segment_sum_chunks(const T* __restrict__ values, const int* __restrict__ seg,
                   long long n, int n_seg, int c, float* __restrict__ out,
                   float* __restrict__ first_part,
                   float* __restrict__ last_part) {
  __shared__ int run_start[SEG_R + 1];
  __shared__ int warp_runs[SEG_NT / 32];
  __shared__ int n_runs;
  const long long r0 = (long long)blockIdx.x * SEG_R;
  const int rows = (int)min((long long)SEG_R, n - r0);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  // run starts: row 0 of the chunk, and every row whose seg differs from
  // the row before it; compacted in row order with a ballot scan
  const bool start = t < rows && (t == 0 || seg[r0 + t] != seg[r0 + t - 1]);
  const unsigned mask = __ballot_sync(0xffffffffu, start);
  if (lane == 0) warp_runs[warp] = __popc(mask);
  __syncthreads();
  if (t == 0) {
    int acc = 0;
    for (int w = 0; w < SEG_NT / 32; ++w) {
      const int k = warp_runs[w];
      warp_runs[w] = acc;
      acc += k;
    }
    n_runs = acc;
    run_start[acc] = rows;
  }
  __syncthreads();
  if (start)
    run_start[warp_runs[warp] + __popc(mask & ((1u << lane) - 1u))] = t;
  __syncthreads();
  const int nr = n_runs;
  const bool crosses_in = r0 > 0 && seg[r0] == seg[r0 - 1];
  const bool crosses_out = r0 + rows < n &&
                           seg[r0 + rows] == seg[r0 + rows - 1];
  for (int p = t; p < nr * c; p += SEG_NT) {
    const int k = p / c, col = p - k * c;
    const int a = run_start[k], b = run_start[k + 1];
    const int s = seg[r0 + a];
    if (s < 0 || s >= n_seg) continue;
    float acc = 0.f;
    for (int i = a; i < b; ++i) acc += to_f32(values[(r0 + i) * c + col]);
    if (k == 0 && crosses_in)
      first_part[(long long)blockIdx.x * c + col] = acc;
    else if (k == nr - 1 && crosses_out)
      last_part[(long long)blockIdx.x * c + col] = acc;
    else
      out[(long long)s * c + col] = acc;
  }
}

// a segment that spans chunks c_lo..c_hi: P_last[c_lo] + P_first[c_lo + 1]
// + ... + P_first[c_hi], added in the block of c_hi
__global__ void __launch_bounds__(SEG_NT)
segment_sum_spans(const int* __restrict__ seg, long long n, int n_seg, int c,
                  const float* __restrict__ first_part,
                  const float* __restrict__ last_part,
                  float* __restrict__ out) {
  const long long ch = blockIdx.x + 1;  // chunk 0 starts no span
  const long long r0 = ch * SEG_R;
  if (r0 >= n) return;
  const int s = seg[r0];
  if (s < 0 || s >= n_seg || seg[r0 - 1] != s) return;
  const long long r_end = min(r0 + SEG_R, n);
  if (r_end < n && seg[r_end] == s) return;  // continues: not its end
  long long lo = 0, hi = r0;  // first row of the segment
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (seg[mid] < s) lo = mid + 1; else hi = mid;
  }
  const long long c_lo = lo / SEG_R;
  for (int col = threadIdx.x; col < c; col += SEG_NT) {
    float acc = last_part[c_lo * c + col];
    for (long long k = c_lo + 1; k <= ch; ++k) acc += first_part[k * c + col];
    out[(long long)s * c + col] = acc;
  }
}

}  // namespace

// values (n, c) of dtype (0 = f32, 1 = bf16), seg (n,) int32
// non-decreasing -> out (n_seg, c) f32, zeroed by the caller; first_part
// and last_part are f32 scratch of (ceil(n / 256), c) each
extern "C" int sg_segment_sum(const void* values, const void* seg,
                              long long n, int n_seg, int c, int dtype,
                              void* out, void* first_part, void* last_part,
                              void* stream) {
  if (n <= 0 || n_seg <= 0 || c <= 0) return (int)cudaGetLastError();
  const long long chunks = (n + SEG_R - 1) / SEG_R;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* fp = (float*)first_part;
  float* lp = (float*)last_part;
  if (dtype == 1)
    segment_sum_chunks<__nv_bfloat16><<<(unsigned)chunks, SEG_NT, 0, s>>>(
        (const __nv_bfloat16*)values, (const int*)seg, n, n_seg, c,
        (float*)out, fp, lp);
  else
    segment_sum_chunks<float><<<(unsigned)chunks, SEG_NT, 0, s>>>(
        (const float*)values, (const int*)seg, n, n_seg, c, (float*)out, fp,
        lp);
  if (chunks > 1)
    segment_sum_spans<<<(unsigned)(chunks - 1), SEG_NT, 0, s>>>(
        (const int*)seg, n, n_seg, c, fp, lp, (float*)out);
  return (int)cudaGetLastError();
}

// src (n_src, row_bytes) raw bytes, idx (n_out,) int32 or (idx64) int64 ->
// out (n_out, row_bytes).  Refused (cudaErrorInvalidValue) when the launch's
// thread count does not fit in 32 bits.
extern "C" int sg_row_gather(const void* src, const void* idx, int idx64,
                             int n_src, int n_out, long long row_bytes,
                             void* out, void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (n_src <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    return row_gather<long long>(src, (const long long*)idx, n_src, n_out,
                                 row_bytes, out, s);
  return row_gather<int>(src, (const int*)idx, n_src, n_out, row_bytes, out,
                         s);
}
