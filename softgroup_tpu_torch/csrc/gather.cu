// Row gather out[i, :] = src[clamp(idx[i], 0, n_src - 1), :] for Hopper.
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
// one write of the output).  Design: one thread per 16-byte vector of an
// output row when the row size and both pointers allow it, else per 4-, 2-
// or 1-byte word; neighbouring threads copy neighbouring vectors of a row,
// so a row of 64 bytes is one 64-byte transaction.  Clamping matches the
// reference's gather semantics and keeps every read in bounds.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename V>
__global__ void row_gather(const V* __restrict__ src,
                           const int* __restrict__ idx, int n_src,
                           long long n_out, int vec_per_row,
                           V* __restrict__ out) {
  const long long total = n_out * vec_per_row;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long i = t / vec_per_row;
    const int c = (int)(t - i * vec_per_row);
    int j = idx[i];
    j = j < 0 ? 0 : (j >= n_src ? n_src - 1 : j);
    out[t] = src[(long long)j * vec_per_row + c];
  }
}

template <typename V>
int launch(const void* src, const int* idx, int n_src, int n_out,
           long long row_bytes, void* out, cudaStream_t stream) {
  const int vec = (int)(row_bytes / sizeof(V));
  const long long total = (long long)n_out * vec;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  row_gather<V><<<(unsigned)blocks, 256, 0, stream>>>(
      (const V*)src, idx, n_src, n_out, vec, (V*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sg_row_gather(const void* src, const void* idx, int n_src,
                             int n_out, long long row_bytes, void* out,
                             void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)src | (uintptr_t)out;
  const int* ix = (const int*)idx;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(src, ix, n_src, n_out, row_bytes, out, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(src, ix, n_src, n_out, row_bytes, out, s);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch<uint16_t>(src, ix, n_src, n_out, row_bytes, out, s);
  return launch<uint8_t>(src, ix, n_src, n_out, row_bytes, out, s);
}
