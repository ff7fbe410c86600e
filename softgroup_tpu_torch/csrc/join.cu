// Neighbour-cell join of soft grouping, for Hopper.
//
//   cand[r, i] = j  where keys[j] == keys[i] + dlin(r), the query passes the
//                   grid bounds test 0 <= ccoord[i] + offs[r] < dims, and
//                   |centroid[i] - centroid[j]|^2 <= r2;   else -1
//
// Replaces softgroup_tpu/ops/join_kernel.py:_join_kernel (driven by
// cell_neighbor_join).  The TPU kernel slides a key window per block and
// matches by equality compares plus a one-hot matmul over bf16x3-split
// centroids; here each thread owns one (offset, cell) query and finds it by
// binary search in the sorted key table, which needs no window and so has
// no overflow fallback.
//
// Bound on the H100: bytes (keys, centroids and coarse coords read once,
// the (R, m) int32 table written once); the ~log2(m) dependent probes per
// query hit L2, since the whole table (16 384 keys) is 64 KB.  The distance
// is computed with explicit round-to-nearest multiply and add (no FMA
// contraction), in the same order as the plain version, ((dx*dx + dy*dy) +
// dz*dz), so the gate decision is bit-identical to it.

#include <cuda_runtime.h>
#include <climits>

namespace {

__global__ void cell_join(const int* __restrict__ keys,
                          const float* __restrict__ centroid,
                          const int* __restrict__ ccoord,
                          const int* __restrict__ dims,
                          const int* __restrict__ offs, int n_off, int m,
                          float r2, int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_off * m) return;
  const int r = (int)(t / m), i = (int)(t - (long long)r * m);
  const int key = keys[i];
  int res = -1;
  if (key != INT_MAX) {
    const int ox = offs[3 * r], oy = offs[3 * r + 1], oz = offs[3 * r + 2];
    const int d0 = dims[0], d1 = dims[1], d2 = dims[2];
    const int cx = ccoord[3 * i], cy = ccoord[3 * i + 1],
              cz = ccoord[3 * i + 2];
    const bool ok = cx + ox >= 0 && ox <= d0 - 1 - cx && cy + oy >= 0 &&
                    oy <= d1 - 1 - cy && cz + oz >= 0 && oz <= d2 - 1 - cz;
    if (ok) {
      const int q = key + (ox * d1 + oy) * d2 + oz;
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < q) lo = mid + 1; else hi = mid;
      }
      if (lo < m && keys[lo] == q) {
        const float dx = __fsub_rn(centroid[3 * i], centroid[3 * lo]);
        const float dy = __fsub_rn(centroid[3 * i + 1], centroid[3 * lo + 1]);
        const float dz = __fsub_rn(centroid[3 * i + 2], centroid[3 * lo + 2]);
        const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (dd <= r2) res = lo;
      }
    }
  }
  out[t] = res;
}

}  // namespace

extern "C" int sg_cell_join(const void* keys, const void* centroid,
                            const void* ccoord, const void* dims,
                            const void* offs, int n_off, int m, float r2,
                            void* out, void* stream) {
  const long long total = (long long)n_off * m;
  if (total <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((total + 255) / 256);
  cell_join<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const float*)centroid, (const int*)ccoord,
      (const int*)dims, (const int*)offs, n_off, m, r2, (int*)out);
  return (int)cudaGetLastError();
}
