// Sorted-key joins for Hopper: the neighbour-cell join of soft grouping
// (K3) and the rulebook join of the training proposal grids (K7, below).
//
// K3:
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

// first index p with keys[p] >= q in the sorted table (m if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int m, int q) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

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
      const int lo = lower_bound(keys, m, q);
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

// K7: rulebook join (sg_rules_join)
//
//   rules[r, i] = j  where keys[j] == keys[i] + dlin(r) and the query
//                    passes the bounds test 0 <= xyz[i] + offs[r] < dims;
//                    else -1
//
// Replaces softgroup_tpu/ops/join_kernel.py:_rules_kernel (driven by
// sorted_key_rules_join): the 26 non-centre taps of the (27, V) subm
// rulebook of each tiny-U-Net level on the training proposal grids.  The
// TPU kernel DMAs three key windows per block (offsets grouped by dx) and
// counts compares across the window, with an XLA fallback on overflow.
// Here each thread owns one (offset, voxel) query: K3 without the centroid
// gate, one binary search in the sorted table (512 KB at m = 131072,
// resident in L2), so there is no window and no fallback.
//
// Bound on the H100: bytes (keys and coords read once, the (R, m) int32
// rulebook written once); the ~17 dependent probes per query hit L2.
__global__ void rules_join(const int* __restrict__ keys,
                           const int* __restrict__ xyz,
                           const int* __restrict__ dims,
                           const int* __restrict__ offs, int n_off, int m,
                           int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_off * m) return;
  const int r = (int)(t / m), i = (int)(t - (long long)r * m);
  const int key = keys[i];
  int res = -1;
  if (key != INT_MAX) {
    const int ox = offs[3 * r], oy = offs[3 * r + 1], oz = offs[3 * r + 2];
    const int d0 = dims[0], d1 = dims[1], d2 = dims[2];
    const int x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (x + ox >= 0 && ox <= d0 - 1 - x && y + oy >= 0 &&
        oy <= d1 - 1 - y && z + oz >= 0 && oz <= d2 - 1 - z) {
      const int q = key + (ox * d1 + oy) * d2 + oz;
      const int j = lower_bound(keys, m, q);
      if (j < m && keys[j] == q) res = j;
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

extern "C" int sg_rules_join(const void* keys, const void* xyz,
                             const void* dims, const void* offs, int n_off,
                             int m, void* out, void* stream) {
  const long long total = (long long)n_off * m;
  if (total <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((total + 255) / 256);
  rules_join<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)xyz, (const int*)dims, (const int*)offs,
      n_off, m, (int*)out);
  return (int)cudaGetLastError();
}
