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
#include <cstdint>

#include "staging.cuh"

namespace {

// first p in [lo, hi) with a[p] >= q (hi if none)
__device__ __forceinline__ int lower_bound_in(const int* a, int lo, int hi,
                                              int q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1; else hi = mid;
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
      const int lo = lower_bound_in(keys, 0, m, q);
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
//
// Bound on the H100: bytes (keys and coords read once, the (R, m) int32
// rulebook written once).  The first design gave each thread one (offset,
// voxel) query and a lower_bound over the whole table: ~17 dependent L2
// probes a query at m = 131072.  Yet the table is sorted, so the queries
// keys[i] + dlin(r) of a tile of consecutive rows all fall in one short
// stretch of it.  Here:
//   * a block takes a tile of T consecutive rows (the wrapper picks T) and
//     all R <= 64 offsets (staged in shared memory with their dlin); a tile
//     whose first key is INT_MAX is padding (the table is sorted) and
//     writes -1;
//   * its queries lie in [kmin + dmin, kmax + dmax] (the tile's smallest and
//     largest valid key, the offsets' smallest and largest dlin).  With
//     strictly increasing keys a match of row i lies at an index within
//     |dlin| of i, so the block stages the index window [i0 + dmin,
//     i0 + T + dmax) (T + 842 keys at D = 20) with 16-byte cp.async, and
//     two keys beside it show whether it holds every key of the query range;
//     where it does not (duplicate keys) or is too long to stage, two lower
//     bounds in the table (32 probes a round by one warp each) give the
//     window of the query range instead;
//   * each query first probes the window at i + dlin (its match in a full
//     grid) and else searches the window in shared memory;
//   * a window longer than RJ_WCAP keys (sparse keys on a large grid) is
//     staged in part: a query past the staged keys searches the rest of
//     the window in the table, inside the kernel, so the result is the
//     same; ``stats`` (when given) counts these queries and the largest
//     window;
//   * a tile whose queries could leave int32 (keys within |dlin| of the
//     int32 ends, where the plain version's sum wraps) searches the whole
//     table with the wrapped query, as the plain version does;
//   * thread (offset group, row) writes out[r, i] for its row i, so a
//     warp's writes are 32 neighbouring ints of one offset's row.
// The result equals the plain version's exactly.
constexpr int RJ_NT = 256;      // threads per block
constexpr int RJ_WCAP = 4096;   // keys of a window staged in shared memory
constexpr int RJ_MAX_OFF = 64;  // offsets a launch (26 on the main path)

__global__ void __launch_bounds__(RJ_NT)
rules_join(const int* __restrict__ keys, const int* __restrict__ xyz,
           const int* __restrict__ dims, const int* __restrict__ offs,
           int n_off, int m, int tile, int* __restrict__ out,
           int* __restrict__ stats) {
  __shared__ __align__(16) int s_win[RJ_WCAP + 4];
  __shared__ int s_off[3 * RJ_MAX_OFF], s_dl[RJ_MAX_OFF];
  __shared__ int s_edge[2];
  __shared__ long long s_bound[2];
  __shared__ int s_drange[2];
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * tile;
  const int rows = (int)min((long long)tile, (long long)m - i0);
  const int ti = t % tile, r_first = t / tile, r_step = RJ_NT / tile;
  const long long i = i0 + ti;
  const bool row_ok = ti < rows;
  const int kmin = keys[i0];
  if (kmin == INT_MAX) {   // padding only (the table is sorted)
    if (row_ok)
      for (int r = r_first; r < n_off; r += r_step)
        out[(long long)r * m + i] = -1;
    return;
  }
  const int d0 = dims[0], d1 = dims[1], d2 = dims[2];
  if (t < 32) {   // the offsets and their dlin; their dlin range
    int lo_ = 0, hi_ = 0;
    for (int r = t; r < n_off; r += 32) {
      const int ox = offs[3 * r], oy = offs[3 * r + 1], oz = offs[3 * r + 2];
      s_off[3 * r] = ox;
      s_off[3 * r + 1] = oy;
      s_off[3 * r + 2] = oz;
      // dlin with int32 wrap-around, as the plain version's int32 tensors
      const int dl = (int)(((unsigned)ox * (unsigned)d1 + (unsigned)oy) *
                           (unsigned)d2 + (unsigned)oz);
      s_dl[r] = dl;
      lo_ = min(lo_, dl);
      hi_ = max(hi_, dl);
    }
    lo_ = __reduce_min_sync(0xffffffffu, lo_);
    hi_ = __reduce_max_sync(0xffffffffu, hi_);
    if (t == 0) {
      s_drange[0] = lo_;
      s_drange[1] = hi_;
    }
  }
  const int key = row_ok ? keys[i] : INT_MAX;
  int x = 0, y = 0, z = 0;
  if (key != INT_MAX) {
    x = xyz[3 * i];
    y = xyz[3 * i + 1];
    z = xyz[3 * i + 2];
  }
  __syncthreads();
  const int dmin = s_drange[0], dmax = s_drange[1];   // dmin <= 0 <= dmax
  // with strictly increasing keys a match of row i at dlin d lies at an
  // index in [i + min(d, 0), i + max(d, 0)]: stage that index window of the
  // tile at once, and check below that it holds every key of the tile's
  // query range
  long long lo = max(0LL, i0 + dmin), hi = min((long long)m, i0 + rows + dmax);
  const bool staged = hi - lo <= RJ_WCAP;
  int shift = 0;
  if (staged) {
    shift = stage_async<int>(reinterpret_cast<char*>(s_win),
                             reinterpret_cast<const char*>(keys + lo),
                             4 * (hi - lo)) / 4;
    if (t == 0 && lo > 0) s_edge[0] = keys[lo - 1];
    if (t == 1 && hi < m) s_edge[1] = keys[hi];
  }
  cp_async_wait_all();
  // keys are sorted: the valid ones lead the tile
  const int n_valid = __syncthreads_count(r_first == 0 && key != INT_MAX);
  const int kmax = staged ? s_win[shift + (i0 - lo) + n_valid - 1]
                          : keys[i0 + n_valid - 1];
  const long long qlo = (long long)kmin + dmin, qhi = (long long)kmax + dmax;
  const bool wraps = qlo < INT_MIN || qhi > INT_MAX;
  const bool fits = staged && !wraps &&
                    (lo == 0 || (long long)s_edge[0] < qlo) &&
                    (hi == m || (long long)s_edge[1] > qhi);
  if (!fits && !wraps) {
    // the keys in [qlo, qhi] reach past the index window (duplicate keys)
    // or it is too long to stage: find their window by search
    const int warp = t / 32;
    if (warp < 2) {
      const long long p = warp_lower_bound(keys, 0, m, warp ? qhi + 1 : qlo);
      if ((t & 31) == 0) s_bound[warp] = p;
    }
    __syncthreads();
    lo = s_bound[0];
    hi = s_bound[1];
    shift = stage_async<int>(
        reinterpret_cast<char*>(s_win),
        reinterpret_cast<const char*>(keys + lo),
        4 * min(hi - lo, (long long)RJ_WCAP)) / 4;
    cp_async_wait_all();
    __syncthreads();
  }
  if (wraps) lo = hi = 0;
  const int wn = (int)min(hi - lo, (long long)RJ_WCAP);
  const bool cut = hi - lo > RJ_WCAP;
  if (stats != nullptr && t == 0)
    atomicMax(stats, (int)min(hi - lo, (long long)INT_MAX));
  if (!row_ok) return;
  const int* w = s_win + shift;
  const int w_last = wn > 0 ? w[wn - 1] : INT_MIN;
  int n_global = 0;
  for (int r = r_first; r < n_off; r += r_step) {
    int res = -1;
    if (key != INT_MAX) {
      const int ox = s_off[3 * r], oy = s_off[3 * r + 1],
                oz = s_off[3 * r + 2];
      if (x + ox >= 0 && ox <= d0 - 1 - x && y + oy >= 0 &&
          oy <= d1 - 1 - y && z + oz >= 0 && oz <= d2 - 1 - z) {
        const int q = (int)((unsigned)key + (unsigned)s_dl[r]);
        if (!wraps && (!cut || q <= w_last)) {
          // a full grid puts the match at i + dlin: probe there first
          const long long g = i - lo + s_dl[r];
          int p;
          if (g >= 0 && g < wn && w[g] == q && (g == 0 || w[g - 1] != q))
            p = (int)g;
          else
            p = lower_bound_in(w, 0, wn, q);
          if (p < wn && w[p] == q) res = (int)(lo + p);
        } else {
          const long long from = wraps ? 0 : lo + RJ_WCAP;
          const long long to = wraps ? m : hi;
          long long l = from, h = to;
          while (l < h) {
            const long long mid = (l + h) >> 1;
            if (keys[mid] < q) l = mid + 1; else h = mid;
          }
          if (l < m && keys[l] == q) res = (int)l;
          ++n_global;
        }
      }
    }
    out[(long long)r * m + i] = res;
  }
  if (stats != nullptr && n_global) atomicAdd(stats + 1, n_global);
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

// keys (m,) int32 sorted, INT_MAX padded; xyz (m, 3) int32; dims (3,) and
// offs (n_off, 3) int32 on the card -> out (n_off, m) int32.  tile: rows a
// block, one of 32, 64, 128, 256.  stats: null, or int32 [largest window,
// queries searched in the table] that the kernel raises / adds to.
extern "C" int sg_rules_join(const void* keys, const void* xyz,
                             const void* dims, const void* offs, int n_off,
                             int m, int tile, void* out, void* stats,
                             void* stream) {
  if ((long long)n_off * m <= 0) return (int)cudaGetLastError();
  if ((tile != 32 && tile != 64 && tile != 128 && tile != 256) ||
      n_off > RJ_MAX_OFF)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((long long)m + tile - 1) / tile);
  rules_join<<<blocks, RJ_NT, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)xyz, (const int*)dims, (const int*)offs,
      n_off, m, tile, (int*)out, (int*)stats);
  return (int)cudaGetLastError();
}
