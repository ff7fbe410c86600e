// Sorted-key joins for Hopper: the neighbour-cell join of soft grouping
// (K3) and the rulebook join of the training proposal grids (K7, below).
// Both look up keys[i] + dlin(r) in one sorted int32 key table.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <cstring>

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

// the same over the key table in device memory, with 64-bit indices: K3's
// searches, K7's of a query past its staged window (or of a wrapped query)
__device__ __forceinline__ long long table_lower_bound(
    const int* __restrict__ a, long long lo, long long hi, int q) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// K3: neighbour-cell join (sg_cell_join)
//
//   cand[r, i] = j  where keys[j] == keys[i] + dlin(r), the query passes the
//                   grid bounds test 0 <= ccoord[i] + offs[r] < dims, and
//                   |centroid[i] - centroid[j]|^2 <= r2;   else -1
//
// Replaces softgroup_tpu/ops/join_kernel.py:_join_kernel (driven by
// cell_neighbor_join).  The TPU kernel DMAs one key window per (offset,
// block) and matches by equality compares plus a one-hot matmul over
// bf16x3-split centroids, with an XLA fallback on overflow.
//
// Bound on the H100: bytes (keys, centroids and coarse coords read once,
// the (R, m) int32 table written once).  What it runs into is latency: a
// query is a chain of dependent loads (L1 starts cold at each launch, so
// most are L2 round trips).  The first design gave each thread one (offset,
// cell) query and a lower_bound over the whole table: ~14 dependent probes
// a query at m = 16384, ~17 at m = 131072.  Here:
//   * a thread owns one cell and one run of offsets: consecutive offsets
//     with the same (dx, dy) and rising dz (the host's plan; the 26 offsets
//     of the main path make 9 runs), so the keys it looks up rise by one or
//     two: after the run's first search, each later query steps forward
//     from the previous match (one or two rows);
//   * that first search brackets the match instead of searching the table:
//     with unique keys keys[i + d] >= keys[i] + d, so the match of dlin d
//     lies within |d| rows of the cell (at most d1 * d2 + d2 + 1 rows, and
//     within d2 + 1 for dx = 0); the keys just outside the bracket confirm
//     it, so duplicate keys (and a sum that leaves int32, which the plain
//     version's int32 sum wraps) search the whole table instead, and the
//     result stays the plain version's for any sorted table;
//   * only a key hit gathers the candidate's centroid; the distance is
//     computed with explicit round-to-nearest multiply and add (no FMA
//     contraction), in the plain version's order ((dx*dx + dy*dy) + dz*dz),
//     so the gate decision is bit-identical to it;
//   * the offsets and runs come by value (__grid_constant__), so a thread
//     reads them without a load that its first search would wait for;
//   * the threads of a warp own 32 neighbouring cells of one run, so its
//     writes of out[r, i] are 32 neighbouring ints of one row of out.
// A tile design (a block a tile of cells, one key window a dx group staged
// in shared memory, as the TPU kernel's three windows and K7) lost at both
// sizes: its block-wide chain (window searches, staging, barriers) cost more
// than the searches it saved (PERF.md, §6).
constexpr int CJ_MAX_OFF = 128;   // offsets a launch (26 on the main path)

struct CellJoinPlan {
  int n_off, n_runs;
  int off[3 * CJ_MAX_OFF];        // (dx, dy, dz) of each offset
  int run[CJ_MAX_OFF + 1];        // run c: offsets [run[c], run[c + 1])
};

__global__ void __launch_bounds__(256)
cell_join(const int* __restrict__ keys, const float* __restrict__ centroid,
          const int* __restrict__ ccoord, const int* __restrict__ dims,
          const __grid_constant__ CellJoinPlan plan, int m, float r2,
          int* __restrict__ out, int* __restrict__ stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int r0 = plan.run[blockIdx.y], r1 = plan.run[blockIdx.y + 1];
  const int key = keys[i];
  const int d0 = dims[0], d1 = dims[1], d2 = dims[2];
  const int x = ccoord[3 * i], y = ccoord[3 * i + 1], z = ccoord[3 * i + 2];
  const float cx = centroid[3 * i], cy = centroid[3 * i + 1],
              cz = centroid[3 * i + 2];
  int p = -1, q_prev = 0, n_table = 0;
  long long widest = 0;
  for (int r = r0; r < r1; ++r) {
    const int ox = plan.off[3 * r], oy = plan.off[3 * r + 1],
              oz = plan.off[3 * r + 2];
    int res = -1;
    if (key != INT_MAX && x + ox >= 0 && ox <= d0 - 1 - x && y + oy >= 0 &&
        oy <= d1 - 1 - y && z + oz >= 0 && oz <= d2 - 1 - z) {
      // dlin and the query with int32 wrap-around, as the plain version's
      // int32 tensors
      const int dl = (int)(((unsigned)ox * (unsigned)d1 + (unsigned)oy) *
                           (unsigned)d2 + (unsigned)oz);
      const int q = (int)((unsigned)key + (unsigned)dl);
      if (p >= 0 && q >= q_prev) {   // a step of the run: walk forward
        while (p < m && keys[p] < q) ++p;
      } else {
        long long a = 0, b = m;
        bool bracketed = false;
        if ((long long)key + dl == (long long)q) {   // the sum stays in int32
          const long long a2 = max(0LL, i + min(dl, 0));
          const long long b2 = min((long long)m, i + max(dl, 0));
          if ((a2 == 0 || keys[a2 - 1] < q) && (b2 == m || keys[b2] >= q)) {
            a = a2;
            b = b2;
            bracketed = true;
          }
        }
        if (bracketed) widest = max(widest, b - a); else ++n_table;
        p = (int)table_lower_bound(keys, a, b, q);
      }
      q_prev = q;
      if (p < m && keys[p] == q) {
        const float dx = __fsub_rn(cx, centroid[3 * p]);
        const float dy = __fsub_rn(cy, centroid[3 * p + 1]);
        const float dz = __fsub_rn(cz, centroid[3 * p + 2]);
        const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (dd <= r2) res = p;
      }
    }
    out[(long long)r * m + i] = res;
  }
  if (stats != nullptr) {
    if (widest) atomicMax(stats, (int)min(widest, (long long)INT_MAX));
    if (n_table) atomicAdd(stats + 1, n_table);
  }
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
          const long long l = table_lower_bound(
              keys, wraps ? 0 : lo + RJ_WCAP, wraps ? m : hi, q);
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

// keys (m,) int32 sorted, INT_MAX padded; centroid (m, 3) f32; ccoord
// (m, 3) int32; dims (3,) int32 on the card; plan: a CellJoinPlan in host
// memory (the offsets and their runs) -> out (plan.n_off, m) int32.  block:
// threads a block, one of 32, 64, 128, 256.  stats: null, or int32 [widest
// bracket searched, queries searched over the whole table] that the kernel
// raises / adds to.
extern "C" int sg_cell_join(const void* keys, const void* centroid,
                            const void* ccoord, const void* dims,
                            const void* plan, int m, float r2, int block,
                            void* out, void* stats, void* stream) {
  CellJoinPlan p;
  memcpy(&p, plan, sizeof p);
  if ((long long)p.n_off * m <= 0) return (int)cudaGetLastError();
  if ((block != 32 && block != 64 && block != 128 && block != 256) ||
      p.n_off > CJ_MAX_OFF || p.n_runs < 1 || p.n_runs > p.n_off)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)m + block - 1) / block),
                  (unsigned)p.n_runs);
  cell_join<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const float*)centroid, (const int*)ccoord,
      (const int*)dims, p, m, r2, (int*)out, (int*)stats);
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
