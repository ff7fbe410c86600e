// Host geometry of the input batch: voxelization, the 3^3 submanifold
// rulebook and the k2s2 downsample maps of every pyramid level, in C++.
//
// Counterpart of the three builders of softgroup_tpu/csrc/hostops.cpp
// (sg_voxelize, sg_subm_rules, sg_downsample; the TPU window metadata has
// no counterpart in this package).  The outputs are bit-identical to the
// numpy builders of ops/voxelize.py and ops/rulebook.py, which stay as the
// plain version.  Exposed through a C ABI and loaded with ctypes by
// ops/native.py, which compiles this file with g++ at first use.
//
// Both builders work on sorted packed keys, with no hash table: voxelize
// radix-sorts the point keys and numbers the runs; the rulebook walks the
// sorted voxel keys once per tap, since a constant tap offset keeps the
// queries of in-range neighbours in key order (a merge join).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

inline int64_t pack(const int32_t* c) {
  // (b, x, y, z) with 16 bits per spatial component is ample for every
  // supported dataset (max extent ~1536 voxels)
  return (int64_t(c[0]) << 48) | (int64_t(c[1]) << 32) |
         (int64_t(c[2]) << 16) | int64_t(c[3]);
}

constexpr int kDigit = 16;
constexpr int64_t kBuckets = int64_t(1) << kDigit;

// Stable LSD radix sort of signed 64-bit keys, 16 bits a pass; a pass whose
// digit is the same for every key is skipped (the batch id's, and the high
// bits of small extents).  On return `sorted` holds the keys in ascending
// order and `order` the index of each, ties in index order.
void sort_keys(const std::vector<int64_t>& keys, std::vector<int64_t>& sorted,
               std::vector<int32_t>& order) {
  const int64_t n = int64_t(keys.size());
  std::vector<uint64_t> k(n), k2(n);
  std::vector<int32_t> o2(n);
  order.resize(n);
  std::vector<int64_t> hist(4 * kBuckets, 0);
  for (int64_t i = 0; i < n; ++i) {
    // flip the sign bit: unsigned order of the result = signed order
    k[i] = uint64_t(keys[i]) ^ (uint64_t(1) << 63);
    order[i] = int32_t(i);
    for (int p = 0; p < 4; ++p)
      ++hist[p * kBuckets + ((k[i] >> (kDigit * p)) & (kBuckets - 1))];
  }
  for (int p = 0; p < 4 && n > 0; ++p) {
    int64_t* h = hist.data() + p * kBuckets;
    const int shift = kDigit * p;
    if (h[(k[0] >> shift) & (kBuckets - 1)] == n) continue;
    int64_t run = 0;
    for (int64_t d = 0; d < kBuckets; ++d) {
      const int64_t c = h[d];
      h[d] = run;
      run += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      const int64_t at = h[(k[i] >> shift) & (kBuckets - 1)]++;
      k2[at] = k[i];
      o2[at] = order[i];
    }
    k.swap(k2);
    order.swap(o2);
  }
  sorted.resize(n);
  for (int64_t i = 0; i < n; ++i)
    sorted[i] = int64_t(k[i] ^ (uint64_t(1) << 63));
}

}  // namespace

extern "C" {

// Deduplicate coords (n,4) -> sorted-key-unique voxels, each with the
// coords of its first point.  Outputs: p2v (n), vox_coords (capacity,4).
// Returns m (may exceed capacity — caller must check; writes are clipped).
int64_t sg_voxelize(const int32_t* coords, int64_t n, int32_t* p2v,
                    int32_t* vox_coords, int64_t capacity) {
  std::vector<int64_t> keys(n), sorted;
  std::vector<int32_t> order;
  for (int64_t i = 0; i < n; ++i) keys[i] = pack(coords + 4 * i);
  sort_keys(keys, sorted, order);
  int64_t m = 0;
  for (int64_t j = 0; j < n; ++j) {
    if (j == 0 || sorted[j] != sorted[j - 1]) {
      // a run's first entry is its lowest point index (stable sort)
      if (m < capacity)
        std::memcpy(vox_coords + 4 * m, coords + 4 * int64_t(order[j]), 16);
      ++m;
    }
    p2v[order[j]] = int32_t(m - 1);
  }
  return m;
}

// 3^3 submanifold rulebook over voxel coords (m,4): rules (27, m), -1 when
// the neighbour is absent or out of [0, dims).
void sg_subm_rules(const int32_t* vox, int64_t m, const int32_t* dims,
                   int32_t* rules) {
  std::vector<int64_t> keys(m), sorted;
  std::vector<int32_t> order;
  for (int64_t v = 0; v < m; ++v) keys[v] = pack(vox + 4 * v);
  sort_keys(keys, sorted, order);
  const int64_t* sk = sorted.data();

  int64_t k = 0;
  for (int dx = -1; dx <= 1; ++dx)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dz = -1; dz <= 1; ++dz, ++k) {
        int32_t* row = rules + k * m;
        if (dx == 0 && dy == 0 && dz == 0) {
          for (int64_t v = 0; v < m; ++v) row[v] = int32_t(v);
          continue;
        }
        // walk the voxels in key order; the queries rise with them, so
        // the table position only moves forward (a query below the last
        // one, possible only for out-of-grid coordinates, is searched)
        int64_t at = 0;
        int64_t last = std::numeric_limits<int64_t>::min();
        for (int64_t j = 0; j < m; ++j) {
          const int32_t v = order[j];
          const int32_t* c = vox + 4 * int64_t(v);
          const int32_t q[4] = {c[0], c[1] + dx, c[2] + dy, c[3] + dz};
          if (q[1] < 0 || q[2] < 0 || q[3] < 0 || q[1] >= dims[0] ||
              q[2] >= dims[1] || q[3] >= dims[2]) {
            row[v] = -1;
            continue;
          }
          const int64_t qk = pack(q);
          if (qk < last)
            at = std::lower_bound(sk, sk + m, qk) - sk;
          else
            while (at < m && sk[at] < qk) ++at;
          last = qk;
          row[v] = (at < m && sk[at] == qk) ? order[at] : -1;
        }
      }
}

// k=2 s=2 downsample maps.  Outputs: out_coords (capacity,4) in sorted key
// order, down_rules (8, capacity) child table, parent_idx (m), child_tap (m).
// Returns the coarse voxel count c (may exceed capacity; writes clipped).
int64_t sg_downsample(const int32_t* vox, int64_t m, int32_t* out_coords,
                      int32_t* down_rules, int32_t* parent_idx,
                      int32_t* child_tap, int64_t capacity) {
  std::vector<int32_t> parents(size_t(m) * 4);
  for (int64_t v = 0; v < m; ++v) {
    const int32_t* c = vox + 4 * v;
    int32_t* p = parents.data() + 4 * v;
    p[0] = c[0];
    p[1] = c[1] >> 1;
    p[2] = c[2] >> 1;
    p[3] = c[3] >> 1;
  }
  const int64_t c =
      sg_voxelize(parents.data(), m, parent_idx, out_coords, capacity);
  const int64_t cc = std::min(c, capacity);
  std::fill(down_rules, down_rules + 8 * capacity, -1);
  for (int64_t v = 0; v < m; ++v) {
    const int32_t* cv = vox + 4 * v;
    const int32_t tap =
        ((cv[1] & 1) << 2) | ((cv[2] & 1) << 1) | (cv[3] & 1);
    child_tap[v] = tap;
    if (parent_idx[v] < cc) down_rules[tap * capacity + parent_idx[v]] =
        int32_t(v);
  }
  return c;
}

}  // extern "C"
