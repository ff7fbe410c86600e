// Sparse 3-D convolution as a gather-GEMM, for Hopper (sm_90a).
//
//   out[v, :] = sum_k feats[nbr(k, v), :] @ W[k]      (nbr == -1 adds 0)
//
// K1 (sg_rulebook_conv) reads nbr from a (K, V_out) int32 rulebook; it
// replaces softgroup_tpu/ops/conv_kernel.py:_conv_kernel (driven by
// _windowed_conv_core).  K4 (sg_keyed_conv) resolves nbr inside the kernel by
// search of the output voxel's neighbour key in the sorted input key table;
// it replaces conv_kernel.py:_keyed_kernel (keyed_windowed_conv).
// No (K, V) rulebook is ever written for K4.  K5 (sg_conv_dw) is the weight
// gradient of K1's conv (below).
//
// Bound on the H100 at the backbone's shapes: the FLOPs of the taps that
// hit (2 * hits * Cin * Cout) against the bytes of one read of feats, W,
// the rules and one write of the output; at 32-384 channels that is bytes,
// and the rulebook (27 x 4 B a voxel) is about half of them at 32 channels.
// The gathered rows come from L2 (feats is a few MB) and a surface tile of
// 64 voxels hits ~24 of the 27 taps with only ~1/4 of its rows each, so a
// kernel loses its time to latency (rules, then gathers, then MMAs, each
// waiting on the one before) and to MMAs on rows that miss.  The
// submanifold convs therefore run on a row order (``rows``, built on the
// card from the rulebooks by sparse_conv.hit_orders): each level's rows
// sorted stably by their 27-bit hit mask, so that a tile's rows share their
// taps (a train-batch L0 tile: 9 taps, half its rows hitting each, in place
// of 24 taps at a fifth).  K1 reads the grouped rulebook rules[:, rows] as
// any other and its epilogue writes tile row i to output row rows[i].
//
// K1, bf16 (rulebook_conv_tc, the serving and training paths): a pipelined
// gather-GEMM.  A block owns BM = 64 output rows x BN (32 or 64) channels.
//   * Rules up front: its prologue reads the tile's whole (K, 64) rule slab
//     (each warp its own taps, all loads in flight at once, 128 contiguous
//     bytes each), and a warp vote per tap gives the mask of taps with any
//     hit: one barrier in place of a dependent rule load and a block vote
//     per tap.
//   * The product's K dimension is the hit taps' channels, cut in pieces
//     (one tap, 32 channels; 16 when Cin <= 16).  A step takes 32 channels
//     of pieces, walked through a ring of 3 dynamic shared-memory stages
//     (31 or 37 KB with the rule slab): the gathered feats rows and W's
//     matching rows arrive by cp.async (16-byte copies; 4-byte copies or
//     plain loads where the widths do not allow 16; rows that miss and
//     ragged channels are zeroed by shared-memory stores, and a thread
//     remembers which of its slots hold zeros already), so the copies of
//     steps s+1 and s+2 are in flight during the MMA of step s, with one
//     wait and one barrier a step.  Hopper's TMA has no row gather;
//     cp.async is the tool.  What hides the latency best is blocks: 6-7
//     of them share an SM, where deeper rings or 64-channel steps (fewer
//     blocks) ran slower at every level.
//   * Tensor cores by mma.sync m16n8k16 (bf16 -> f32) fed by ldmatrix from
//     rows padded by 16 bytes (conflict-free): four warps, 16 rows each.  A
//     warp skips the MMAs of a piece in which none of its 16 rows hits (a
//     vote at issue time).  wgmma would run the MMAs faster but only on
//     64-row groups, so no strip could skip its own, and its asynchronous
//     groups and descriptors add a fence per step to a step that is
//     already short; mma.sync keeps the step simple.
//   * Epilogue from registers: the f32 sums are rounded once to bf16, and a
//     quad of lanes swaps words so that each lane stores 16 bytes.
//   * Deep levels (few tiles): ``split`` blocks per tile cut the step list
//     (not the tap range) into equal parts; each writes an f32 slab that
//     sum_partials adds in slab order (deterministic, no atomics).
// K4, bf16 (the serving path's refinement U-Net): K1's kernel with another
// prologue.  rulebook_conv_tc takes its neighbour source as a template: a
// rulebook slab (RuleSlab, K1) or keys (KeyedSlab, K4).  K4's prologue
// resolves the tile's whole (K, 64) slab by search of sorted keys: each
// thread's 16 (tap, row) searches advance in lockstep, a branch-free
// quarter cut each a round (three probes, 48 loads in flight); a subm
// search spans only the |key offset| rows around its own row (one key
// table on both sides), 5 rounds on the D=20 grid, 8 over a 65536-key
// table.  The ring, tap mask and epilogue are K1's, and so is the split of
// a tile's step list (for a smaller grid: K4's padded rows make a split's
// slabs cost more than it gains).
// K1 and K4, f32 (the small card-vs-CPU checks only) stay on the CUDA-core
// FMA kernel gather_gemm (no TF32): per tap a block fetches its 64
// neighbours, skips the tap when all miss, and accumulates the gathered
// rows times W's chunk, two barriers a 32-channel chunk.
//
// K5 (sg_conv_dw), the weight gradient dW[k] = sum_v feats[rules[k, v]]^T
// g[v], replaces conv_kernel.py:_dw_kernel (windowed_conv_dw).  Its bound is
// the same bytes (feats, g, the rules, the f32 dW once); what held PR 2's
// kernel far above it was K1's old shape (a dependent rule load, a block
// vote, plain loads and two barriers around every 64-row chunk), g read
// once per tap, and, on ragged channel tiles (96, 160, 224, the 6-channel
// input), loads of one element at a time.  bf16 (conv_dw_tc):
//   * a block owns a (BI x BJ) tile of (Cin, Cout) (32 or 64 each), a group
//     of G taps (3; 1 for a rulebook of few steps, the deep levels, whose
//     one-tap blocks run four to an SM) and every split-th step of 32
//     rulebook rows (dealt round-robin: a capacity's padded tail, which
//     misses every tap, is spread over all blocks), each block writing an
//     f32 slab that sum_partials adds in slab order (deterministic, no
//     atomics);
//   * a ring by cp.async, 16 bytes a copy (the wrapper pads rows to 8
//     channels): the rule rows of step s + 4 (5 small stages), the gathered
//     feats rows of each tap and the g rows of step s + 2 (3 stages), step
//     s in the MMAs; one wait and one barrier a step.  g rows are read once
//     for the G taps, and not at all where every tap of the group misses;
//     rows that miss and ragged channels are zeroed by stores, once a slot;
//   * mma.sync m16n8k16 of A^T B (A: the gathered rows, read transposed by
//     ldmatrix.trans; B: the g rows): four warps, each a quarter of the
//     tile, G f32 accumulators a thread in registers; a warp vote skips a
//     tap's MMAs on a 16-row piece with no hit.
//   The MMAs still run on 16-row pieces of which ~3/4 of the rows miss:
//   they are the largest part of the step.  Packing each tap's hits into
//   dense pieces (A and g rows gathered together) ran slower: it gives up
//   g's reuse across the group and adds a per-row placement.
// f32 (conv_dw_fma, the small checks only): one tap a block, 64-row chunks,
// CUDA-core FMA.  Any Cin / Cout works in every kernel (ragged channels are
// zero-filled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BK = 32;   // input channels per chunk
constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int TM = BM / 16;

__device__ __forceinline__ int lower_bound(const int* a, int n, int q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// neighbour of output row v at tap k, from an explicit rulebook
struct RulebookTaps {
  const int* rules;
  int ld;            // row stride of the rulebook (>= v_out)
  const int* rows;   // output row of rulebook column v (null: v itself)
  __device__ int operator()(int k, int v) const {
    return rules[(size_t)k * ld + v];
  }
  __device__ int out_row(int v) const { return rows ? __ldg(rows + v) : v; }
};

// neighbour of output row v at tap k, from sorted linear keys
// ((b*D + x)*D + y)*D + z on the proposal grid (conv_kernel.py:848-871)
struct KeyedTaps {
  const int* out_keys;
  const int* in_keys;
  int v_in, d, strided;
  __device__ int operator()(int k, int v) const {
    const int key = out_keys[v];
    if (key < 0 || key == INT_MAX) return -1;
    const int z = key % d, y = (key / d) % d, x = (key / (d * d)) % d;
    const int b = key / (d * d * d);
    int q;
    if (strided) {  // coarse output, fine children 2*coord + (dx, dy, dz)
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1, df = 2 * d;
      q = ((b * df + 2 * x + dx) * df + 2 * y + dy) * df + 2 * z + dz;
    } else {  // tap index (dx+1)*9 + (dy+1)*3 + (dz+1)
      const int dx = k / 9 - 1, dy = (k / 3) % 3 - 1, dz = k % 3 - 1;
      if (x + dx < 0 || x + dx >= d || y + dy < 0 || y + dy >= d ||
          z + dz < 0 || z + dz >= d)
        return -1;
      q = key + (dx * d + dy) * d + dz;
    }
    const int p = lower_bound(in_keys, v_in, q);
    return (p < v_in && in_keys[p] == q) ? p : -1;
  }
  __device__ int out_row(int v) const { return v; }
};

// f32 variant: CUDA-core FMA on a 4 x (BN/16) micro-tile per thread
template <int BN, typename Taps>
__global__ void __launch_bounds__(NT)
gather_gemm(const float* __restrict__ feats, const float* __restrict__ w,
            Taps taps, int n_taps, int kt, int v_out, int cin, int cout,
            float* __restrict__ out) {
  constexpr int TN = BN / 16;
  __shared__ int rule_s[BM];
  __shared__ float a_s[BK][BM + 1];  // gathered rows, channel-major
  __shared__ float b_s[BK][BN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int k_end = min(n_taps, (int)(blockIdx.z + 1) * kt);
  for (int k = blockIdx.z * kt; k < k_end; ++k) {
    int hit = 0;
    if (tid < BM) {
      const int v = row0 + tid;
      const int r = v < v_out ? taps(k, v) : -1;
      rule_s[tid] = r;
      hit = r >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // block-uniform
    for (int c0 = 0; c0 < cin; c0 += BK) {
      for (int i = tid; i < BM * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const int src = rule_s[r];
        float val = 0.f;
        if (src >= 0 && c0 + c < cin)
          val = feats[(size_t)src * cin + c0 + c];
        a_s[c][r] = val;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int c = i / BN, n = i % BN;
        float val = 0.f;
        if (c0 + c < cin && col0 + n < cout)
          val = w[((size_t)k * cin + c0 + c) * cout + col0 + n];
        b_s[c][n] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_s[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= v_out) continue;
    const int orow = taps.out_row(row);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < cout)
        out[((size_t)blockIdx.z * v_out + orow) * cout + col] = acc[i][j];
    }
  }
}

// out = sum over the split's f32 partial slabs, in slab order
template <typename T>
__global__ void sum_partials(const float* __restrict__ partial, int split,
                             long long n, T* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < split; ++z) s += partial[(long long)z * n + i];
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      out[i] = __float2bfloat16_rn(s);
    else
      out[i] = s;
  }
}

// the f32 kernel (K1 and K4): split > 1 spreads the taps over split blocks
// per tile (grid.z), each writing an f32 partial slab of ``partial``
// (split, v_out, cout) that a second kernel sums: the deep levels otherwise
// launch too few blocks to fill the card.  split == 1 writes ``out``.
template <typename Taps>
int launch_fma(const void* feats, const void* w, Taps taps, int n_taps,
               int v_out, int cin, int cout, void* out, int split,
               float* partial, cudaStream_t stream) {
  if (v_out <= 0 || cout <= 0) return (int)cudaGetLastError();
  if (split < 1 || split > n_taps || (split > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  const int kt = (n_taps + split - 1) / split;
  const float* f = (const float*)feats;
  const float* wt = (const float*)w;
  float* o = split > 1 ? partial : (float*)out;
  if (cout <= 32)
    gather_gemm<32, Taps>
        <<<dim3((v_out + BM - 1) / BM, (cout + 31) / 32, split), NT, 0,
            stream>>>(f, wt, taps, n_taps, kt, v_out, cin, cout, o);
  else
    gather_gemm<64, Taps>
        <<<dim3((v_out + BM - 1) / BM, (cout + 63) / 64, split), NT, 0,
            stream>>>(f, wt, taps, n_taps, kt, v_out, cin, cout, o);
  if (split > 1) {
    const long long n = (long long)v_out * cout;
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    sum_partials<float><<<(unsigned)blocks, 256, 0, stream>>>(
        partial, split, n, (float*)out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1, bf16: the pipelined gather-GEMM (design note at the top of the file)
constexpr int K1_NT = 128;       // 4 warps, 16 output rows each
constexpr int K1_STAGES = 3;     // shared-memory ring depth
constexpr int K1_BK = 32;        // gathered channels a step
constexpr int K1_MAX_TAPS = 32;  // the hit-tap mask is one 32-bit word
constexpr int K1_PAD = 8;        // bf16 of row padding: 16 bytes, so the 8
                                 // rows of an ldmatrix hit 8 bank groups

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// cp.async of 16 / 4 bytes (the .ca form: cached in L1 as well as L2)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Copy modes of an operand: 16 = 16-byte cp.async, 4 = 4-byte cp.async,
// 2 = plain loads and stores (odd widths or unaligned data).
inline int copy_mode(const void* p, int width) {
  const uintptr_t a = (uintptr_t)p;
  if (width % 8 == 0 && a % 16 == 0) return 16;
  if (width % 2 == 0 && a % 4 == 0) return 4;
  return 2;
}

// the layout of a K1 block's dynamic shared memory, in bytes
template <int BN>
struct K1Smem {
  static constexpr int A_LD = K1_BK + K1_PAD, B_LD = BN + K1_PAD;
  static constexpr int A = K1_STAGES * BM * A_LD * 2;      // gathered rows
  static constexpr int B = K1_STAGES * K1_BK * B_LD * 2;   // W's rows
  static constexpr int R = K1_MAX_TAPS * BM * 4;           // rule slab
  static constexpr int BYTES = A + B + R + K1_MAX_TAPS * 4;  // + hit flags
};

// x[i] for a small array and an index known only at run time, without
// moving the array to local memory
template <int N>
__device__ __forceinline__ int pick(const int (&x)[N], int i) {
  int v = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? x[j] : v;
  return v;
}

// K1's neighbour source: the (K, ld) int32 rulebook.  ``fill`` gives a
// thread its slots of the tile's rule slab: rv[q][h] = rule of tap
// warp + 4q, row row0 + lane + 32h (-1 past the taps or the rows).
// ``out_row``: where the epilogue writes tile row v (``rows``: a row order,
// the rulebook's columns grouped by hit mask; null: in place).
struct RuleSlab {
  const int* rules;
  int ld;            // row stride of the rulebook (>= v_out)
  const int* rows;   // (v_out,) output row of each column, or null
  __device__ __forceinline__ int out_row(int v) const {
    return rows ? __ldg(rows + v) : v;
  }
  template <int TPW, int RPL>
  __device__ __forceinline__ void fill(int (&rv)[TPW][RPL], int warp,
                                       int lane, int row0, int n_taps,
                                       int v_out) const {
#pragma unroll
    for (int q = 0; q < TPW; ++q)
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        const int k = warp + q * (K1_NT / 32), r = lane + 32 * h;
        rv[q][h] = k < n_taps && row0 + r < v_out
                       ? __ldg(rules + (size_t)k * ld + row0 + r) : -1;
      }
  }
};

// K4's neighbour source: sorted int32 keys ((b*D + x)*D + y)*D + z on the
// proposal grid (INT_MAX padded; a negative key is no voxel), the slab
// resolved by search (the rules of rules_from_keys in conv_kernel.py).  A
// thread's 16 searches advance in lockstep, each round a branch-free
// quarter cut of every search's range (three probes, all of the round's
// loads in flight together): 8 rounds over 65536 keys.  Subm (out_keys is
// in_keys, ``same``): the neighbour of row v at key offset delta lies
// within |delta| rows of v (the keys are sorted and unique), so a search
// spans |delta| rows (<= D^2 + D + 1), not the table.
struct KeyedSlab {
  const int* out_keys;
  const int* in_keys;
  int v_in, d, strided, same;
  template <int TPW, int RPL>
  __device__ __forceinline__ void fill(int (&rv)[TPW][RPL], int warp,
                                       int lane, int row0, int n_taps,
                                       int v_out) const {
    // key < 0: no search (the slot misses); base / len: the search's rows
    int base[TPW][RPL], len[TPW][RPL], key[TPW][RPL], own[RPL];
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      const int v = row0 + lane + 32 * h;
      own[h] = v < v_out ? __ldg(out_keys + v) : -1;
    }
    int most = 1;  // the longest search of this thread
#pragma unroll
    for (int q = 0; q < TPW; ++q)
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        const int k = warp + q * (K1_NT / 32), v = row0 + lane + 32 * h;
        base[q][h] = 0;
        len[q][h] = 1;
        key[q][h] = -1;
        const int kv = own[h];
        if (k >= n_taps || kv < 0 || kv == INT_MAX || v_in <= 0) continue;
        const int z = kv % d, y = (kv / d) % d, x = (kv / (d * d)) % d;
        const int b = kv / (d * d * d);
        int qk;
        if (strided) {  // coarse output, fine children 2*coord + (dx, dy, dz)
          const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1, df = 2 * d;
          qk = ((b * df + 2 * x + dx) * df + 2 * y + dy) * df + 2 * z + dz;
        } else {  // tap index (dx+1)*9 + (dy+1)*3 + (dz+1)
          const int dx = k / 9 - 1, dy = (k / 3) % 3 - 1, dz = k % 3 - 1;
          if (x + dx < 0 || x + dx >= d || y + dy < 0 || y + dy >= d ||
              z + dz < 0 || z + dz >= d)
            continue;
          qk = kv + (dx * d + dy) * d + dz;
        }
        int lo = 0, hi = v_in - 1;  // the search's rows, inclusive
        if (same && !strided) {
          const int delta = qk - kv;
          lo = delta > 0 ? v + 1 : max(v + delta, 0);
          hi = delta > 0 ? min(v + delta, v_in - 1) : delta < 0 ? v - 1 : v;
          if (hi < lo) continue;
        }
        base[q][h] = lo;
        len[q][h] = hi - lo + 1;
        key[q][h] = qk;
        most = max(most, len[q][h]);
      }
    // lower bound of the key in its rows: it stays in [base, base + len];
    // a round probes the quarter points and keeps the quarter that holds
    // it.  A slot whose len reached 1 (or that has no search) probes its
    // base, harmlessly.
    for (int n = most; n > 1; n = (n + 3) >> 2) {
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        if (warp + q * (K1_NT / 32) >= n_taps) break;  // warp-uniform
#pragma unroll
        for (int h = 0; h < RPL; ++h) {
          const int l = len[q][h], q1 = l >> 2, q2 = l >> 1;
          const int q3 = l - ((l + 3) >> 2);
          const int* a = in_keys + base[q][h];
          const bool c1 = __ldg(a + q1) < key[q][h];
          const bool c2 = __ldg(a + q2) < key[q][h];
          const bool c3 = __ldg(a + q3) < key[q][h];
          base[q][h] += c3 ? q3 : c2 ? q2 : c1 ? q1 : 0;
          len[q][h] = c3 ? l - q3 : c2 ? q3 - q2 : c1 ? q2 - q1 : q1;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TPW; ++q)
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        rv[q][h] = -1;
        if (warp + q * (K1_NT / 32) >= n_taps || key[q][h] < 0) continue;
        // the lower bound is base or base + 1; the keys are unique, so a
        // match there is the neighbour
        int p = base[q][h];
        p += __ldg(in_keys + p) < key[q][h];
        if (p < v_in && __ldg(in_keys + p) == key[q][h]) rv[q][h] = p;
      }
  }
  __device__ __forceinline__ int out_row(int v) const { return v; }
};

// feats (V_in, cin), w (K, cin, cout) and the neighbour source (a rulebook
// or keys) -> out (v_out, cout) bf16, or with gridDim.z > 1 the f32 slab z
// of partial (split, v_out, cout).  Grid (tiles of BM rows, tiles of BN
// columns, split).  The K dimension of the tile's product is the hit taps'
// channels, cut in pieces (one tap, PW channels); a step takes P = K1_BK /
// PW pieces.
template <int BN, int PW, typename Src>
__global__ void __launch_bounds__(K1_NT)
rulebook_conv_tc(const __nv_bfloat16* __restrict__ feats,
                 const __nv_bfloat16* __restrict__ w, Src src, int n_taps,
                 int v_out, int cin, int cout, int amode, int bmode,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ partial) {
  using L = K1Smem<BN>;
  constexpr int NW = K1_NT / 32, NJ = BN / 8, P = K1_BK / PW;
  extern __shared__ __align__(128) unsigned char k1_smem[];
  auto a_s = reinterpret_cast<__nv_bfloat16(*)[BM][L::A_LD]>(k1_smem);
  auto b_s =
      reinterpret_cast<__nv_bfloat16(*)[K1_BK][L::B_LD]>(k1_smem + L::A);
  auto rule_s = reinterpret_cast<int(*)[BM]>(k1_smem + L::A + L::B);
  int* hit_s = reinterpret_cast<int*>(k1_smem + L::A + L::B + L::R);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // prologue: the tile's rule slab (warp w holds taps w, w + 4, ...: all
  // its loads in flight at once), and which taps hit any of its rows
  constexpr int TPW = K1_MAX_TAPS / NW, RPL = BM / 32;
  int rv[TPW][RPL];
  src.fill(rv, warp, lane, row0, n_taps, v_out);
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int k = warp + q * NW;
    if (k >= n_taps) break;  // warp-uniform
    int hit = 0;
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      rule_s[k][lane + 32 * h] = rv[q][h];
      hit |= rv[q][h] >= 0;
    }
    hit = __any_sync(0xffffffffu, hit);
    if (lane == 0) hit_s[k] = hit;
  }
  __syncthreads();
  const unsigned taps =
      __ballot_sync(0xffffffffu, lane < n_taps && hit_s[lane]);
  const int n_chunks = (cin + PW - 1) / PW;  // pieces a hit tap
  const int n_pieces = __popc(taps) * n_chunks;
  const int n_steps = (n_pieces + P - 1) / P;
  const int s_begin = (int)((long long)n_steps * blockIdx.z / gridDim.z);
  const int s_end = (int)((long long)n_steps * (blockIdx.z + 1) / gridDim.z);

  // the issue cursor over pieces: a piece's tap is the lowest set bit of
  // ``rest``, its channels start at chunk * PW
  int piece = s_begin * P;
  unsigned rest = taps;
  int chunk = piece % n_chunks;
  for (int h = piece / n_chunks; h > 0; --h) rest &= rest - 1;
  int s_issue = s_begin;
  // bit stage * P + q: this warp's 16 rows hit something in piece q of the
  // step in that stage (else the warp skips the piece's MMA)
  unsigned strip = 0;
  // the 16- and 4-byte copy modes give a thread the same A slots (row,
  // column) in every step: bit stage * (slots a stage) + slot says that
  // this thread's slot of that stage holds zeros, so a row that misses
  // again is not zeroed again (3/4 of a surface tile's rows miss a tap)
  unsigned long long zeroed = 0;
  static_assert(K1_STAGES * BM / (K1_NT / (K1_BK / 2)) <= 64,
                "one bit a slot");

  auto issue = [&](int stage) {
    if (s_issue < s_end) {
      int pk[P], pc[P];  // each piece's tap (-1 past the end), channel 0
      unsigned bits = 0;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        pk[q] = -1;
        pc[q] = cin;  // past the end: every channel out of range, zeros
        if (piece < n_pieces) {
          pk[q] = __ffs(rest) - 1;
          pc[q] = chunk * PW;
          if (++chunk == n_chunks) {
            chunk = 0;
            rest &= rest - 1;
          }
          ++piece;
          const int r = rule_s[pk[q]][warp * 16 + (lane & 15)];
          bits |= (__ballot_sync(0xffffffffu, r >= 0) ? 1u : 0u) << q;
        }
      }
      strip = (strip & ~(((1u << P) - 1) << (stage * P))) |
              (bits << (stage * P));
      // A: the BM gathered rows; a thread keeps one column slot, so one
      // piece, and a row that misses is zeroed by a store, not a copy
      if (amode == 16) {
        constexpr int V = K1_BK / 8, RI = K1_NT / V;
        const int c = (tid % V) * 8, q = c / PW;
        const int k = pick(pk, q), col = pick(pc, q) + c % PW;
        const int* rk = rule_s[k < 0 ? 0 : k];
#pragma unroll
        for (int it = 0; it < BM / RI; ++it) {
          const int r = tid / V + it * RI, src = rk[r];
          const unsigned long long bit = 1ull << (stage * (BM / RI) + it);
          if (src >= 0 && col < cin) {
            cp_async16(&a_s[stage][r][c], feats + (size_t)src * cin + col);
            zeroed &= ~bit;
          } else if (!(zeroed & bit)) {
            *reinterpret_cast<uint4*>(&a_s[stage][r][c]) = uint4{0, 0, 0, 0};
            zeroed |= bit;
          }
        }
      } else if (amode == 4) {
        constexpr int V = K1_BK / 2, RI = K1_NT / V;
        const int c = (tid % V) * 2, q = c / PW;
        const int k = pick(pk, q), col = pick(pc, q) + c % PW;
        const int* rk = rule_s[k < 0 ? 0 : k];
#pragma unroll
        for (int it = 0; it < BM / RI; ++it) {
          const int r = tid / V + it * RI, src = rk[r];
          const unsigned long long bit = 1ull << (stage * (BM / RI) + it);
          if (src >= 0 && col < cin) {
            cp_async4(&a_s[stage][r][c], feats + (size_t)src * cin + col);
            zeroed &= ~bit;
          } else if (!(zeroed & bit)) {
            *reinterpret_cast<unsigned*>(&a_s[stage][r][c]) = 0u;
            zeroed |= bit;
          }
        }
      } else {
        constexpr int RI = K1_NT / K1_BK;
        const int c = tid % K1_BK, q = c / PW;
        const int k = pick(pk, q), col = pick(pc, q) + c % PW;
        const int* rk = rule_s[k < 0 ? 0 : k];
        for (int it = 0; it < BM / RI; ++it) {
          const int r = tid / K1_BK + it * RI, src = rk[r];
          a_s[stage][r][c] = src >= 0 && col < cin
                                 ? feats[(size_t)src * cin + col] : zero;
        }
      }
      // B: row c of the stage is row pc[c / PW] + c % PW of W[pk[c / PW]],
      // columns col0 .. col0 + BN
      if (bmode == 16) {
        constexpr int V = BN / 8, RI = K1_NT / V;
        const int n = (tid % V) * 8;
#pragma unroll
        for (int it = 0; it < K1_BK / RI; ++it) {
          const int c = tid / V + it * RI, q = c / PW;
          const int k = pick(pk, q), row = pick(pc, q) + c % PW;
          if (row < cin && col0 + n < cout)
            cp_async16(&b_s[stage][c][n],
                       w + ((size_t)k * cin + row) * cout + col0 + n);
          else
            *reinterpret_cast<uint4*>(&b_s[stage][c][n]) = uint4{0, 0, 0, 0};
        }
      } else if (bmode == 4) {
        constexpr int V = BN / 2, RI = K1_NT / V;
        const int n = (tid % V) * 2;
#pragma unroll 4
        for (int it = 0; it < K1_BK / RI; ++it) {
          const int c = tid / V + it * RI, q = c / PW;
          const int k = pick(pk, q), row = pick(pc, q) + c % PW;
          if (row < cin && col0 + n < cout)
            cp_async4(&b_s[stage][c][n],
                      w + ((size_t)k * cin + row) * cout + col0 + n);
          else
            *reinterpret_cast<unsigned*>(&b_s[stage][c][n]) = 0u;
        }
      } else {
        for (int i = tid; i < K1_BK * BN; i += K1_NT) {
          const int c = i / BN, n = i % BN, q = c / PW;
          const int k = pick(pk, q), row = pick(pc, q) + c % PW;
          b_s[stage][c][n] = row < cin && col0 + n < cout
                                 ? w[((size_t)k * cin + row) * cout + col0 + n]
                                 : zero;
        }
      }
    }
    ++s_issue;
    cp_async_commit();  // one group a step, empty past the end
  };

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < K1_STAGES - 1; ++st) issue(st);
  for (int s = s_begin; s < s_end; ++s) {
    const int i = s - s_begin, st = i % K1_STAGES;
    cp_async_wait<K1_STAGES - 2>();  // this thread's copies of step s landed
    __syncthreads();  // everyone's landed; everyone is done with step s - 1
    const unsigned live = strip >> (st * P);  // before the issue reuses bits
    issue((i + K1_STAGES - 1) % K1_STAGES);  // into step s - 1's stage
    // lanes 0-15 address rows 0-15 at column kk, lanes 16-31 at kk + 8:
    // the four 8x8 matrices of the m16n8k16 A fragment, and for B (read
    // transposed) the k-halves of n-tiles j and j + 1
    const int r16 = lane & 15, c8 = (lane >> 4) * 8;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (!((live >> q) & 1u)) continue;  // warp-uniform: all 16 rows miss
#pragma unroll
      for (int kk = q * PW; kk < (q + 1) * PW; kk += 16) {
        unsigned a[4];
        ldmatrix_x4(a, &a_s[st][warp * 16 + r16][kk + c8]);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, &b_s[st][kk + r16][j * 8 + c8]);
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: lane (g, t) of the warp holds rows g and g + 8 of its strip,
  // columns 8j + 2t and 8j + 2t + 1 of every n-tile j
  const int g = lane >> 2, t = lane & 3;
  const bool vec = partial == nullptr && cout % 8 == 0 &&
                   col0 + BN <= cout && (uintptr_t)out % 16 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + g + half * 8;
    const int orow = row < v_out ? src.out_row(row) : row;  // its output row
    if (vec) {
      // 4 n-tiles at a time: lane t collects n-tile q0 + t's 8 columns
      // (one bf16 pair from each lane of its quad) and stores 16 bytes
#pragma unroll
      for (int q0 = 0; q0 < NJ; q0 += 4) {
        unsigned wd[4], o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wd[q] = pack_bf16(acc[q0 + q][2 * half], acc[q0 + q][2 * half + 1]);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int give = (t + s) & 3, from = (t - s) & 3;
          const unsigned offer = give == 0 ? wd[0] : give == 1 ? wd[1]
                                 : give == 2 ? wd[2] : wd[3];
          const unsigned got =
              __shfl_sync(0xffffffffu, offer, (lane & ~3) | from);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (p == from) o[p] = got;
        }
        if (row < v_out)
          *reinterpret_cast<uint4*>(out + (size_t)orow * cout + col0 +
                                    (q0 + t) * 8) =
              make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else if (row < v_out) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + j * 8 + 2 * t + e;
          const float v = acc[j][2 * half + e];
          if (col >= cout) continue;
          if (partial)
            partial[((size_t)blockIdx.z * v_out + orow) * cout + col] = v;
          else
            out[(size_t)orow * cout + col] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

template <int BN, int PW, typename Src>
int launch_k1_tile(const void* feats, const void* w, Src src, int n_taps,
                   int v_out, int cin, int cout, int split, void* out,
                   float* part, cudaStream_t stream) {
  constexpr int bytes = K1Smem<BN>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      rulebook_conv_tc<BN, PW, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((v_out + BM - 1) / BM, (cout + BN - 1) / BN, split);
  rulebook_conv_tc<BN, PW, Src><<<grid, K1_NT, bytes, stream>>>(
      (const __nv_bfloat16*)feats, (const __nv_bfloat16*)w, src, n_taps,
      v_out, cin, cout, copy_mode(feats, cin), copy_mode(w, cout),
      (__nv_bfloat16*)out, part);
  return (int)cudaSuccess;
}

// pieces of 16 channels when Cin <= 16 (the input conv: two taps a step),
// else 32
template <int BN, typename Src>
int launch_k1_cols(const void* feats, const void* w, Src src, int n_taps,
                   int v_out, int cin, int cout, int split, void* out,
                   float* part, cudaStream_t stream) {
  if (cin <= 16)
    return launch_k1_tile<BN, 16>(feats, w, src, n_taps, v_out, cin, cout,
                                  split, out, part, stream);
  return launch_k1_tile<BN, 32>(feats, w, src, n_taps, v_out, cin, cout,
                                split, out, part, stream);
}

template <typename Src>
int launch_k1_bf16(const void* feats, const void* w, Src src, int n_taps,
                   int v_out, int cin, int cout, void* out, int split,
                   float* partial, cudaStream_t stream) {
  if (v_out <= 0 || cout <= 0) return (int)cudaGetLastError();
  if (n_taps < 1 || n_taps > K1_MAX_TAPS || split < 1 || split > 65535 ||
      (split > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  float* part = split > 1 ? partial : nullptr;
  const int rc =
      cout <= 32 ? launch_k1_cols<32>(feats, w, src, n_taps, v_out, cin,
                                      cout, split, out, part, stream)
                 : launch_k1_cols<64>(feats, w, src, n_taps, v_out, cin,
                                      cout, split, out, part, stream);
  if (rc != (int)cudaSuccess) return rc;
  if (part) {
    const long long n = (long long)v_out * cout;
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    sum_partials<__nv_bfloat16><<<(unsigned)blocks, 256, 0, stream>>>(
        part, split, n, (__nv_bfloat16*)out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: weight gradient of the rulebook conv (sg_conv_dw); design note at the
// top of the file.
//
//   dW[k, i, j] = sum_v feats[rules[k, v], i] * g[v, j]      (-1 adds 0)
constexpr int DW_NT = 128;     // 4 warps, 2 x 2 over the (BI, BJ) tile
// blocks an SM the registers must allow: one-tap blocks are small, and
// deep levels (few steps) run them four to an SM
constexpr int dw_min_blocks(int g) { return g == 1 ? 4 : 1; }
constexpr int DW_STAGES = 3;   // ring of gathered rows: copies S - 1 ahead
constexpr int DW_RSTAGES = 2 * DW_STAGES - 1;  // rule rows: 2S - 2 ahead
constexpr int DW_BV = 32;      // rulebook rows a step (the products' K)
constexpr int DW_PAD = 8;      // bf16 of row padding (conflict-free ldmatrix)
static_assert(DW_BV % 32 == 0, "a step is whole warps of rows");

// the layout of a K5 block's dynamic shared memory, in bytes
template <int BI, int BJ, int G>
struct DwSmem {
  static constexpr int A_LD = BI + DW_PAD, B_LD = BJ + DW_PAD;
  static constexpr int A = DW_STAGES * G * DW_BV * A_LD * 2;  // feats rows
  static constexpr int B = DW_STAGES * DW_BV * B_LD * 2;      // g rows
  static constexpr int R = DW_RSTAGES * G * DW_BV * 4;        // rule rows
  static constexpr int BYTES = A + B + R;
};

// feats (V_in, lda), g (v_out, ldb) bf16 (16-byte aligned, lda and ldb
// multiples of 8, the channels past cin / cout zero), rules (K, v_out)
// int32 -> the f32 (K, cin, cout) slab blockIdx.z of out.  Grid (tiles of
// BI x BJ of (cin, cout), groups of G taps, split): block z walks steps z,
// z + split, z + 2 split, ... of DW_BV rows, so that the blocks share the
// rows that hit evenly (a capacity's padded tail misses every tap).  rmode:
// 16- or 4-byte copies of the rule rows.
template <int BI, int BJ, int G>
__global__ void __launch_bounds__(DW_NT, dw_min_blocks(G))
conv_dw_tc(const __nv_bfloat16* __restrict__ feats, int lda,
           const __nv_bfloat16* __restrict__ g, int ldb,
           const int* __restrict__ rules, int n_taps, int v_out, int cin,
           int cout, int rmode, float* __restrict__ out) {
  using L = DwSmem<BI, BJ, G>;
  constexpr int WI = BI / 2, WJ = BJ / 2;  // a warp's part of the tile
  constexpr int MI = WI / 16, NJ = WJ / 8;
  constexpr int ASL = G * DW_BV * (BI / 8) / DW_NT;  // 16-byte A slots
  constexpr int BSL = DW_BV * (BJ / 8) / DW_NT;      // and B slots a thread
  // one bit a slot of every stage, where 64 bits hold them
  constexpr bool TRACK = DW_STAGES * (ASL + BSL) <= 64;
  constexpr int HALVES = DW_BV / 16;  // 16-row pieces of a step
  extern __shared__ __align__(128) unsigned char dw_smem[];
  auto a_s = reinterpret_cast<__nv_bfloat16(*)[G][DW_BV][L::A_LD]>(dw_smem);
  auto b_s =
      reinterpret_cast<__nv_bfloat16(*)[DW_BV][L::B_LD]>(dw_smem + L::A);
  auto rule_s = reinterpret_cast<int(*)[G][DW_BV]>(dw_smem + L::A + L::B);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tj = (cout + BJ - 1) / BJ;
  const int i0 = (blockIdx.x / n_tj) * BI, j0 = (blockIdx.x % n_tj) * BJ;
  const int k0 = blockIdx.y * G;
  const int split = gridDim.z;
  const int n =
      ((v_out + DW_BV - 1) / DW_BV - (int)blockIdx.z + split - 1) / split;

  // rules of step i into its rule stage (-1 past the taps or the rows)
  auto issue_rules = [&](int i) {
    if (i >= n) return;
    const int v0 = (blockIdx.z + i * split) * DW_BV;
    int(*rs)[DW_BV] = rule_s[i % DW_RSTAGES];
    if (rmode == 16 && v0 + DW_BV <= v_out) {
      for (int p = tid; p < G * (DW_BV / 4); p += DW_NT) {
        const int t = p / (DW_BV / 4), c = (p % (DW_BV / 4)) * 4;
        if (k0 + t < n_taps)
          cp_async16(&rs[t][c], rules + (size_t)(k0 + t) * v_out + v0 + c);
        else
          *reinterpret_cast<int4*>(&rs[t][c]) = make_int4(-1, -1, -1, -1);
      }
    } else {
      for (int p = tid; p < G * DW_BV; p += DW_NT) {
        const int t = p / DW_BV, r = p % DW_BV;
        if (k0 + t < n_taps && v0 + r < v_out)
          cp_async4(&rs[t][r], rules + (size_t)(k0 + t) * v_out + v0 + r);
        else
          rs[t][r] = -1;
      }
    }
  };

  // bit stage * ASL + it (A) or DW_STAGES * ASL + stage * BSL + it (B):
  // this thread's 16-byte slot holds zeros, so a row that misses again is
  // not zeroed again
  unsigned long long zeroed = 0;
  // the gathered feats rows of each tap and the g rows of step i (its rules
  // landed), 16 bytes a copy: rows that miss, or that miss every tap of the
  // group (g), and channels past the row are zeroed by stores
  auto issue_rows = [&](int i) {
    if (i >= n) return;
    const int v0 = (blockIdx.z + i * split) * DW_BV, st = i % DW_STAGES;
    const int(*rs)[DW_BV] = rule_s[i % DW_RSTAGES];
    constexpr int V = BI / 8;
#pragma unroll
    for (int it = 0; it < ASL; ++it) {
      const int q = tid + it * DW_NT;
      const int t = q / (DW_BV * V), r = (q / V) % DW_BV, c = (q % V) * 8;
      const int src = rs[t][r];
      const unsigned long long bit = TRACK ? 1ull << (st * ASL + it) : 0ull;
      if (src >= 0 && i0 + c < lda) {
        cp_async16(&a_s[st][t][r][c], feats + (size_t)src * lda + i0 + c);
        zeroed &= ~bit;
      } else if (!(zeroed & bit) || !TRACK) {
        *reinterpret_cast<uint4*>(&a_s[st][t][r][c]) = uint4{0, 0, 0, 0};
        zeroed |= bit;
      }
    }
    constexpr int W = BJ / 8;
#pragma unroll
    for (int it = 0; it < BSL; ++it) {
      const int q = tid + it * DW_NT, r = q / W, c = (q % W) * 8;
      const unsigned long long bit =
          TRACK ? 1ull << (DW_STAGES * ASL + st * BSL + it) : 0ull;
      int hit = 0;
#pragma unroll
      for (int t = 0; t < G; ++t) hit |= rs[t][r] >= 0;
      if (hit && j0 + c < ldb) {
        cp_async16(&b_s[st][r][c], g + (size_t)(v0 + r) * ldb + j0 + c);
        zeroed &= ~bit;
      } else if (!(zeroed & bit) || !TRACK) {
        *reinterpret_cast<uint4*>(&b_s[st][r][c]) = uint4{0, 0, 0, 0};
        zeroed |= bit;
      }
    }
  };

  float acc[G][MI][NJ][4];
#pragma unroll
  for (int t = 0; t < G; ++t)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][mi][j][e] = 0.f;

  // one commit group a step: rules of step i + 2S - 2 and rows of step
  // i + S - 1 (S = DW_STAGES); at step i, the group of step i - S + 1 (rows
  // of i, rules of i + S - 1) and every group before it landed
#pragma unroll
  for (int j = 0; j < DW_STAGES - 1; ++j) issue_rules(j);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DW_STAGES - 1; ++j) {
    issue_rules(j + DW_STAGES - 1);
    issue_rows(j);
    cp_async_commit();
  }
  const int wi0 = (warp >> 1) * WI, wj0 = (warp & 1) * WJ;
  const int r16 = lane & 15, c8 = (lane >> 4) * 8;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // everyone's copies landed; everyone is done with i - 1
    const int st = i % DW_STAGES;
    const int(*rs)[DW_BV] = rule_s[i % DW_RSTAGES];
    // which 16-row pieces of the step each tap hits (warp votes)
    unsigned hit[G], any = 0;
#pragma unroll
    for (int t = 0; t < G; ++t) {
      hit[t] = 0;
#pragma unroll
      for (int c = 0; c < DW_BV / 32; ++c) {
        const unsigned b =
            __ballot_sync(0xffffffffu, rs[t][c * 32 + lane] >= 0);
        hit[t] |= ((b & 0xffffu ? 1u : 0u) | (b >> 16 ? 2u : 0u)) << (2 * c);
      }
      any |= hit[t];
    }
    issue_rules(i + 2 * DW_STAGES - 2);  // into the rule stage of i - 1
    issue_rows(i + DW_STAGES - 1);   // into the row stage of step i - 1
    cp_async_commit();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      if (!((any >> h) & 1u)) continue;  // warp-uniform
      const int kk = h * 16;
      // B (g rows, K x N row-major) read transposed: n-tiles 2jp, 2jp + 1
      unsigned bf[NJ / 2][4];
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp)
        ldmatrix_x4_trans(bf[jp], &b_s[st][kk + r16][wj0 + jp * 16 + c8]);
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (!((hit[t] >> h) & 1u)) continue;  // warp-uniform
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          // A = the gathered rows transposed (M = channels i, K = rows v):
          // ldmatrix.trans of a_s[v][i] gives its four 8x8 pieces in the
          // order (i lo, v lo), (i lo, v hi), (i hi, v lo), (i hi, v hi)
          unsigned x[4];
          ldmatrix_x4_trans(x, &a_s[st][t][kk + r16][wi0 + mi * 16 + c8]);
          const unsigned a[4] = {x[0], x[2], x[1], x[3]};
#pragma unroll
          for (int jp = 0; jp < NJ / 2; ++jp) {
            mma_bf16(acc[t][mi][2 * jp], a, bf[jp][0], bf[jp][1]);
            mma_bf16(acc[t][mi][2 * jp + 1], a, bf[jp][2], bf[jp][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: lane (gq, tq) holds rows gq and gq + 8 of each 16-row piece,
  // columns 8j + 2tq and 8j + 2tq + 1 of every n-tile j
  const int gq = lane >> 2, tq = lane & 3;
  float* slab = out + (size_t)blockIdx.z * n_taps * cin * cout;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (k0 + t >= n_taps) break;
    float* o = slab + (size_t)(k0 + t) * cin * cout;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i0 + wi0 + mi * 16 + gq + half * 8;
        if (row >= cin) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = j0 + wj0 + j * 8 + 2 * tq;
          const float v0 = acc[t][mi][j][2 * half];
          const float v1 = acc[t][mi][j][2 * half + 1];
          float* dst = o + (size_t)row * cout + col;
          if (cout % 2 == 0 && col < cout) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (col < cout) dst[0] = v0;
            if (col + 1 < cout) dst[1] = v1;
          }
        }
      }
  }
}

// f32 variant (the small card-vs-CPU checks): CUDA-core FMA on a (BI/16) x
// (BJ/16) micro-tile per thread; block (tile, tap, z) walks chunks z,
// z + gridDim.z, ... of DWF_BV rulebook rows and skips those that all miss
constexpr int DWF_BV = 64;

template <int BI, int BJ>
__global__ void __launch_bounds__(NT)
conv_dw_fma(const float* __restrict__ feats, const float* __restrict__ g,
            const int* __restrict__ rules, int n_taps, int v_out, int cin,
            int cout, float* __restrict__ out) {
  constexpr int TI = BI / 16, TJ = BJ / 16;
  __shared__ int rule_s[DWF_BV];
  __shared__ float a_s[DWF_BV][BI + 1];
  __shared__ float b_s[DWF_BV][BJ];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_tj = (cout + BJ - 1) / BJ;
  const int i0 = (blockIdx.x / n_tj) * BI, j0 = (blockIdx.x % n_tj) * BJ;
  const int k = blockIdx.y;
  const int* rk = rules + (size_t)k * v_out;
  float acc[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;

  const int n_chunks = (v_out + DWF_BV - 1) / DWF_BV;
  for (int ch = blockIdx.z; ch < n_chunks; ch += gridDim.z) {
    const int v0 = ch * DWF_BV;
    int hit = 0;
    if (tid < DWF_BV) {
      const int r = v0 + tid < v_out ? rk[v0 + tid] : -1;
      rule_s[tid] = r;
      hit = r >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // block-uniform
    for (int t = tid; t < DWF_BV * BI; t += NT) {
      const int r = t / BI, c = t % BI;
      const int src = rule_s[r];
      a_s[r][c] = (src >= 0 && i0 + c < cin)
                      ? feats[(size_t)src * cin + i0 + c] : 0.f;
    }
    for (int t = tid; t < DWF_BV * BJ; t += NT) {
      const int r = t / BJ, c = t % BJ;
      b_s[r][c] = (rule_s[r] >= 0 && j0 + c < cout)
                      ? g[(size_t)(v0 + r) * cout + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int v = 0; v < DWF_BV; ++v) {
      float a[TI], b[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) a[i] = a_s[v][ty * TI + i];
#pragma unroll
      for (int j = 0; j < TJ; ++j) b[j] = b_s[v][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* slab = out + ((size_t)blockIdx.z * n_taps + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int ci = i0 + ty * TI + i;
    if (ci >= cin) continue;
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int cj = j0 + tx + 16 * j;
      if (cj < cout) slab[(size_t)ci * cout + cj] = acc[i][j];
    }
  }
}

template <int BI, int BJ, int G>
int launch_dw_tc(const void* feats, int lda, const void* g, int ldb,
                 const int* rules, int n_taps, int v_out, int cin, int cout,
                 int split, float* dst, cudaStream_t stream) {
  constexpr int bytes = DwSmem<BI, BJ, G>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      conv_dw_tc<BI, BJ, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((cin + BI - 1) / BI) * ((cout + BJ - 1) / BJ);
  const int rmode = v_out % 4 == 0 && (uintptr_t)rules % 16 == 0 ? 16 : 4;
  conv_dw_tc<BI, BJ, G>
      <<<dim3(tiles, (n_taps + G - 1) / G, split), DW_NT, bytes, stream>>>(
          (const __nv_bfloat16*)feats, lda, (const __nv_bfloat16*)g, ldb,
          rules, n_taps, v_out, cin, cout, rmode, dst);
  return (int)cudaSuccess;
}

template <int BI, int BJ>
int launch_dw_tile(int dtype, int group, const void* feats, int lda,
                   const void* g, int ldb, const int* rules, int n_taps,
                   int v_out, int cin, int cout, int split, float* dst,
                   cudaStream_t stream) {
  if (dtype == 1) {
    if ((uintptr_t)feats % 16 || (uintptr_t)g % 16 || lda % 8 || ldb % 8 ||
        lda < cin || ldb < cout)
      return (int)cudaErrorInvalidValue;
    switch (group) {
      case 1:
        return launch_dw_tc<BI, BJ, 1>(feats, lda, g, ldb, rules, n_taps,
                                       v_out, cin, cout, split, dst, stream);
      case 3:
        return launch_dw_tc<BI, BJ, 3>(feats, lda, g, ldb, rules, n_taps,
                                       v_out, cin, cout, split, dst, stream);
      case 9:
        return launch_dw_tc<BI, BJ, 9>(feats, lda, g, ldb, rules, n_taps,
                                       v_out, cin, cout, split, dst, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (group != 1 || lda != cin || ldb != cout)
    return (int)cudaErrorInvalidValue;
  const int tiles = ((cin + BI - 1) / BI) * ((cout + BJ - 1) / BJ);
  conv_dw_fma<BI, BJ><<<dim3(tiles, n_taps, split), NT, 0, stream>>>(
      (const float*)feats, (const float*)g, rules, n_taps, v_out, cin, cout,
      dst);
  return (int)cudaSuccess;
}

}  // namespace

// feats (V_in, Cin) with row stride lda, g (V_out, Cout) with row stride
// ldb, of one dtype (0 = f32: lda = Cin, ldb = Cout; 1 = bf16: lda and ldb
// multiples of 8, zero channels past Cin / Cout), rules (K, V_out) int32 ->
// out (K, Cin, Cout) f32.  Grid (Cin x Cout tiles, groups of ``group``
// taps, split); block z walks steps z, z + split, ... of the rulebook's
// rows (32 rows a step for bf16, 64 for f32, whose group is 1).  split > 1
// writes the (split, K, Cin, Cout) slabs of ``partial`` first and sums them
// in slab order.
extern "C" int sg_conv_dw(const void* feats, int lda, const void* g,
                          int ldb, const void* rules, int n_taps, int v_out,
                          int cin, int cout, int dtype, int group, int split,
                          void* out, void* partial, void* stream) {
  if (n_taps <= 0 || cin <= 0 || cout <= 0) return (int)cudaGetLastError();
  if (group < 1 || split < 1 || (split > 1 && !partial) || split > 65535 ||
      (n_taps + group - 1) / group > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = split > 1 ? (float*)partial : (float*)out;
  const int* r = (const int*)rules;
  int rc;
  if (cin <= 32 && cout <= 32)
    rc = launch_dw_tile<32, 32>(dtype, group, feats, lda, g, ldb, r, n_taps,
                                v_out, cin, cout, split, dst, s);
  else if (cin <= 32)
    rc = launch_dw_tile<32, 64>(dtype, group, feats, lda, g, ldb, r, n_taps,
                                v_out, cin, cout, split, dst, s);
  else if (cout <= 32)
    rc = launch_dw_tile<64, 32>(dtype, group, feats, lda, g, ldb, r, n_taps,
                                v_out, cin, cout, split, dst, s);
  else
    rc = launch_dw_tile<64, 64>(dtype, group, feats, lda, g, ldb, r, n_taps,
                                v_out, cin, cout, split, dst, s);
  if (rc != (int)cudaSuccess) return rc;
  if (split > 1) {
    const long long n = (long long)n_taps * cin * cout;
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    sum_partials<float><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)partial, split, n, (float*)out);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (feats, W and out share it); rules is
// (n_taps, ld) int32 with ld >= v_out.  rows: null, or a permutation of
// [0, v_out) int32 (a row order): column v of the rules is output row
// rows[v] (a split launch's f32 slabs are written by it too).  bf16: split
// blocks per tile cut its step list (1 <= split <= 65535); f32: they cut
// the tap range (split <= n_taps).  split > 1 needs the f32 scratch
// ``partial`` (split, v_out, cout).
extern "C" int sg_rulebook_conv(const void* feats, const void* w,
                                const void* rules, int ld, const void* rows,
                                int n_taps, int v_out, int cin, int cout,
                                void* out, int dtype, int split,
                                void* partial, void* stream) {
  if (cin < 1 || ld < v_out) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* r = (const int*)rules;
  const int* map = (const int*)rows;
  if (dtype == 1)
    return launch_k1_bf16(feats, w, RuleSlab{r, ld, map}, n_taps, v_out, cin,
                          cout, out, split, (float*)partial, s);
  return launch_fma(feats, w, RulebookTaps{r, ld, map}, n_taps, v_out, cin,
                    cout, out, split, (float*)partial, s);
}

// out_keys (v_out,), in_keys (v_in,) sorted int32; strided: the k2s2 down
// conv (8 taps; out_keys on the coarse grid of D = d), else the subm conv
// (27 taps; ``same``: out_keys is in_keys).  bf16 runs K1's kernel with the
// keyed prologue and cuts a tile's step list over split blocks; f32 runs
// the FMA kernel and cuts the tap range.
extern "C" int sg_keyed_conv(const void* feats, const void* w,
                             const void* out_keys, const void* in_keys,
                             int v_in, int v_out, int cin, int cout, int d,
                             int strided, int same, void* out, int dtype,
                             int split, void* partial, void* stream) {
  if (cin < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int n_taps = strided ? 8 : 27;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_k1_bf16(
        feats, w,
        KeyedSlab{(const int*)out_keys, (const int*)in_keys, v_in, d,
                  strided, same && !strided && v_in == v_out},
        n_taps, v_out, cin, cout, out, split, (float*)partial, s);
  return launch_fma(feats, w,
                    KeyedTaps{(const int*)out_keys, (const int*)in_keys,
                              v_in, d, strided},
                    n_taps, v_out, cin, cout, out, split, (float*)partial, s);
}
