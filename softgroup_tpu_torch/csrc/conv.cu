// Sparse 3-D convolution as a gather-GEMM, for Hopper (sm_90a).
//
//   out[v, :] = sum_k feats[nbr(k, v), :] @ W[k]      (nbr == -1 adds 0)
//
// K1 (sg_rulebook_conv) reads nbr from a (K, V_out) int32 rulebook; it
// replaces softgroup_tpu/ops/conv_kernel.py:_conv_kernel (driven by
// _windowed_conv_core).  K4 (sg_keyed_conv) resolves nbr inside the kernel by
// binary search of the output voxel's neighbour key in the sorted input key
// table; it replaces conv_kernel.py:_keyed_kernel (keyed_windowed_conv).
// No (K, V) rulebook is ever written for K4.
//
// Design: one block owns BM=64 output rows x BN (32 or 64) output channels.
// Per tap it fetches the tile's 64 neighbour indices into shared memory and
// skips the tap when all are -1 (most taps of a surface scan, and every tap
// of the padded tail); otherwise it walks Cin in chunks of 32, gathering the
// neighbour rows (zero rows for -1) and W[k]'s chunk into shared memory, and
// accumulates in f32: bf16 inputs on the tensor cores (wmma 16x16x16,
// i.e. mma.sync), f32 inputs with CUDA-core FMA (the tensor cores would
// round them to TF32).  The output is rounded once to the input type.  Any
// Cin / Cout works (ragged chunks are zero-filled), so there is no channel
// cap.
//
// Bound on the H100 at the backbone's shapes: the FLOPs of the taps that
// hit (2 * hits * Cin * Cout) against the bytes of one read of feats, W,
// the rules and one write of the output; at 32-64 channels that is bytes.
// What holds the kernel above it is the gather into shared memory and one
// block barrier pair per 32-channel chunk per tap; the deep levels
// (V <= 1024) launch only 8-64 blocks and are latency-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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
  int v_out;
  __device__ int operator()(int k, int v) const {
    return rules[(size_t)k * v_out + v];
  }
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
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < cout)
        out[((size_t)blockIdx.z * v_out + row) * cout + col] = acc[i][j];
    }
  }
}

// bf16 variant on the tensor cores: the same tiling and tap skip, but the
// gathered rows and W's chunk stay bf16 in shared memory (16-byte vector
// copies where the widths allow) and four warps each accumulate a 16-row
// strip of the tile with wmma 16x16x16 bf16 -> f32 (mma.sync).
constexpr int TC_NT = 128;
constexpr int TC_PAD = 8;  // bf16 elements of row padding (keeps 32 B
                           // alignment of every fragment pointer)

template <int BN, typename Taps>
__global__ void __launch_bounds__(TC_NT)
gather_gemm_tc(const __nv_bfloat16* __restrict__ feats,
               const __nv_bfloat16* __restrict__ w, Taps taps, int n_taps,
               int kt, int v_out, int cin, int cout,
               __nv_bfloat16* __restrict__ out, float* __restrict__ partial) {
  using namespace nvcuda;
  constexpr int NF = BN / 16;
  __shared__ int rule_s[BM];
  __shared__ __align__(32) __nv_bfloat16 a_s[BM][BK + TC_PAD];
  __shared__ __align__(32) __nv_bfloat16 b_s[BK][BN + TC_PAD];
  __shared__ __align__(32) float c_s[BM][BN + 4];
  const int tid = threadIdx.x, warp = tid / 32;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const bool vec_a = (cin % 8) == 0, vec_b = (cout % 8) == 0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

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
      if (vec_a && c0 + BK <= cin) {
        for (int i = tid; i < BM * (BK / 8); i += TC_NT) {
          const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
          const int src = rule_s[r];
          uint4 val = make_uint4(0, 0, 0, 0);
          if (src >= 0)
            val = *reinterpret_cast<const uint4*>(
                feats + (size_t)src * cin + c0 + c);
          *reinterpret_cast<uint4*>(&a_s[r][c]) = val;
        }
      } else {
        for (int i = tid; i < BM * BK; i += TC_NT) {
          const int r = i / BK, c = i % BK;
          const int src = rule_s[r];
          a_s[r][c] = (src >= 0 && c0 + c < cin)
                          ? feats[(size_t)src * cin + c0 + c] : zero;
        }
      }
      if (vec_b && col0 + BN <= cout) {
        for (int i = tid; i < BK * (BN / 8); i += TC_NT) {
          const int c = i / (BN / 8), n = (i % (BN / 8)) * 8;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (c0 + c < cin)
            val = *reinterpret_cast<const uint4*>(
                w + ((size_t)k * cin + c0 + c) * cout + col0 + n);
          *reinterpret_cast<uint4*>(&b_s[c][n]) = val;
        }
      } else {
        for (int i = tid; i < BK * BN; i += TC_NT) {
          const int c = i / BN, n = i % BN;
          b_s[c][n] = (c0 + c < cin && col0 + n < cout)
                          ? w[((size_t)k * cin + c0 + c) * cout + col0 + n]
                          : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &a_s[warp * 16][kk], BK + TC_PAD);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &b_s[kk][j * 16], BN + TC_PAD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(&c_s[warp * 16][j * 16], acc[j], BN + 4,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += TC_NT) {
    const int r = i / BN, n = i % BN;
    const int row = row0 + r, col = col0 + n;
    if (row >= v_out || col >= cout) continue;
    if (partial)
      partial[((size_t)blockIdx.z * v_out + row) * cout + col] = c_s[r][n];
    else
      out[(size_t)row * cout + col] = __float2bfloat16_rn(c_s[r][n]);
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

// split > 1 spreads the taps over split blocks per tile (grid.z), each
// writing an f32 partial slab of ``partial`` (split, v_out, cout) that a
// second kernel sums: the deep levels otherwise launch too few blocks to
// fill the card.  split == 1 writes ``out`` directly.
template <typename T, typename Taps>
int launch(const void* feats, const void* w, Taps taps, int n_taps,
           int v_out, int cin, int cout, void* out, int split,
           float* partial, cudaStream_t stream) {
  if (v_out <= 0 || cout <= 0) return (int)cudaGetLastError();
  if (split < 1 || split > n_taps || (split > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  const int kt = (n_taps + split - 1) / split;
  const dim3 g32((v_out + BM - 1) / BM, (cout + 31) / 32, split);
  const dim3 g64((v_out + BM - 1) / BM, (cout + 63) / 64, split);
  const T* f = (const T*)feats;
  const T* wt = (const T*)w;
  float* part = split > 1 ? partial : nullptr;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    T* o = (T*)out;
    if (cout <= 32)
      gather_gemm_tc<32, Taps><<<g32, TC_NT, 0, stream>>>(
          f, wt, taps, n_taps, kt, v_out, cin, cout, o, part);
    else
      gather_gemm_tc<64, Taps><<<g64, TC_NT, 0, stream>>>(
          f, wt, taps, n_taps, kt, v_out, cin, cout, o, part);
  } else {
    float* o = part ? part : (float*)out;
    if (cout <= 32)
      gather_gemm<32, Taps><<<g32, NT, 0, stream>>>(
          f, wt, taps, n_taps, kt, v_out, cin, cout, o);
    else
      gather_gemm<64, Taps><<<g64, NT, 0, stream>>>(
          f, wt, taps, n_taps, kt, v_out, cin, cout, o);
  }
  if (part) {
    const long long n = (long long)v_out * cout;
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    sum_partials<T><<<(unsigned)blocks, 256, 0, stream>>>(part, split, n,
                                                          (T*)out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: weight gradient of the rulebook conv (sg_conv_dw)
//
//   dW[k, i, j] = sum_v feats[rules[k, v], i] * g[v, j]      (-1 adds 0)
//
// Replaces softgroup_tpu/ops/conv_kernel.py:_dw_kernel (driven by
// windowed_conv_dw, dispatched by sparse_conv._dw).  The TPU kernel carried
// the (K, Cin, Cout) sum across its sequential grid in VMEM; Hopper's blocks
// run in no order, so the V reduction is cut into ``split`` contiguous
// ranges of 64-row chunks: block (tile, k, z) walks its range of
// rules[k], skips every chunk whose 64 rules are all -1 (most taps of a
// surface scan, the whole padded tail), gathers the hit feats rows and the
// matching g rows into shared memory and accumulates its (BI x BJ) tile of
// dW[k] in f32.  bf16: the 64 rows are the K dimension of wmma 16x16x16
// (mma.sync) products A^T B; f32: CUDA-core FMA (no TF32).  Each z writes
// an f32 partial slab that sum_partials adds in slab order, so the result
// is deterministic (no atomics).
//
// Bound on the H100: bytes (one read of feats, g and the rules, one write of
// dW); at 32 channels the FLOPs of the hit rows are far below the tensor
// cores' rate.  What holds the kernel above it is the chunk loop's
// latency: rules, then gathers, then the MMA, with block barriers between.
constexpr int DW_BV = 64;  // rulebook rows per chunk

template <int BI, int BJ>
__global__ void __launch_bounds__(TC_NT)
conv_dw_tc(const __nv_bfloat16* __restrict__ feats,
           const __nv_bfloat16* __restrict__ g, const int* __restrict__ rules,
           int n_taps, int v_out, int cin, int cout, int cpb, int n_chunks,
           float* __restrict__ out) {
  using namespace nvcuda;
  constexpr int NFJ = BJ / 16;
  constexpr int NFW = (BI / 16) * NFJ / 4;  // fragments per warp
  __shared__ int rule_s[DW_BV];
  __shared__ __align__(32) __nv_bfloat16 a_s[DW_BV][BI + TC_PAD];
  __shared__ __align__(32) __nv_bfloat16 b_s[DW_BV][BJ + TC_PAD];
  __shared__ __align__(32) float c_s[BI][BJ + 4];
  const int tid = threadIdx.x, warp = tid / 32;
  const int n_tj = (cout + BJ - 1) / BJ;
  const int i0 = (blockIdx.x / n_tj) * BI, j0 = (blockIdx.x % n_tj) * BJ;
  const int k = blockIdx.y;
  const int* rk = rules + (size_t)k * v_out;
  const bool vec_a = (cin % 8) == 0 && i0 + BI <= cin;
  const bool vec_b = (cout % 8) == 0 && j0 + BJ <= cout;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFW];
#pragma unroll
  for (int q = 0; q < NFW; ++q) wmma::fill_fragment(acc[q], 0.f);

  const int ch_end = min(n_chunks, (int)(blockIdx.z + 1) * cpb);
  for (int ch = blockIdx.z * cpb; ch < ch_end; ++ch) {
    const int v0 = ch * DW_BV;
    int hit = 0;
    if (tid < DW_BV) {
      const int r = v0 + tid < v_out ? rk[v0 + tid] : -1;
      rule_s[tid] = r;
      hit = r >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // block-uniform
    if (vec_a) {
      for (int t = tid; t < DW_BV * (BI / 8); t += TC_NT) {
        const int r = t / (BI / 8), c = (t % (BI / 8)) * 8;
        const int src = rule_s[r];
        uint4 val = make_uint4(0, 0, 0, 0);
        if (src >= 0)
          val = *reinterpret_cast<const uint4*>(feats + (size_t)src * cin +
                                                i0 + c);
        *reinterpret_cast<uint4*>(&a_s[r][c]) = val;
      }
    } else {
      for (int t = tid; t < DW_BV * BI; t += TC_NT) {
        const int r = t / BI, c = t % BI;
        const int src = rule_s[r];
        a_s[r][c] = (src >= 0 && i0 + c < cin)
                        ? feats[(size_t)src * cin + i0 + c] : zero;
      }
    }
    if (vec_b) {
      for (int t = tid; t < DW_BV * (BJ / 8); t += TC_NT) {
        const int r = t / (BJ / 8), c = (t % (BJ / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (rule_s[r] >= 0)
          val = *reinterpret_cast<const uint4*>(g + (size_t)(v0 + r) * cout +
                                                j0 + c);
        *reinterpret_cast<uint4*>(&b_s[r][c]) = val;
      }
    } else {
      for (int t = tid; t < DW_BV * BJ; t += TC_NT) {
        const int r = t / BJ, c = t % BJ;
        b_s[r][c] = (rule_s[r] >= 0 && j0 + c < cout)
                        ? g[(size_t)(v0 + r) * cout + j0 + c] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DW_BV; kk += 16) {
#pragma unroll
      for (int q = 0; q < NFW; ++q) {
        const int f = warp * NFW + q, fi = f / NFJ, fj = f % NFJ;
        // A^T: element (i, v) of the product's left operand is a_s[v][i]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fa;
        wmma::load_matrix_sync(fa, &a_s[kk][fi * 16], BI + TC_PAD);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &b_s[kk][fj * 16], BJ + TC_PAD);
        wmma::mma_sync(acc[q], fa, fb, acc[q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NFW; ++q) {
    const int f = warp * NFW + q, fi = f / NFJ, fj = f % NFJ;
    wmma::store_matrix_sync(&c_s[fi * 16][fj * 16], acc[q], BJ + 4,
                            wmma::mem_row_major);
  }
  __syncthreads();
  float* slab = out + ((size_t)blockIdx.z * n_taps + k) * cin * cout;
  for (int t = tid; t < BI * BJ; t += TC_NT) {
    const int i = t / BJ, j = t % BJ;
    if (i0 + i < cin && j0 + j < cout)
      slab[(size_t)(i0 + i) * cout + j0 + j] = c_s[i][j];
  }
}

// f32 variant: CUDA-core FMA on a (BI/16) x (BJ/16) micro-tile per thread
template <int BI, int BJ>
__global__ void __launch_bounds__(NT)
conv_dw_fma(const float* __restrict__ feats, const float* __restrict__ g,
            const int* __restrict__ rules, int n_taps, int v_out, int cin,
            int cout, int cpb, int n_chunks, float* __restrict__ out) {
  constexpr int TI = BI / 16, TJ = BJ / 16;
  __shared__ int rule_s[DW_BV];
  __shared__ float a_s[DW_BV][BI + 1];
  __shared__ float b_s[DW_BV][BJ];
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

  const int ch_end = min(n_chunks, (int)(blockIdx.z + 1) * cpb);
  for (int ch = blockIdx.z * cpb; ch < ch_end; ++ch) {
    const int v0 = ch * DW_BV;
    int hit = 0;
    if (tid < DW_BV) {
      const int r = v0 + tid < v_out ? rk[v0 + tid] : -1;
      rule_s[tid] = r;
      hit = r >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // block-uniform
    for (int t = tid; t < DW_BV * BI; t += NT) {
      const int r = t / BI, c = t % BI;
      const int src = rule_s[r];
      a_s[r][c] = (src >= 0 && i0 + c < cin)
                      ? feats[(size_t)src * cin + i0 + c] : 0.f;
    }
    for (int t = tid; t < DW_BV * BJ; t += NT) {
      const int r = t / BJ, c = t % BJ;
      b_s[r][c] = (rule_s[r] >= 0 && j0 + c < cout)
                      ? g[(size_t)(v0 + r) * cout + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int v = 0; v < DW_BV; ++v) {
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

template <int BI, int BJ>
void launch_dw_tile(int dtype, const void* feats, const void* g,
                    const int* rules, int n_taps, int v_out, int cin,
                    int cout, int split, int cpb, int n_chunks, float* dst,
                    cudaStream_t stream) {
  const int tiles = ((cin + BI - 1) / BI) * ((cout + BJ - 1) / BJ);
  const dim3 grid(tiles, n_taps, split);
  if (dtype == 1)
    conv_dw_tc<BI, BJ><<<grid, TC_NT, 0, stream>>>(
        (const __nv_bfloat16*)feats, (const __nv_bfloat16*)g, rules, n_taps,
        v_out, cin, cout, cpb, n_chunks, dst);
  else
    conv_dw_fma<BI, BJ><<<grid, NT, 0, stream>>>(
        (const float*)feats, (const float*)g, rules, n_taps, v_out, cin,
        cout, cpb, n_chunks, dst);
}

}  // namespace

// feats (V_in, Cin), g (V_out, Cout) of one dtype (0 = f32, 1 = bf16),
// rules (K, V_out) int32 -> out (K, Cin, Cout) f32.  split > 1 writes the
// (split, K, Cin, Cout) slabs of ``partial`` first; each z walks chunks
// [z * cpb, (z + 1) * cpb) of 64 rulebook rows.
extern "C" int sg_conv_dw(const void* feats, const void* g, const void* rules,
                          int n_taps, int v_out, int cin, int cout,
                          int dtype, int split, int cpb, void* out,
                          void* partial, void* stream) {
  if (n_taps <= 0 || cin <= 0 || cout <= 0) return (int)cudaGetLastError();
  const int n_chunks = (v_out + DW_BV - 1) / DW_BV;
  if (split < 1 || cpb < 1 || (long long)split * cpb < n_chunks ||
      (split > 1 && !partial) || split > 65535 || n_taps > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = split > 1 ? (float*)partial : (float*)out;
  const int* r = (const int*)rules;
  if (cin <= 32 && cout <= 32)
    launch_dw_tile<32, 32>(dtype, feats, g, r, n_taps, v_out, cin, cout,
                           split, cpb, n_chunks, dst, s);
  else if (cin <= 32)
    launch_dw_tile<32, 64>(dtype, feats, g, r, n_taps, v_out, cin, cout,
                           split, cpb, n_chunks, dst, s);
  else if (cout <= 32)
    launch_dw_tile<64, 32>(dtype, feats, g, r, n_taps, v_out, cin, cout,
                           split, cpb, n_chunks, dst, s);
  else
    launch_dw_tile<64, 64>(dtype, feats, g, r, n_taps, v_out, cin, cout,
                           split, cpb, n_chunks, dst, s);
  if (split > 1) {
    const long long n = (long long)n_taps * cin * cout;
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    sum_partials<float><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)partial, split, n, (float*)out);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (feats, W and out share it)
extern "C" int sg_rulebook_conv(const void* feats, const void* w,
                                const void* rules, int n_taps, int v_out,
                                int cin, int cout, void* out,
                                int dtype, int split, void* partial,
                                void* stream) {
  RulebookTaps taps{(const int*)rules, v_out};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, w, taps, n_taps, v_out, cin, cout,
                                 out, split, (float*)partial, s);
  return launch<float>(feats, w, taps, n_taps, v_out, cin, cout, out,
                       split, (float*)partial, s);
}

extern "C" int sg_keyed_conv(const void* feats, const void* w,
                             const void* out_keys, const void* in_keys,
                             int v_in, int v_out, int cin, int cout, int d,
                             int strided, void* out, int dtype, int split,
                             void* partial, void* stream) {
  KeyedTaps taps{(const int*)out_keys, (const int*)in_keys, v_in, d,
                 strided};
  const int n_taps = strided ? 8 : 27;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, w, taps, n_taps, v_out, cin, cout,
                                 out, split, (float*)partial, s);
  return launch<float>(feats, w, taps, n_taps, v_out, cin, cout, out,
                       split, (float*)partial, s);
}
