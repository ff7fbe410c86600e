// Masked batch norm and ReLU for Hopper: the statistics, normalise and
// backward passes of model/blocks.MaskedBatchNorm (ops/norm_kernel.py).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the reference's batch norm
// (softgroup_tpu/model/blocks.py MaskedBatchNorm) into a few passes of its
// own.  In the port it was a chain of PyTorch ops, about 30 launches
// forward and 20 backward a call, which took 59% of a ScanNet train step
// on an H100.
//
// Semantics (the module's): over the rows the mask marks valid, the f32
// mean and biased variance normalise every row, y = (x - mean) * rstd *
// scale + bias, rstd = rsqrt(var + eps), written in x's type, optionally
// through a ReLU; the running mean and unbiased variance (n / max(n - 1,
// 1), n the valid rows clamped to 1) move by the momentum.  Eval mode
// normalises with the running statistics.
//
// Bound on the H100: bytes.  Train forward reads x twice (statistics, then
// normalise; the second read finds much of x in L2 on the small levels)
// and writes y; backward reads x and dy twice and writes dx; eval reads x
// once and writes y.  Design:
//   * a block owns a tile of rows and every channel: threadIdx.x walks the
//     row in 16-byte vectors (8 bf16 or 4 f32 channels a thread), so a warp
//     reads whole rows; threadIdx.y takes every rpb-th row of the tile,
//     four rows in flight a thread.  The host picks the tile from (V, C)
//     and the type: about 4 blocks an SM on the big levels, at least 8 rows
//     a thread on the small ones, so that the partials stay few.  Loads
//     stay packed (16 bytes) in registers until they are used;
//   * statistics: each thread runs Welford's update over its valid rows
//     (count, mean, M2 in f32: no E[x^2] - E[x]^2, which cancels badly
//     over 364k rows), reading the mask of its next rows while the
//     current rows arrive; the block merges its threads with Chan's formula
//     in a fixed tree, and writes one partial a block, a channel's partials
//     side by side; a finalize kernel, one warp a channel, merges them in a
//     fixed order with coalesced reads (no float atomics: a call repeats
//     bit for bit), writes mean, rstd and the count, and moves the running
//     buffers in place;
//   * normalise: y = fma(x - mean, scale * rstd, bias), ReLU'd, in x's
//     type; the backward recomputes y the same way for the ReLU gate;
//   * backward: with g = dy gated by the ReLU and x^ = (x - mean) * rstd,
//     dbias = sum g and dscale = sum g x^ over EVERY row (the affine step
//     applies to every row), and
//         dx = scale * rstd * (g - valid * (sum g + x^ sum g x^) / n),
//     so an invalid row gets g * scale * rstd and eval (no batch
//     statistics) all rows; the same two-level reduction (partials, then a
//     warp a channel in a fixed order) gives the sums, and an elementwise
//     pass writes dx.
// Only x, the mask and the (2C + 1) statistics are kept for the backward.
// The host issues a pass, its launches together, in one call
// (sg_bn_forward, sg_bn_backward) with the tile the wrapper planned once
// for the shape, so a call's host time is mostly the launches' own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int UNROLL = 4;      // rows in flight a thread
constexpr int MAX_THREADS = 512;
constexpr int FINAL_WARPS = 8;  // channels a finalize block
constexpr int FINAL_UNROLL = 4;  // partials in flight a finalize lane

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements as loaded (one 16-byte vector, or one element),
// kept packed in registers until unpack() converts them at use
template <typename T, int VEC>
struct Raw {
  static_assert(VEC * sizeof(T) == 16, "16-byte vectors");
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(
    const T* __restrict__ p) {
  if constexpr (VEC == 1)
    return p[0];
  else
    return *reinterpret_cast<const uint4*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename Raw<T, VEC>::type& q,
                                       float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(q);
  } else if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// the normalised value; the forward and the backward's ReLU gate both take
// it from here, so the gate sees the forward's bits
__device__ __forceinline__ float affine(float d, float a, float b) {
  return fmaf(d, a, b);
}

// y as the forward wrote it (rounded to T), the ReLU's gate reads its sign
template <typename T>
__device__ __forceinline__ bool passes(float y) {
  return to_f(from_f<T>(y)) > 0.f;
}

// a thread's channels: mean, a = scale * rstd and bias; rs is the batch
// rstd, or (EVAL) the running variance
template <int VEC, bool EVAL>
__device__ __forceinline__ void load_coef(
    int c0, const float* __restrict__ mean, const float* __restrict__ rs,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float eps, float (&mu)[VEC], float (&a)[VEC], float (&b)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mu[k] = mean[c0 + k];
    const float r = EVAL ? rsqrtf(rs[c0 + k] + eps) : rs[c0 + k];
    a[k] = scale[c0 + k] * r;
    b[k] = bias[c0 + k];
  }
}

// (na, ma, m2a) <- the merge of it with (nb, mb, m2b) (Chan et al.)
__device__ __forceinline__ void chan(float& na, float& ma, float& m2a,
                                     float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float fb = nb / n;
  const float d = mb - ma;
  ma = fmaf(d, fb, ma);
  m2a += m2b + d * d * (na * fb);
  na = n;
}

// per block: the count, mean and M2 of each channel over the block's
// valid rows.  part: [nblk] counts, [c][nblk] means, [c][nblk] M2s (a
// channel's partials side by side, for the finalize's coalesced reads).
// The mask of the next rows is read while the current rows' x arrive.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
bn_stats_part(const T* __restrict__ x, const uint8_t* __restrict__ mask,
              int v, int c, int rows, int nblk, float* __restrict__ part) {
  using R = typename Raw<T, VEC>::type;
  extern __shared__ float sh[];
  const int tc = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  const int rpb = blockDim.y, c0 = tx * VEC;
  const long long rb = (long long)blockIdx.x * rows;
  const int r0 = (int)rb;
  const int r1 = (int)(rb + rows < v ? rb + rows : v);
  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;
  bool next[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int rr = r0 + ty + u * rpb;
    next[u] = rr < r1 && mask[rr];
  }
  for (int r = r0 + ty; r < r1; r += UNROLL * rpb) {
    R xv[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = next[u];
      if (ok[u]) xv[u] = load_raw<T, VEC>(x + (size_t)(r + u * rpb) * c + c0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + (UNROLL + u) * rpb;
      next[u] = rr < r1 && mask[rr];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float xf[VEC];
      unpack<T, VEC>(xv[u], xf);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = xf[k] - mean[k];
        mean[k] = fmaf(d, inv, mean[k]);
        m2[k] = fmaf(d, xf[k] - mean[k], m2[k]);
      }
    }
  }
  // merge the block's rows of threads in a fixed tree: ty takes ty + s
  const int nt = tc * rpb, t = ty * tc + tx;
  float* sn = sh;
  float* sm = sh + nt;
  float* s2 = sm + nt * VEC;
  sn[t] = n;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sm[k * nt + t] = mean[k];
    s2[k * nt + t] = m2[k];
  }
  __syncthreads();
  for (int s = 1; s < rpb; s <<= 1) {
    if ((ty & (2 * s - 1)) == 0 && ty + s < rpb) {
      const int o = t + s * tc;
      const float nb = sn[o];
      float na = n;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        na = n;
        chan(na, mean[k], m2[k], nb, sm[k * nt + o], s2[k * nt + o]);
      }
      n = na;
      sn[t] = n;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sm[k * nt + t] = mean[k];
        s2[k * nt + t] = m2[k];
      }
    }
    __syncthreads();
  }
  if (ty == 0) {
    float* pm = part + nblk + (size_t)c0 * nblk + blockIdx.x;
    float* p2 = pm + (size_t)nblk * c;
    if (tx == 0) part[blockIdx.x] = n;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      pm[(size_t)k * nblk] = mean[k];
      p2[(size_t)k * nblk] = m2[k];
    }
  }
}

// one warp a channel: merges the partials (lane-strided, FINAL_UNROLL
// loads in flight; then a shuffle tree: a fixed order), writes st = [mean
// (c), rstd (c), n clamped to 1] and moves the running buffers
__global__ void bn_stats_final(const float* __restrict__ part, int nblk,
                               int c, float eps, float momentum,
                               float* __restrict__ st,
                               float* __restrict__ run_mean,
                               float* __restrict__ run_var) {
  const int ch = blockIdx.x * blockDim.y + threadIdx.y;
  const int lane = threadIdx.x;
  if (ch >= c) return;
  const float* pm = part + nblk + (size_t)ch * nblk;
  const float* p2 = pm + (size_t)nblk * c;
  float n = 0.f, m = 0.f, q = 0.f;
  for (int b0 = lane; b0 < nblk; b0 += 32 * FINAL_UNROLL) {
    float nb[FINAL_UNROLL], mb[FINAL_UNROLL], qb[FINAL_UNROLL];
#pragma unroll
    for (int u = 0; u < FINAL_UNROLL; ++u) {
      const int b = b0 + 32 * u;
      nb[u] = b < nblk ? part[b] : 0.f;
      mb[u] = b < nblk ? pm[b] : 0.f;
      qb[u] = b < nblk ? p2[b] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FINAL_UNROLL; ++u) chan(n, m, q, nb[u], mb[u], qb[u]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, m, off);
    const float qb = __shfl_down_sync(0xffffffffu, q, off);
    if (lane < off) chan(n, m, q, nb, mb, qb);
  }
  if (lane != 0) return;
  const float nc = fmaxf(n, 1.f);
  const float var = q / nc;
  st[ch] = m;
  st[c + ch] = rsqrtf(var + eps);
  if (ch == 0) st[2 * c] = nc;
  const float unbiased = var * nc / fmaxf(nc - 1.f, 1.f);
  run_mean[ch] = run_mean[ch] * (1.f - momentum) + momentum * m;
  run_var[ch] = run_var[ch] * (1.f - momentum) + momentum * unbiased;
}

// y = affine(x - mean, scale * rstd, bias), ReLU'd where RELU, in T
template <typename T, int VEC, bool RELU, bool EVAL>
__global__ void __launch_bounds__(MAX_THREADS)
bn_apply(const T* __restrict__ x, int v, int c, int rows,
         const float* __restrict__ mean, const float* __restrict__ rs,
         const float* __restrict__ scale, const float* __restrict__ bias,
         float eps, T* __restrict__ out) {
  const int rpb = blockDim.y, c0 = threadIdx.x * VEC;
  float mu[VEC], a[VEC], b[VEC];
  load_coef<VEC, EVAL>(c0, mean, rs, scale, bias, eps, mu, a, b);
  const long long rb = (long long)blockIdx.x * rows;
  const int r0 = (int)rb;
  const int r1 = (int)(rb + rows < v ? rb + rows : v);
  for (int r = r0 + threadIdx.y; r < r1; r += UNROLL * rpb) {
    typename Raw<T, VEC>::type xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * rpb;
      if (rr < r1) xv[u] = load_raw<T, VEC>(x + (size_t)rr * c + c0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * rpb;
      if (rr >= r1) continue;
      float xf[VEC], y[VEC];
      unpack<T, VEC>(xv[u], xf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        y[k] = affine(xf[k] - mu[k], a[k], b[k]);
        if (RELU) y[k] = y[k] < 0.f ? 0.f : y[k];   // NaN passes, as relu
      }
      store_vec<T, VEC>(out + (size_t)rr * c + c0, y);
    }
  }
}

// per block: sum g and sum g (x - mean) over every row of the tile, g = dy
// gated by the ReLU.  part: [c][nblk] sums of g, [c][nblk] of g (x - mean).
template <typename T, int VEC, bool RELU, bool EVAL>
__global__ void __launch_bounds__(MAX_THREADS)
bn_grad_part(const T* __restrict__ x, const T* __restrict__ dy, int v, int c,
             int rows, int nblk, const float* __restrict__ mean,
             const float* __restrict__ rs, const float* __restrict__ scale,
             const float* __restrict__ bias, float eps,
             float* __restrict__ part) {
  extern __shared__ float sh[];
  const int tc = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  const int rpb = blockDim.y, c0 = tx * VEC;
  float mu[VEC], a[VEC], b[VEC];
  load_coef<VEC, EVAL>(c0, mean, rs, scale, bias, eps, mu, a, b);
  const long long rb = (long long)blockIdx.x * rows;
  const int r0 = (int)rb;
  const int r1 = (int)(rb + rows < v ? rb + rows : v);
  float sg[VEC], sgd[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sg[k] = sgd[k] = 0.f;
  for (int r = r0 + ty; r < r1; r += UNROLL * rpb) {
    typename Raw<T, VEC>::type xv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * rpb;
      if (rr < r1) {
        xv[u] = load_raw<T, VEC>(x + (size_t)rr * c + c0);
        gv[u] = load_raw<T, VEC>(dy + (size_t)rr * c + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * rpb >= r1) continue;
      float xf[VEC], gf[VEC];
      unpack<T, VEC>(xv[u], xf);
      unpack<T, VEC>(gv[u], gf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = xf[k] - mu[k];
        float g = gf[k];
        if (RELU && !passes<T>(affine(d, a[k], b[k]))) g = 0.f;
        sg[k] += g;
        sgd[k] = fmaf(g, d, sgd[k]);
      }
    }
  }
  const int nt = tc * rpb, t = ty * tc + tx;
  float* s1 = sh;
  float* s2 = sh + nt * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s1[k * nt + t] = sg[k];
    s2[k * nt + t] = sgd[k];
  }
  __syncthreads();
  for (int s = 1; s < rpb; s <<= 1) {
    if ((ty & (2 * s - 1)) == 0 && ty + s < rpb) {
      const int o = t + s * tc;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sg[k] += s1[k * nt + o];
        sgd[k] += s2[k * nt + o];
        s1[k * nt + t] = sg[k];
        s2[k * nt + t] = sgd[k];
      }
    }
    __syncthreads();
  }
  if (ty == 0) {
    float* p1 = part + (size_t)c0 * nblk + blockIdx.x;
    float* p2 = p1 + (size_t)nblk * c;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      p1[(size_t)k * nblk] = sg[k];
      p2[(size_t)k * nblk] = sgd[k];
    }
  }
}

// one warp a channel: sums the partials in a fixed order; writes gparams =
// [dscale (c), dbias (c)] and (train) coef = [sum g / n (c),
// rstd sum g x^ / n (c)], what dx's mean and variance terms take
template <bool EVAL>
__global__ void bn_grad_final(const float* __restrict__ part, int nblk,
                              int c, const float* __restrict__ rs,
                              float eps, const float* __restrict__ count,
                              float* __restrict__ gparams,
                              float* __restrict__ coef) {
  const int ch = blockIdx.x * blockDim.y + threadIdx.y;
  const int lane = threadIdx.x;
  if (ch >= c) return;
  const float* p1 = part + (size_t)ch * nblk;
  const float* p2 = p1 + (size_t)nblk * c;
  float sg = 0.f, sgd = 0.f;
  for (int b0 = lane; b0 < nblk; b0 += 32 * FINAL_UNROLL) {
    float g1[FINAL_UNROLL], g2[FINAL_UNROLL];
#pragma unroll
    for (int u = 0; u < FINAL_UNROLL; ++u) {
      const int b = b0 + 32 * u;
      g1[u] = b < nblk ? p1[b] : 0.f;
      g2[u] = b < nblk ? p2[b] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FINAL_UNROLL; ++u) {
      sg += g1[u];
      sgd += g2[u];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, off);
    sgd += __shfl_down_sync(0xffffffffu, sgd, off);
  }
  if (lane != 0) return;
  const float rstd = EVAL ? rsqrtf(rs[ch] + eps) : rs[ch];
  const float sgx = sgd * rstd;
  gparams[ch] = sgx;
  gparams[c + ch] = sg;
  if (!EVAL) {
    const float n = *count;
    coef[ch] = sg / n;
    coef[c + ch] = sgx * rstd / n;
  }
}

// dx = a * (g - valid * (k1 + (x - mean) k2)), a = scale * rstd; eval and
// invalid rows take dx = a * g
template <typename T, int VEC, bool RELU, bool EVAL>
__global__ void __launch_bounds__(MAX_THREADS)
bn_dx(const T* __restrict__ x, const T* __restrict__ dy,
      const uint8_t* __restrict__ mask, int v, int c, int rows,
      const float* __restrict__ mean, const float* __restrict__ rs,
      const float* __restrict__ scale, const float* __restrict__ bias,
      float eps, const float* __restrict__ coef, T* __restrict__ dx) {
  constexpr bool NEED_X = RELU || !EVAL;
  const int rpb = blockDim.y, c0 = threadIdx.x * VEC;
  float mu[VEC], a[VEC], b[VEC], k1[VEC], k2[VEC];
  load_coef<VEC, EVAL>(c0, mean, rs, scale, bias, eps, mu, a, b);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    k1[k] = EVAL ? 0.f : coef[c0 + k];
    k2[k] = EVAL ? 0.f : coef[c + c0 + k];
  }
  const long long rb = (long long)blockIdx.x * rows;
  const int r0 = (int)rb;
  const int r1 = (int)(rb + rows < v ? rb + rows : v);
  for (int r = r0 + threadIdx.y; r < r1; r += UNROLL * rpb) {
    typename Raw<T, VEC>::type xv[UNROLL], gv[UNROLL];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * rpb;
      valid[u] = false;
      if (rr < r1) {
        if (!EVAL) valid[u] = mask[rr];
        if (NEED_X) xv[u] = load_raw<T, VEC>(x + (size_t)rr * c + c0);
        gv[u] = load_raw<T, VEC>(dy + (size_t)rr * c + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * rpb;
      if (rr >= r1) continue;
      float xf[VEC], gf[VEC], o[VEC];
      if (NEED_X) unpack<T, VEC>(xv[u], xf);
      unpack<T, VEC>(gv[u], gf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = NEED_X ? xf[k] - mu[k] : 0.f;
        float g = gf[k];
        if (RELU && !passes<T>(affine(d, a[k], b[k]))) g = 0.f;
        if (valid[u]) g -= fmaf(d, k2[k], k1[k]);
        o[k] = a[k] * g;
      }
      store_vec<T, VEC>(dx + (size_t)rr * c + c0, o);
    }
  }
}

// ---- host side: launches by type, vector width, ReLU and mode ----------

// the wrapper's plan, as it passes it: 7 ints
struct Tile {
  int dtype, v, c, vec, rpb, rows, nblk;
  dim3 block() const { return dim3(c / vec, rpb); }
  int threads() const { return (c / vec) * rpb; }
  dim3 final_grid() const { return dim3((c + FINAL_WARPS - 1) / FINAL_WARPS); }
};

constexpr int RELU_FLAG = 1, EVAL_FLAG = 2, PARAMS_FLAG = 4;

// train: the statistics into st (then the partials), the running buffers
// moved, then the normalise pass with them; eval: the normalise pass with
// the running statistics
template <typename T, int VEC, bool RELU, bool EVAL>
int forward_t(const Tile& t, const void* x, const uint8_t* mask,
              const float* scale, const float* bias, float* run_mean,
              float* run_var, float eps, float momentum, float* st,
              void* out, cudaStream_t s) {
  const float* mean = run_mean;
  const float* rs = run_var;
  if (!EVAL) {
    float* part = st + 2 * t.c + 1;
    const size_t smem = (size_t)t.threads() * (1 + 2 * VEC) * sizeof(float);
    bn_stats_part<T, VEC><<<t.nblk, t.block(), smem, s>>>(
        (const T*)x, mask, t.v, t.c, t.rows, t.nblk, part);
    bn_stats_final<<<t.final_grid(), dim3(32, FINAL_WARPS), 0, s>>>(
        part, t.nblk, t.c, eps, momentum, st, run_mean, run_var);
    mean = st;
    rs = st + t.c;
  }
  bn_apply<T, VEC, RELU, EVAL><<<t.nblk, t.block(), 0, s>>>(
      (const T*)x, t.v, t.c, t.rows, mean, rs, scale, bias, eps, (T*)out);
  return (int)cudaGetLastError();
}

// the reduction (where `reduce`) into scratch = [dscale, dbias (c each),
// dx's coefficients (2c), the partials], then dx (where not null)
template <typename T, int VEC, bool RELU, bool EVAL>
int backward_t(const Tile& t, const void* x, const void* dy,
               const uint8_t* mask, const float* scale, const float* bias,
               const float* run_mean, const float* run_var, const float* st,
               float eps, bool reduce, float* scratch, void* dx,
               cudaStream_t s) {
  const float* mean = EVAL ? run_mean : st;
  const float* rs = EVAL ? run_var : st + t.c;
  float* coef = reduce ? scratch + 2 * t.c : nullptr;
  if (reduce) {
    const size_t smem = (size_t)t.threads() * 2 * VEC * sizeof(float);
    bn_grad_part<T, VEC, RELU, EVAL><<<t.nblk, t.block(), smem, s>>>(
        (const T*)x, (const T*)dy, t.v, t.c, t.rows, t.nblk, mean, rs, scale,
        bias, eps, scratch + 4 * t.c);
    bn_grad_final<EVAL><<<t.final_grid(), dim3(32, FINAL_WARPS), 0, s>>>(
        scratch + 4 * t.c, t.nblk, t.c, rs, eps,
        EVAL ? nullptr : st + 2 * t.c, scratch, coef);
  }
  if (dx != nullptr)
    bn_dx<T, VEC, RELU, EVAL><<<t.nblk, t.block(), 0, s>>>(
        (const T*)x, (const T*)dy, mask, t.v, t.c, t.rows, mean, rs, scale,
        bias, eps, coef, (T*)dx);
  return (int)cudaGetLastError();
}

bool tile_ok(const Tile& t) {
  if (t.dtype != 0 && t.dtype != 1) return false;
  if (t.vec != 1 && t.vec != (t.dtype == 1 ? 8 : 4)) return false;
  if (t.v < 0 || t.c < 1 || t.c % t.vec || t.rpb < 1 || t.rows < 1 ||
      t.nblk < 1)
    return false;
  if ((long long)t.nblk * t.rows < t.v) return false;
  return t.threads() <= MAX_THREADS;
}

// FN<T, VEC, RELU, EVAL>(args...) for the tile's type and width and the
// flags
#define SG_BN_DISPATCH(t, flags, FN, ...)                                    \
  do {                                                                       \
    if ((t).dtype == 1 && (t).vec == 8) {                                    \
      SG_BN_FLAGS(__nv_bfloat16, 8, flags, FN, __VA_ARGS__);                 \
    } else if ((t).dtype == 1) {                                             \
      SG_BN_FLAGS(__nv_bfloat16, 1, flags, FN, __VA_ARGS__);                 \
    } else if ((t).vec == 4) {                                               \
      SG_BN_FLAGS(float, 4, flags, FN, __VA_ARGS__);                         \
    } else {                                                                 \
      SG_BN_FLAGS(float, 1, flags, FN, __VA_ARGS__);                         \
    }                                                                        \
  } while (0)
#define SG_BN_FLAGS(T, VEC, flags, FN, ...)                                  \
  switch ((flags) & (RELU_FLAG | EVAL_FLAG)) {                               \
    case 0: return FN<T, VEC, false, false>(__VA_ARGS__);                    \
    case RELU_FLAG: return FN<T, VEC, true, false>(__VA_ARGS__);             \
    case EVAL_FLAG: return FN<T, VEC, false, true>(__VA_ARGS__);             \
    default: return FN<T, VEC, true, true>(__VA_ARGS__);                     \
  }

}  // namespace

// Both entry points take the tile the wrapper planned, 7 ints: dtype (0
// f32, 1 bf16), v rows, c channels, vec channels a thread (16-byte
// vectors: 8 bf16 or 4 f32; or 1), rpb rows of threads a block, rows a
// block, nblk blocks (nblk * rows >= v, (c / vec) * rpb <= 512); flags:
// 1 the ReLU, 2 eval mode, 4 (backward) the parameters' gradients.  They
// launch on `stream` and return cudaGetLastError()
// (cudaErrorInvalidValue for a bad tile or a missing pointer).

// out = [relu](affine(x - mean, scale * rstd, bias)) in x's type.  Train
// mode (mask (v,) bool): st, (nblk + 1) * (2c + 1) f32, takes [mean, rstd,
// n clamped to 1] over the valid rows, then the partials; run_mean /
// run_var (c) f32 move in place; three launches.  Eval: the running
// statistics normalise, st is not read; one launch.
extern "C" int sg_bn_forward(const int* tile, const void* x,
                             const void* mask, const void* scale,
                             const void* bias, void* run_mean, void* run_var,
                             float eps, float momentum, int flags, void* st,
                             void* out, void* stream) {
  const Tile t{tile[0], tile[1], tile[2], tile[3], tile[4], tile[5], tile[6]};
  const bool eval = flags & EVAL_FLAG;
  if (!tile_ok(t) || (!eval && (st == nullptr ||
                                  (t.v > 0 && mask == nullptr))))
    return (int)cudaErrorInvalidValue;
  SG_BN_DISPATCH(t, flags, forward_t, t, x, (const uint8_t*)mask,
                 (const float*)scale, (const float*)bias, (float*)run_mean,
                 (float*)run_var, eps, momentum, (float*)st, out,
                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The backward of sg_bn_forward for dy (v, c) in x's type.  Train mode
// reads the mask and st's statistics and always reduces; eval the running
// statistics, and reduces only with flag 4.  scratch, (4 + 2 nblk) c f32,
// takes [dscale, dbias] over every row first; dx, in x's type, is written
// where not null.  Up to three launches.
extern "C" int sg_bn_backward(const int* tile, const void* x, const void* dy,
                              const void* mask, const void* scale,
                              const void* bias, const void* run_mean,
                              const void* run_var, const void* st, float eps,
                              int flags, void* scratch, void* dx,
                              void* stream) {
  const Tile t{tile[0], tile[1], tile[2], tile[3], tile[4], tile[5], tile[6]};
  const bool eval = flags & EVAL_FLAG;
  const bool reduce = !eval || (flags & PARAMS_FLAG);
  if (!tile_ok(t) || (reduce && scratch == nullptr) ||
      (eval ? run_mean == nullptr || run_var == nullptr
            : st == nullptr || (t.v > 0 && mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  SG_BN_DISPATCH(t, flags, backward_t, t, x, dy, (const uint8_t*)mask,
                 (const float*)scale, (const float*)bias,
                 (const float*)run_mean, (const float*)run_var,
                 (const float*)st, eps, reduce, (float*)scratch, dx,
                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
