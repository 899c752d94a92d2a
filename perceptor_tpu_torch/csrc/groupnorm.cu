// GroupNorm + activation over NCHW tensors for Hopper (sm_90a): the forward
// (statistics, then the normalized, scaled and activated output) and the
// backward (per-channel sums, then the input gradient). The C interface is
// gn_forward and gn_backward at the end of this file; the wrapper is
// perceptor_tpu_torch/ops/groupnorm.py, which hands the kernels NCHW
// memory.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA
// (perceptor_tpu/ops/groupnorm.py), which fuses it. The port computed it as
// a chain of plain fp32 PyTorch ops, about 12 full-tensor passes (some 86
// bytes moved per element of a bf16 input) and 23 launches in the forward,
// 20 passes (about 190 bytes per element) and 35 launches in the backward.
//
// What bounds it on this card: bytes, at 3.35 TB/s. The arithmetic is a
// handful of fp32 operations per element. The forward reads x twice (once
// for the statistics, once for the output) and writes the output once: 6
// bytes per element of bf16. The backward reads x and dy twice and writes
// dx: 10 bytes per element. Every statistic and the activation are fp32;
// the output is rounded once, to its dtype.
//
// Design. Each block owns a piece of one (n, c) row of H * W elements: its
// channel's scale and bias and its group's statistics are constants of the
// block, so the sweeps need no index arithmetic beyond the row. The rows of
// one group lie next to each other in memory, and so do their partial sums
// in the workspace. A group's statistics need every block of the group, so
// each pass that reduces writes one fp32 partial per block (the split
// reduction), and the next launch folds the partials of its group in a
// fixed order: every block of a group computes the same mean and rstd to
// the bit, no atomics are used, and the results are deterministic. The
// wrapper chooses how many blocks share a row from the shape alone (at
// least two waves of the card where the tensor is large enough), so a
// batch-1 tensor with a few large groups (the VAE at 512 x 512: 32 groups of
// 2 MB) keeps every SM busy. Loads and stores are 8 elements wide (16 bytes
// of bf16) where H * W allows, element by element otherwise.
//
// The statistics are sums of x - K and (x - K)^2 with K the group's first
// element, the shifted-data form of E[x^2] - E[x]^2, so a mean far from zero
// does not cancel the variance away.
//
// Launches: two per forward (gn_stats_kernel, gn_apply_kernel) and two per
// backward (gn_bwd_sums_kernel, gn_bwd_dx_kernel). Every C entry point
// returns cudaGetLastError() after each launch, and cudaErrorInvalidValue
// for arguments it does not take.

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kVec = 8;  // elements a thread loads at once: 16 bytes of bf16

enum Act { kSilu = 0, kRelu = 1, kGelu = 2, kNone = 3 };
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a tensor cast
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  const Pack<T, V> pack = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = to_f(pack.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  Pack<T, V> pack;
#pragma unroll
  for (int j = 0; j < V; ++j) pack.v[j] = from_f<T>(f[j]);
  *reinterpret_cast<Pack<T, V>*>(p) = pack;
}

__device__ __forceinline__ float act_forward(float h, int act) {
  switch (act) {
    case kSilu: return h / (1.0f + expf(-h));
    case kRelu: return fmaxf(h, 0.0f);
    case kGelu: return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
    default: return h;
  }
}

// d act / d h
__device__ __forceinline__ float act_grad(float h, int act) {
  switch (act) {
    case kSilu: {
      const float s = 1.0f / (1.0f + expf(-h));
      return s * (1.0f + h * (1.0f - s));
    }
    case kRelu: return h > 0.0f ? 1.0f : 0.0f;
    case kGelu: {
      // Phi(h) + h phi(h)
      const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));
      return cdf + h * expf(-0.5f * h * h) * 0.39894228040143268f;
    }
    default: return 1.0f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the element type of a dtype code; false for an unknown code
template <typename F>
bool with_dtype(int code, F&& f) {
  switch (code) {
    case kF32: f(Tag<float>{}); return true;
    case kBF16: f(Tag<__nv_bfloat16>{}); return true;
    case kF16: f(Tag<__half>{}); return true;
    default: return false;
  }
}


constexpr int kMaxChunks = 65535;  // gridDim.y

struct Shape {
  int C, HW, G, Cg;
  int chunks, chunk_vecs;  // blocks per row, vectors per block
  int per_sample;          // scale and bias are (N, C), else (C,)
  int act;
  float eps;
};

// The sums over the block of (a, b), in every thread; the same order in
// every block of a launch. blockDim.x is a multiple of 32.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warps[kMaxThreads / 32];
  __shared__ float2 total;
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < (blockDim.x >> 5) ? warps[lane] : make_float2(0.0f, 0.0f);
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// The block's (n, c) row and its vector range [v0, v1) of the row.
struct Block {
  int row, n, c, g, v0, v1;
  __device__ __forceinline__ Block(const Shape& s, int vec) {
    row = blockIdx.x;
    n = row / s.C;
    c = row - n * s.C;
    g = c / s.Cg;
    v0 = blockIdx.y * s.chunk_vecs;
    v1 = min(v0 + s.chunk_vecs, s.HW / vec);
  }
  // the first row of the block's group
  __device__ __forceinline__ size_t group_row(const Shape& s) const {
    return static_cast<size_t>(n) * s.C + static_cast<size_t>(g) * s.Cg;
  }
};

// Pass 1 of the forward: the block's partial sums of x - K and (x - K)^2,
// K the group's first element.
template <typename Tx, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_stats_kernel(const Tx* __restrict__ x, float2* __restrict__ partial, Shape s) {
  const Block b(s, V);
  const float shift = to_f(x[b.group_row(s) * s.HW]);
  const Tx* xr = x + static_cast<size_t>(b.row) * s.HW;
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 2
  for (int v = b.v0 + threadIdx.x; v < b.v1; v += blockDim.x) {
    float f[V];
    load<Tx, V>(xr + static_cast<size_t>(v) * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = f[j] - shift;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
  }
  const float2 t = block_sum2(s1, s2);
  if (threadIdx.x == 0) partial[static_cast<size_t>(b.row) * s.chunks + blockIdx.y] = t;
}

// The group's (mean, rstd), folded from its rows' partials: the group's
// Cg * chunks partials lie next to each other.
template <typename Tx>
__device__ __forceinline__ float2 group_stats(const Tx* x, const float2* partial, const Shape& s,
                                              const Block& b) {
  const size_t first = b.group_row(s);
  const float2* p = partial + first * s.chunks;
  const int count = s.Cg * s.chunks;
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    s1 += p[i].x;
    s2 += p[i].y;
  }
  const float2 t = block_sum2(s1, s2);
  const float m = static_cast<float>(static_cast<long long>(s.Cg) * s.HW);
  const float d = t.x / m;
  const float var = fmaxf(t.y / m - d * d, 0.0f);
  return make_float2(to_f(x[first * s.HW]) + d, rsqrtf(var + s.eps));
}

// Pass 2 of the forward: act((x - mean) * rstd * scale + bias) in y's dtype;
// the first block of each group also writes the group's mean and rstd.
template <typename Tx, typename Ty, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_apply_kernel(const Tx* __restrict__ x, const float2* __restrict__ partial,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    Ty* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, Shape s) {
  const Block b(s, V);
  const float2 stats = group_stats(x, partial, s, b);
  const float mean = stats.x, rstd = stats.y;
  if (threadIdx.x == 0 && blockIdx.y == 0 && b.c == b.g * s.Cg) {
    mean_out[b.n * s.G + b.g] = mean;
    rstd_out[b.n * s.G + b.g] = rstd;
  }
  const int a = s.per_sample ? b.row : b.c;
  const float sc = scale[a], bi = bias[a];
  const size_t base = static_cast<size_t>(b.row) * s.HW;
#pragma unroll 2
  for (int v = b.v0 + threadIdx.x; v < b.v1; v += blockDim.x) {
    float f[V];
    load<Tx, V>(x + base + static_cast<size_t>(v) * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = act_forward((f[j] - mean) * rstd * sc + bi, s.act);
    store<Ty, V>(y + base + static_cast<size_t>(v) * V, f);
  }
}

// dh = dy * act'(h) and xhat of V elements, h = xhat * scale + bias
template <typename Tx, typename Ty, int V>
__device__ __forceinline__ void recompute(const Tx* x, const Ty* dy, float mean, float rstd,
                                          float sc, float bi, int act, float (&xhat)[V],
                                          float (&dh)[V]) {
  load<Tx, V>(x, xhat);
  load<Ty, V>(dy, dh);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    xhat[j] = (xhat[j] - mean) * rstd;
    dh[j] *= act_grad(xhat[j] * sc + bi, act);
  }
}

// Pass 1 of the backward: the block's partial sums of dh and dh * xhat.
template <typename Tx, typename Ty, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_sums_kernel(const Tx* __restrict__ x, const Ty* __restrict__ dy,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       float2* __restrict__ partial, Shape s) {
  const Block b(s, V);
  const float mu = mean[b.n * s.G + b.g], r = rstd[b.n * s.G + b.g];
  const int a = s.per_sample ? b.row : b.c;
  const float sc = scale[a], bi = bias[a];
  const size_t base = static_cast<size_t>(b.row) * s.HW;
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 2
  for (int v = b.v0 + threadIdx.x; v < b.v1; v += blockDim.x) {
    float xhat[V], dh[V];
    const size_t at = base + static_cast<size_t>(v) * V;
    recompute<Tx, Ty, V>(x + at, dy + at, mu, r, sc, bi, s.act, xhat, dh);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1 += dh[j];
      s2 = fmaf(dh[j], xhat[j], s2);
    }
  }
  const float2 t = block_sum2(s1, s2);
  if (threadIdx.x == 0) partial[static_cast<size_t>(b.row) * s.chunks + blockIdx.y] = t;
}

// Pass 2 of the backward: with A = sum_c scale_c sum dh / m and B = sum_c
// scale_c sum dh xhat / m over the group's channels,
// dx = rstd * (dh * scale - A - xhat * B) in x's dtype; the first block of
// each row also writes the row's sums of dh and dh * xhat (the gradients of
// bias and scale before any sum over the batch).
template <typename Tx, typename Ty, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_dx_kernel(const Tx* __restrict__ x, const Ty* __restrict__ dy,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     const float2* __restrict__ partial, Tx* __restrict__ dx,
                     float* __restrict__ dh_sum, float* __restrict__ dhx_sum, Shape s) {
  const Block b(s, V);
  const size_t first = b.group_row(s);
  float sa = 0.0f, sb = 0.0f;
  for (int j = threadIdx.x; j < s.Cg; j += blockDim.x) {
    const float2* p = partial + (first + j) * s.chunks;
    float pa = 0.0f, pb = 0.0f;
    for (int k = 0; k < s.chunks; ++k) {
      pa += p[k].x;
      pb += p[k].y;
    }
    const float sj = scale[s.per_sample ? first + j : b.g * s.Cg + j];
    sa = fmaf(pa, sj, sa);
    sb = fmaf(pb, sj, sb);
    if (blockIdx.y == 0 && first + j == static_cast<size_t>(b.row)) {
      dh_sum[b.row] = pa;
      dhx_sum[b.row] = pb;
    }
  }
  const float2 t = block_sum2(sa, sb);
  const float m = static_cast<float>(static_cast<long long>(s.Cg) * s.HW);
  const float A = t.x / m, B = t.y / m;
  const float mu = mean[b.n * s.G + b.g], r = rstd[b.n * s.G + b.g];
  const int a = s.per_sample ? b.row : b.c;
  const float sc = scale[a], bi = bias[a];
  const size_t base = static_cast<size_t>(b.row) * s.HW;
#pragma unroll 2
  for (int v = b.v0 + threadIdx.x; v < b.v1; v += blockDim.x) {
    float xhat[V], dh[V];
    const size_t at = base + static_cast<size_t>(v) * V;
    recompute<Tx, Ty, V>(x + at, dy + at, mu, r, sc, bi, s.act, xhat, dh);
#pragma unroll
    for (int j = 0; j < V; ++j) xhat[j] = r * (dh[j] * sc - A - xhat[j] * B);
    store<Tx, V>(dx + at, xhat);
  }
}

bool valid(int N, const Shape& s, int vec, int threads) {
  const long long vecs = vec > 0 ? s.HW / vec : 0;
  return N > 0 && s.C > 0 && s.HW > 0 && s.G > 0 && s.C % s.G == 0 && s.Cg == s.C / s.G &&
         (vec == 1 || vec == kVec) && s.HW % vec == 0 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 && s.chunks >= 1 &&
         s.chunks <= kMaxChunks && s.chunk_vecs >= 1 &&
         static_cast<long long>(s.chunks) * s.chunk_vecs >= vecs &&
         static_cast<long long>(s.chunks - 1) * s.chunk_vecs < vecs &&
         static_cast<long long>(N) * s.C <= 0x7fffffffLL && s.act >= kSilu && s.act <= kNone;
}

Shape make_shape(int C, int HW, int G, int per_sample, int act, float eps, int chunks,
                 int chunk_vecs) {
  Shape s;
  s.C = C;
  s.HW = HW;
  s.G = G;
  s.Cg = G > 0 ? C / G : 0;
  s.chunks = chunks;
  s.chunk_vecs = chunk_vecs;
  s.per_sample = per_sample;
  s.act = act;
  s.eps = eps;
  return s;
}

}  // namespace

// y = act(group_norm(x) * scale + bias) over (N, C, H * W) contiguous x,
// with mean and rstd (N, G) fp32 written for the backward. partial is an
// fp32 workspace of N * C * chunks * 2 values. Dtype codes: 0 float32,
// 1 bfloat16, 2 float16; act: 0 silu, 1 relu, 2 gelu (exact), 3 none.
// vec (8 or 1), threads, chunks and chunk_vecs come from the wrapper's
// launch_shape.
extern "C" int gn_forward(const void* x, const void* scale, const void* bias, void* y,
                          void* mean, void* rstd, void* partial, int N, int C, int HW, int G,
                          int per_sample, float eps, int act, int x_dtype, int y_dtype, int vec,
                          int threads, int chunks, int chunk_vecs, void* stream) {
  const Shape s = make_shape(C, HW, G, per_sample, act, eps, chunks, chunk_vecs);
  if (!valid(N, s, vec, threads)) return cudaErrorInvalidValue;
  const dim3 grid(N * C, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool known = with_dtype(x_dtype, [&](auto tx) {
    using Tx = typename decltype(tx)::type;
    const Tx* xp = static_cast<const Tx*>(x);
    float2* pp = static_cast<float2*>(partial);
    if (vec == kVec) {
      gn_stats_kernel<Tx, kVec><<<grid, threads, 0, st>>>(xp, pp, s);
    } else {
      gn_stats_kernel<Tx, 1><<<grid, threads, 0, st>>>(xp, pp, s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return;
    const bool known_y = with_dtype(y_dtype, [&](auto ty) {
      using Ty = typename decltype(ty)::type;
      const float* sp = static_cast<const float*>(scale);
      const float* bp = static_cast<const float*>(bias);
      Ty* yp = static_cast<Ty*>(y);
      float* mp = static_cast<float*>(mean);
      float* rp = static_cast<float*>(rstd);
      if (vec == kVec) {
        gn_apply_kernel<Tx, Ty, kVec><<<grid, threads, 0, st>>>(xp, pp, sp, bp, yp, mp, rp, s);
      } else {
        gn_apply_kernel<Tx, Ty, 1><<<grid, threads, 0, st>>>(xp, pp, sp, bp, yp, mp, rp, s);
      }
      err = cudaGetLastError();
    });
    if (!known_y) err = cudaErrorInvalidValue;
  });
  return known ? err : cudaErrorInvalidValue;
}

// dx of y = act(group_norm(x) * scale + bias) given dy (the dtype dy_dtype),
// the forward's mean and rstd; dh_sum and dhx_sum (N * C fp32) receive each
// row's sums of dh and dh * xhat. partial as in gn_forward.
extern "C" int gn_backward(const void* x, const void* dy, const void* scale, const void* bias,
                           const void* mean, const void* rstd, void* dx, void* dh_sum,
                           void* dhx_sum, void* partial, int N, int C, int HW, int G,
                           int per_sample, int act, int x_dtype, int dy_dtype, int vec,
                           int threads, int chunks, int chunk_vecs, void* stream) {
  const Shape s = make_shape(C, HW, G, per_sample, act, 0.0f, chunks, chunk_vecs);
  if (!valid(N, s, vec, threads)) return cudaErrorInvalidValue;
  const dim3 grid(N * C, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  bool known_dy = true;
  const bool known = with_dtype(x_dtype, [&](auto tx) {
    known_dy = with_dtype(dy_dtype, [&](auto ty) {
      using Tx = typename decltype(tx)::type;
      using Ty = typename decltype(ty)::type;
      const Tx* xp = static_cast<const Tx*>(x);
      const Ty* dyp = static_cast<const Ty*>(dy);
      const float* sp = static_cast<const float*>(scale);
      const float* bp = static_cast<const float*>(bias);
      const float* mp = static_cast<const float*>(mean);
      const float* rp = static_cast<const float*>(rstd);
      float2* pp = static_cast<float2*>(partial);
      if (vec == kVec) {
        gn_bwd_sums_kernel<Tx, Ty, kVec><<<grid, threads, 0, st>>>(xp, dyp, sp, bp, mp, rp, pp, s);
      } else {
        gn_bwd_sums_kernel<Tx, Ty, 1><<<grid, threads, 0, st>>>(xp, dyp, sp, bp, mp, rp, pp, s);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return;
      Tx* dxp = static_cast<Tx*>(dx);
      float* hs = static_cast<float*>(dh_sum);
      float* hxs = static_cast<float*>(dhx_sum);
      if (vec == kVec) {
        gn_bwd_dx_kernel<Tx, Ty, kVec>
            <<<grid, threads, 0, st>>>(xp, dyp, sp, bp, mp, rp, pp, dxp, hs, hxs, s);
      } else {
        gn_bwd_dx_kernel<Tx, Ty, 1>
            <<<grid, threads, 0, st>>>(xp, dyp, sp, bp, mp, rp, pp, dxp, hs, hxs, s);
      }
      err = cudaGetLastError();
    });
  });
  return known && known_dy ? err : cudaErrorInvalidValue;
}
