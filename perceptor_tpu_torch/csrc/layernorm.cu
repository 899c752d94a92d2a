// Residual add + LayerNorm over rows of bf16 channels for Hopper (sm_90a),
// writing the bf16 operand of the products that follow. The C interface is
// add_layer_norm at the end of this file; the wrapper is
// perceptor_tpu_torch/ops/layernorm.py, which the SD UNet's
// BasicTransformerBlock calls.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA
// (perceptor_tpu/models/stable_diffusion/unet.py BasicTransformerBlock,
// nn.LayerNorm(dtype=float32)(x).astype(dtype)), which fuses it with the
// residual add and the cast. The port ran it as a chain of PyTorch ops: the
// bf16 add x + h, a bf16 -> fp32 copy, ATen's fp32 layer_norm and one
// fp32 -> bf16 cast in each Linear that reads the result (three for
// self-attention's q, k and v), 13 launches and about 90 bytes per residual
// element in a transformer block.
//
// What bounds it on this card: bytes, at 3.35 TB/s. Per element, with the
// branch h: x and h read, r = bf16(x + h) and y written, 8 bytes; without
// h: x read and y written, 4 bytes. The arithmetic is a few fp32
// operations per element.
//
// Arithmetic, as the JAX reference's: r rounded to bf16 first (exactly the
// bf16 add x + h), the mean and the biased variance of the rounded row in
// fp32, y = (r - mean) * rsqrt(var + eps) * w + b in fp32 with w and b
// fp32, rounded once to bf16. The variance is the mean of the squared
// deviations, a second pass over the row held in registers, not
// E[r^2] - E[r]^2.
//
// Design for the byte bound. One warp owns one row of C channels (C a
// multiple of 8, at most 2048): lane l takes the 16-byte vectors l, l + 32,
// l + 64, ..., so each step of the warp's loads covers 512 contiguous
// bytes. Every load of the row is issued before any arithmetic, and the
// row stays in registers as packed bf16 (at most 8 vectors a lane, at
// C = 2048), so x and h are read once and nothing goes through shared
// memory. The two reductions (the sum, then the sum of squared deviations)
// are warp shuffles. The vectors a lane holds are a template parameter (1
// to 8), so the loops unroll. A block holds kRows warps, one row each, and
// the grid covers the rows: SDXL's 8,192 and 32,768 rows make 2,048 and
// 8,192 blocks, many waves of the 132 SMs; SD-1.5's fewest at b8, 1,024
// rows, make 256.
//
// One launch a call. The C entry point returns cudaErrorInvalidValue for
// arguments it does not take, else cudaGetLastError() after the launch.

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 8;      // bf16 elements in a 16-byte vector
constexpr int kMaxVecs = 8;  // vectors a lane holds: C up to 8 x 32 x 8 = 2048
constexpr int kRows = 4;     // rows (warps) a block
constexpr int kThreads = kRows * 32;

// 8 bf16, loaded and stored as one 16-byte vector
union Vec {
  uint4 u;
  __nv_bfloat162 h[kVec / 2];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack(const Vec& v, float (&f)[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 p = __bfloat1622float2(v.h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

// One row per warp: r = bf16(x + h) (with kAdd), then
// y = bf16((r - mean) * rstd * w + b). Rows of `vecs` vectors; a lane holds
// vectors lane + 32 i for i < NV.
template <int NV, bool kAdd>
__global__ void __launch_bounds__(kThreads)
    add_ln_kernel(const uint4* __restrict__ x, const uint4* __restrict__ h,
                  const float4* __restrict__ w, const float4* __restrict__ b,
                  uint4* __restrict__ r, uint4* __restrict__ y, int rows, int vecs, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: the shuffles below see all 32 lanes
  const int64_t base = row * vecs;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  Vec v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    v[i].u = j < vecs ? x[base + j] : zero;
  }
  if constexpr (kAdd) {
    Vec g[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      g[i].u = j < vecs ? h[base + j] : zero;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int k = 0; k < kVec / 2; ++k) {
        const float2 a = __bfloat1622float2(v[i].h[k]);
        const float2 c = __bfloat1622float2(g[i].h[k]);
        v[i].h[k] = __floats2bfloat162_rn(a.x + c.x, a.y + c.y);
      }
      const int j = lane + 32 * i;
      if (j < vecs) r[base + j] = v[i].u;
    }
  }

  // padding vectors hold zeros, so they add nothing to the sum
  const float channels = static_cast<float>(vecs * kVec);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float f[kVec];
    unpack(v[i], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) sum += f[k];
  }
  const float mean = warp_sum(sum) / channels;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < vecs) {
      float f[kVec];
      unpack(v[i], f);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = f[k] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / channels + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < vecs) {
      float f[kVec];
      unpack(v[i], f);
      const float4 w0 = w[2 * j], w1 = w[2 * j + 1], b0 = b[2 * j], b1 = b[2 * j + 1];
      const float wf[kVec] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float bf[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      Vec out;
#pragma unroll
      for (int k = 0; k < kVec / 2; ++k) {
        out.h[k] = __floats2bfloat162_rn((f[2 * k] - mean) * rstd * wf[2 * k] + bf[2 * k],
                                         (f[2 * k + 1] - mean) * rstd * wf[2 * k + 1] +
                                             bf[2 * k + 1]);
      }
      y[base + j] = out.u;
    }
  }
}

// The build with the least NV >= nv.
template <bool kAdd, int NV = 1>
void launch(int nv, dim3 grid, cudaStream_t st, const uint4* x, const uint4* h,
            const float4* w, const float4* b, uint4* r, uint4* y, int rows, int vecs,
            float eps) {
  if constexpr (NV < kMaxVecs) {
    if (nv > NV) return launch<kAdd, NV + 1>(nv, grid, st, x, h, w, b, r, y, rows, vecs, eps);
  }
  add_ln_kernel<NV, kAdd><<<grid, kThreads, 0, st>>>(x, h, w, b, r, y, rows, vecs, eps);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, h (or null), r (null where h is): rows x C bf16, contiguous; w, b: C
// fp32; y: rows x C bf16. With h, r = bf16(x + h) and y the LayerNorm of r;
// without, y the LayerNorm of x and r untouched. Every pointer 16-byte
// aligned; C a multiple of 8 from 8 to 2048.
extern "C" int add_layer_norm(const void* x, const void* h, const void* w, const void* b,
                              void* r, void* y, int rows, int C, float eps, void* stream) {
  if (rows < 1 || C < kVec || C % kVec != 0 || C > kVec * 32 * kMaxVecs) {
    return cudaErrorInvalidValue;
  }
  if (!aligned(x) || !aligned(w) || !aligned(b) || !aligned(y) ||
      (h != nullptr && (r == nullptr || !aligned(h) || !aligned(r)))) {
    return cudaErrorInvalidValue;
  }
  const int vecs = C / kVec;
  const int nv = (vecs + 31) / 32;
  const dim3 grid((rows + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xp = static_cast<const uint4*>(x);
  const uint4* hp = static_cast<const uint4*>(h);
  const float4* wp = static_cast<const float4*>(w);
  const float4* bp = static_cast<const float4*>(b);
  uint4* rp = static_cast<uint4*>(r);
  uint4* yp = static_cast<uint4*>(y);
  if (h != nullptr) {
    launch<true>(nv, grid, st, xp, hp, wp, bp, rp, yp, rows, vecs, eps);
  } else {
    launch<false>(nv, grid, st, xp, hp, wp, bp, rp, yp, rows, vecs, eps);
  }
  return cudaGetLastError();
}
