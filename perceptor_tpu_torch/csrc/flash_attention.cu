// Flash attention for Hopper (sm_90a): the C interface of the library and
// the fp32 kernels. The bf16 kernels, which the guided SD step runs, are in
// flash_wgmma.cu (the forward up to head_dim 128: TMA loads, wgmma
// products) and flash_mma.cu (the forward at head_dim 512, dq and dk/dv:
// mma.sync, intermediates in registers).
//
// Replaces the Pallas TPU kernels of perceptor_tpu/ops/flash_attention_kernel.py
// for fp32 inputs:
//   flash_fwd_kernel  <- _fwd_kernel     (bf16: flash_wgmma.cu's
//                                         fwd_wgmma_kernel, flash_mma.cu's
//                                         fwd_kernel at d = 512)
//   flash_dq_kernel   <- _bwd_dq_kernel  (bf16: flash_mma.cu's dq_kernel)
//   flash_dkv_kernel  <- _bwd_dkv_kernel (bf16: flash_mma.cu's dkv_kernel)
//
// What bounds them on this card: fp32 arithmetic outside the tensor cores.
// Each site does 4*S^2*d (fwd), 6*S^2*d (dq) and 8*S^2*d (dkv) FLOPs over a
// few MB of q/k/v/o. The design keeps the S x S scores out of device memory
// (online softmax in the forward, recomputation of P from the saved row
// logsumexp in the backward). The kernels here are the simple first
// version: synchronous tile loads into shared memory, all intermediates
// (scores, probabilities, accumulators) in shared memory, products on a
// scalar loop.
//
// Layout: (batch, heads, seq, head_dim) with any batch/head/seq strides
// (unit head_dim stride, 16-byte aligned rows); outputs are contiguous.
// head_dim is padded with zeros only inside shared memory, to the MMA depth
// (48, 80, 128 or 512), never in device memory. Each block owns one
// (batch, head, tile) and loops over the other sequence inside the block:
// the TPU's sequential grid axis becomes that loop, so no block shares an
// accumulator and no atomics are needed (dq over K/V tiles, dk/dv over Q
// tiles), which keeps results deterministic.
//
// Every C entry point returns cudaGetLastError() after its launch, and
// cudaErrorInvalidValue for a (block_q, block_k) pair that has no
// instantiation or does not divide the sequence lengths.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Args;
using flash::kMaxSmem;
using flash::Strides;

constexpr int kThreads = 128;  // four warps per block

constexpr size_t up128(size_t x) { return (x + 127) & ~size_t(127); }

// C (M x N, fp32 in shared memory) (+)= A (M x K) . B (K x N), fp32
// operands in shared memory, on a scalar loop: row-major A is
// A[m * lda + k], column-major A is A[k * lda + m], row-major B is
// B[k * ldb + n], column-major B is B[n * ldb + k].
template <bool kRowA, bool kRowB, int M, int N, int K>
__device__ __forceinline__ void mma_tiles(const float* A, int lda, const float* B, int ldb,
                                          float* C, int ldc, bool accumulate) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i % N;
    float acc = accumulate ? C[m * ldc + n] : 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = kRowA ? A[m * lda + k] : A[k * lda + m];
      const float b = kRowB ? B[k * ldb + n] : B[n * ldb + k];
      acc = fmaf(a, b, acc);
    }
    C[m * ldc + n] = acc;
  }
}

// rows x D elements from device memory (row stride stride_s) into a rows x
// DP shared tile (row stride ld), 16 bytes at a time, zero-filling the
// head_dim padding.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride_s, int rows, int D) {
  constexpr int per_vec = 16 / sizeof(T);
  constexpr int vecs = DP / per_vec;
  const int dvecs = D / per_vec;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, c = i % vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < dvecs) val = *reinterpret_cast<const uint4*>(src + r * stride_s + c * per_vec);
    *reinterpret_cast<uint4*>(dst + r * ld + c * per_vec) = val;
  }
}

__device__ __forceinline__ void zero(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.0f;
}

// row strides in shared memory: head-dim tiles, fp32 score tiles,
// probability tiles, fp32 head-dim accumulators (padded against bank
// conflicts)
template <int BQ, int BK, int DP>
struct Ld {
  static constexpr int H = DP + 8, S = BK + 4, P = BK + 8, A = DP + 4;
};

// -- forward ----------------------------------------------------------------

template <typename T, int BQ, int BK, int DP>
struct FwdSmem {
  using L = Ld<BQ, BK, DP>;
  static constexpr size_t E = sizeof(T);
  static constexpr size_t q = 0;
  static constexpr size_t k = up128(q + BQ * L::H * E);
  static constexpr size_t v = up128(k + BK * L::H * E);
  static constexpr size_t s = up128(v + BK * L::H * E);
  static constexpr size_t p = up128(s + BQ * L::S * 4);
  static constexpr size_t acc = up128(p + BQ * L::P * E);
  static constexpr size_t m = up128(acc + BQ * L::A * 4);
  static constexpr size_t l = up128(m + BQ * 4);
  static constexpr size_t alpha = up128(l + BQ * 4);
  static constexpr size_t total = up128(alpha + BQ * 4);
};

template <typename T, int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk, int D,
                     Strides sq, Strides sk, Strides sv, float scale) {
  using L = Ld<BQ, BK, DP>;
  using SM = FwdSmem<T, BQ, BK, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + SM::q);
  T* sK = reinterpret_cast<T*>(smem + SM::k);
  T* sV = reinterpret_cast<T*>(smem + SM::v);
  float* sS = reinterpret_cast<float*>(smem + SM::s);
  T* sP = reinterpret_cast<T*>(smem + SM::p);
  float* sAcc = reinterpret_cast<float*>(smem + SM::acc);
  float* sM = reinterpret_cast<float*>(smem + SM::m);
  float* sL = reinterpret_cast<float*>(smem + SM::l);
  float* sAlpha = reinterpret_cast<float*>(smem + SM::alpha);

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const T* kb = k + bb * sk.b + hh * sk.h;
  const T* vb = v + bb * sv.b + hh * sv.h;

  load_tile<T, DP>(sQ, L::H, q + bb * sq.b + hh * sq.h + (long long)qt * BQ * sq.s,
                   sq.s, BQ, D);
  zero(sAcc, BQ * L::A);
  for (int r = tid; r < BQ; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }

  // the online softmax gives each row TPR consecutive lanes of one warp
  constexpr int TPR = kThreads / BQ;
  constexpr int CPT = BK / TPR;
  static_assert(TPR >= 1 && TPR <= 32 && CPT * TPR == BK, "bad tile shape");
  const int row = tid / TPR, part = tid % TPR;

  for (int kt = 0; kt < Sk / BK; ++kt) {
    load_tile<T, DP>(sK, L::H, kb + (long long)kt * BK * sk.s, sk.s, BK, D);
    load_tile<T, DP>(sV, L::H, vb + (long long)kt * BK * sv.s, sv.s, BK, D);
    __syncthreads();
    mma_tiles<true, false, BQ, BK, DP>(sQ, L::H, sK, L::H, sS, L::S, false);
    __syncthreads();

    const float* srow = sS + row * L::S + part * CPT;
    float mx = -INFINITY;
    for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, srow[c] * scale);
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = sM[row];
    const float m_new = fmaxf(m_prev, mx);
    T* prow = sP + row * L::P + part * CPT;
    float sum = 0.0f;
    for (int c = 0; c < CPT; ++c) {
      const float p = expf(srow[c] * scale - m_new);
      sum += p;
      prow[c] = static_cast<T>(p);
    }
    for (int off = TPR / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) {
      const float alpha = expf(m_prev - m_new);
      sAlpha[row] = alpha;
      sL[row] = alpha * sL[row] + sum;
      sM[row] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < BQ * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      sAcc[r * L::A + c] *= sAlpha[r];
    }
    __syncthreads();
    mma_tiles<true, true, BQ, DP, BK>(sP, L::P, sV, L::H, sAcc, L::A, true);
    __syncthreads();
  }

  const long long row0 = ((long long)bb * H + hh) * Sq + (long long)qt * BQ;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float l = sL[r];
    const float inv = l == 0.0f ? 1.0f : 1.0f / l;
    o[(row0 + r) * D + c] = static_cast<T>(sAcc[r * L::A + c] * inv);
  }
  for (int r = tid; r < BQ; r += kThreads)
    lse[row0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-37f));
}

// -- backward: dq -------------------------------------------------------------

template <typename T, int BQ, int BK, int DP>
struct DqSmem {
  using L = Ld<BQ, BK, DP>;
  static constexpr size_t E = sizeof(T);
  static constexpr size_t q = 0;
  static constexpr size_t dout = up128(q + BQ * L::H * E);
  static constexpr size_t k = up128(dout + BQ * L::H * E);
  static constexpr size_t v = up128(k + BK * L::H * E);
  static constexpr size_t s = up128(v + BK * L::H * E);
  static constexpr size_t dp = up128(s + BQ * L::S * 4);
  static constexpr size_t ds = up128(dp + BQ * L::S * 4);
  static constexpr size_t acc = up128(ds + BQ * L::P * E);
  static constexpr size_t lse = up128(acc + BQ * L::A * 4);
  static constexpr size_t delta = up128(lse + BQ * 4);
  static constexpr size_t total = up128(delta + BQ * 4);
};

template <typename T, int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Sq, int Sk, int D, Strides sq,
                    Strides sk, Strides sv, Strides sdo, float scale) {
  using L = Ld<BQ, BK, DP>;
  using SM = DqSmem<T, BQ, BK, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + SM::q);
  T* sDO = reinterpret_cast<T*>(smem + SM::dout);
  T* sK = reinterpret_cast<T*>(smem + SM::k);
  T* sV = reinterpret_cast<T*>(smem + SM::v);
  float* sS = reinterpret_cast<float*>(smem + SM::s);
  float* sDP = reinterpret_cast<float*>(smem + SM::dp);
  T* sDS = reinterpret_cast<T*>(smem + SM::ds);
  float* sAcc = reinterpret_cast<float*>(smem + SM::acc);
  float* sLse = reinterpret_cast<float*>(smem + SM::lse);
  float* sDelta = reinterpret_cast<float*>(smem + SM::delta);

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const T* kb = k + bb * sk.b + hh * sk.h;
  const T* vb = v + bb * sv.b + hh * sv.h;
  const long long row0 = ((long long)bb * H + hh) * Sq + (long long)qt * BQ;

  load_tile<T, DP>(sQ, L::H, q + bb * sq.b + hh * sq.h + (long long)qt * BQ * sq.s,
                   sq.s, BQ, D);
  load_tile<T, DP>(sDO, L::H,
                   dout + bb * sdo.b + hh * sdo.h + (long long)qt * BQ * sdo.s, sdo.s,
                   BQ, D);
  zero(sAcc, BQ * L::A);
  for (int r = tid; r < BQ; r += kThreads) {
    sLse[r] = lse[row0 + r];
    sDelta[r] = delta[row0 + r];
  }

  for (int kt = 0; kt < Sk / BK; ++kt) {
    load_tile<T, DP>(sK, L::H, kb + (long long)kt * BK * sk.s, sk.s, BK, D);
    load_tile<T, DP>(sV, L::H, vb + (long long)kt * BK * sv.s, sv.s, BK, D);
    __syncthreads();
    mma_tiles<true, false, BQ, BK, DP>(sQ, L::H, sK, L::H, sS, L::S, false);
    mma_tiles<true, false, BQ, BK, DP>(sDO, L::H, sV, L::H, sDP, L::S, false);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float p = expf(sS[r * L::S + c] * scale - sLse[r]);
      const float ds = p * (sDP[r * L::S + c] - sDelta[r]) * scale;
      sDS[r * L::P + c] = static_cast<T>(ds);
    }
    __syncthreads();
    mma_tiles<true, true, BQ, DP, BK>(sDS, L::P, sK, L::H, sAcc, L::A, true);
    __syncthreads();
  }

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dq[(row0 + r) * D + c] = static_cast<T>(sAcc[r * L::A + c]);
  }
}

// -- backward: dk, dv ---------------------------------------------------------

template <typename T, int BQ, int BK, int DP>
struct DkvSmem {
  using L = Ld<BQ, BK, DP>;
  static constexpr size_t E = sizeof(T);
  static constexpr size_t k = 0;
  static constexpr size_t v = up128(k + BK * L::H * E);
  static constexpr size_t q = up128(v + BK * L::H * E);
  static constexpr size_t dout = up128(q + BQ * L::H * E);
  static constexpr size_t s = up128(dout + BQ * L::H * E);
  static constexpr size_t dp = up128(s + BQ * L::S * 4);
  static constexpr size_t p = up128(dp + BQ * L::S * 4);
  static constexpr size_t ds = up128(p + BQ * L::P * E);
  static constexpr size_t dk = up128(ds + BQ * L::P * E);
  static constexpr size_t dv = up128(dk + BK * L::A * 4);
  static constexpr size_t lse = up128(dv + BK * L::A * 4);
  static constexpr size_t delta = up128(lse + BQ * 4);
  static constexpr size_t total = up128(delta + BQ * 4);
};

template <typename T, int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
                     int D, Strides sq, Strides sk, Strides sv, Strides sdo,
                     float scale) {
  using L = Ld<BQ, BK, DP>;
  using SM = DkvSmem<T, BQ, BK, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + SM::k);
  T* sV = reinterpret_cast<T*>(smem + SM::v);
  T* sQ = reinterpret_cast<T*>(smem + SM::q);
  T* sDO = reinterpret_cast<T*>(smem + SM::dout);
  float* sS = reinterpret_cast<float*>(smem + SM::s);
  float* sDP = reinterpret_cast<float*>(smem + SM::dp);
  T* sP = reinterpret_cast<T*>(smem + SM::p);
  T* sDS = reinterpret_cast<T*>(smem + SM::ds);
  float* sDK = reinterpret_cast<float*>(smem + SM::dk);
  float* sDV = reinterpret_cast<float*>(smem + SM::dv);
  float* sLse = reinterpret_cast<float*>(smem + SM::lse);
  float* sDelta = reinterpret_cast<float*>(smem + SM::delta);

  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const T* qb = q + bb * sq.b + hh * sq.h;
  const T* dob = dout + bb * sdo.b + hh * sdo.h;
  const long long qrow0 = ((long long)bb * H + hh) * Sq;
  const long long krow0 = ((long long)bb * H + hh) * Sk + (long long)kt * BK;

  load_tile<T, DP>(sK, L::H, k + bb * sk.b + hh * sk.h + (long long)kt * BK * sk.s,
                   sk.s, BK, D);
  load_tile<T, DP>(sV, L::H, v + bb * sv.b + hh * sv.h + (long long)kt * BK * sv.s,
                   sv.s, BK, D);
  zero(sDK, BK * L::A);
  zero(sDV, BK * L::A);

  for (int qt = 0; qt < Sq / BQ; ++qt) {
    load_tile<T, DP>(sQ, L::H, qb + (long long)qt * BQ * sq.s, sq.s, BQ, D);
    load_tile<T, DP>(sDO, L::H, dob + (long long)qt * BQ * sdo.s, sdo.s, BQ, D);
    for (int r = tid; r < BQ; r += kThreads) {
      sLse[r] = lse[qrow0 + qt * BQ + r];
      sDelta[r] = delta[qrow0 + qt * BQ + r];
    }
    __syncthreads();
    mma_tiles<true, false, BQ, BK, DP>(sQ, L::H, sK, L::H, sS, L::S, false);
    mma_tiles<true, false, BQ, BK, DP>(sDO, L::H, sV, L::H, sDP, L::S, false);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float p = expf(sS[r * L::S + c] * scale - sLse[r]);
      const float ds = p * (sDP[r * L::S + c] - sDelta[r]) * scale;
      sP[r * L::P + c] = static_cast<T>(p);
      sDS[r * L::P + c] = static_cast<T>(ds);
    }
    __syncthreads();
    // dv += p^T do ; dk += ds^T q  (p^T, ds^T read column-major in place)
    mma_tiles<false, true, BK, DP, BQ>(sP, L::P, sDO, L::H, sDV, L::A, true);
    mma_tiles<false, true, BK, DP, BQ>(sDS, L::P, sQ, L::H, sDK, L::A, true);
    __syncthreads();
  }

  for (int i = tid; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dk[(krow0 + r) * D + c] = static_cast<T>(sDK[r * L::A + c]);
    dv[(krow0 + r) * D + c] = static_cast<T>(sDV[r * L::A + c]);
  }
}

// -- launchers ------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int BQ, int BK, int DP>
cudaError_t launch_fwd(const Args& a) {
  constexpr size_t smem = FwdSmem<T, BQ, BK, DP>::total;
  static_assert(smem <= kMaxSmem, "shared memory above the 227 KB limit");
  cudaError_t err = prepare(flash_fwd_kernel<T, BQ, BK, DP>, smem);
  if (err != cudaSuccess) return err;
  if (a.info) return flash::describe(flash_fwd_kernel<T, BQ, BK, DP>, kThreads, smem, a.info);
  flash_fwd_kernel<T, BQ, BK, DP><<<dim3(a.Sq / BQ, a.H, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out0), static_cast<float*>(a.lse_out), a.H, a.Sq, a.Sk, a.D, a.sq,
      a.sk, a.sv, a.scale);
  return cudaGetLastError();
}

template <typename T, int BQ, int BK, int DP>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = DqSmem<T, BQ, BK, DP>::total;
  static_assert(smem <= kMaxSmem, "shared memory above the 227 KB limit");
  cudaError_t err = prepare(flash_dq_kernel<T, BQ, BK, DP>, smem);
  if (err != cudaSuccess) return err;
  if (a.info) return flash::describe(flash_dq_kernel<T, BQ, BK, DP>, kThreads, smem, a.info);
  flash_dq_kernel<T, BQ, BK, DP><<<dim3(a.Sq / BQ, a.H, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.H, a.Sq, a.Sk, a.D,
      a.sq, a.sk, a.sv, a.sdo, a.scale);
  return cudaGetLastError();
}

template <typename T, int BQ, int BK, int DP>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = DkvSmem<T, BQ, BK, DP>::total;
  static_assert(smem <= kMaxSmem, "shared memory above the 227 KB limit");
  cudaError_t err = prepare(flash_dkv_kernel<T, BQ, BK, DP>, smem);
  if (err != cudaSuccess) return err;
  if (a.info) return flash::describe(flash_dkv_kernel<T, BQ, BK, DP>, kThreads, smem, a.info);
  flash_dkv_kernel<T, BQ, BK, DP><<<dim3(a.Sk / BK, a.H, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.H, a.Sq, a.Sk, a.D, a.sq, a.sk, a.sv, a.sdo, a.scale);
  return cudaGetLastError();
}

// Tile sizes (block_q, block_k) per padded head_dim; the caller passes the
// pair that ops/flash_attention_kernel.py `_kernel_blocks` gives, and a pair
// without an instantiation here is refused. fp32: 32 x 32 up to d = 128;
// at d = 512 (the SD VAE's single head) 16 x 32 for fwd and 16 x 16 for dq
// and dkv, to fit shared memory. The bf16 tiles are in flash_mma.cu.
enum Kernel { kFwd, kDq, kDkv };

template <Kernel K, typename T, int BQ, int BK, int DP>
cudaError_t launch(const Args& a) {
  if (a.block_q != BQ || a.block_k != BK) return cudaErrorInvalidValue;
  if constexpr (K == kFwd) {
    return launch_fwd<T, BQ, BK, DP>(a);
  } else if constexpr (K == kDq) {
    return launch_dq<T, BQ, BK, DP>(a);
  } else {
    return launch_dkv<T, BQ, BK, DP>(a);
  }
}

template <Kernel K>
cudaError_t dispatch_f32(const Args& a) {
  if (a.D <= 48) return launch<K, float, 32, 32, 48>(a);
  if (a.D <= 80) return launch<K, float, 32, 32, 80>(a);
  if (a.D <= 128) return launch<K, float, 32, 32, 128>(a);
  if (a.D <= 512) return launch<K, float, 16, (K == kFwd ? 32 : 16), 512>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Kernel kernel, bool is_f32, const Args& a) {
  if (a.D <= 0 || a.D % 8 || a.block_q <= 0 || a.block_k <= 0 || a.Sq % a.block_q ||
      a.Sk % a.block_k)
    return cudaErrorInvalidValue;
  if (kernel == kFwd) return is_f32 ? dispatch_f32<kFwd>(a) : flash::fwd_bf16(a);
  if (kernel == kDq) return is_f32 ? dispatch_f32<kDq>(a) : flash::dq_bf16(a);
  return is_f32 ? dispatch_f32<kDkv>(a) : flash::dkv_bf16(a);
}

Args make_args(const void* q, const void* k, const void* v, int B, int H, int Sq, int Sk,
               int D, const long long* st, float scale, int block_q, int block_k,
               void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.block_q = block_q;
  a.block_k = block_k;
  a.sq = Strides{st[0], st[1], st[2]};
  a.sk = Strides{st[3], st[4], st[5]};
  a.sv = Strides{st[6], st[7], st[8]};
  a.sdo = Strides{st[9], st[10], st[11]};
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// C interface. `strides` holds (batch, head, seq) element strides of q, k,
// v and, for the backward, do: 12 values (the forward reads the first 9).
// `is_f32` selects fp32 over bf16 inputs; lse and delta are always fp32.
// (block_q, block_k) is the tile pair of the caller's table.

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int H, int Sq, int Sk, int D, const long long* strides,
                         float scale, int is_f32, int block_q, int block_k, void* stream) {
  Args a = make_args(q, k, v, B, H, Sq, Sk, D, strides, scale, block_q, block_k, stream);
  a.out0 = o;
  a.lse_out = lse;
  return dispatch(kFwd, is_f32, a);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int H, int Sq,
                        int Sk, int D, const long long* strides, float scale, int is_f32,
                        int block_q, int block_k, void* stream) {
  Args a = make_args(q, k, v, B, H, Sq, Sk, D, strides, scale, block_q, block_k, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out0 = dq;
  return dispatch(kDq, is_f32, a);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B,
                         int H, int Sq, int Sk, int D, const long long* strides,
                         float scale, int is_f32, int block_q, int block_k, void* stream) {
  Args a = make_args(q, k, v, B, H, Sq, Sk, D, strides, scale, block_q, block_k, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out0 = dk;
  a.out1 = dv;
  return dispatch(kDkv, is_f32, a);
}

// Launches nothing: fills info[5] = {registers, local bytes, dynamic shared
// bytes, threads, resident blocks per SM} of the kernel (0 fwd, 1 dq, 2 dkv)
// that a launch with this head_dim, dtype and tile pair would run.
extern "C" int flash_describe(int kernel, int D, int is_f32, int block_q, int block_k,
                              int* info) {
  if (kernel < kFwd || kernel > kDkv) return cudaErrorInvalidValue;
  const long long strides[12] = {};
  Args a = make_args(nullptr, nullptr, nullptr, 1, 1, block_q, block_k, D, strides, 1.0f,
                     block_q, block_k, nullptr);
  a.info = info;
  return dispatch(static_cast<Kernel>(kernel), is_f32, a);
}
