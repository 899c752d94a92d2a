// Flash attention for Hopper (sm_90a), bf16: the forward at head_dim 512
// and both backward kernels, with the scores, the probabilities, their
// gradients and the fp32 accumulators held in registers.
//
// Replaces the Pallas TPU kernels of perceptor_tpu/ops/flash_attention_kernel.py:
//   fwd_kernel  <- _fwd_kernel      (launched by _forward; d <= 128 runs
//                                    flash_wgmma.cu's fwd_wgmma_kernel)
//   dq_kernel   <- _bwd_dq_kernel   (launched by _backward)
//   dkv_kernel  <- _bwd_dkv_kernel  (launched by _backward)
// The fp32 kernels are in flash_attention.cu.
//
// What bounds them: tensor-core operations. At the guided SD step's shapes
// (S = 1024..4096, head_dim 40/80/512) the forward does 4*S^2*d, dq 6*S^2*d
// and dk/dv 8*S^2*d FLOPs over a few MB, hundreds of FLOPs per byte. So
// the design keeps every S x S intermediate out of device memory and, unlike
// the first version of these kernels, out of shared memory too:
//
// - Products are `mma.sync.m16n8k16` bf16 -> fp32 through inline PTX, with
//   operands loaded by `ldmatrix` / `ldmatrix.trans`. Chosen over `wgmma`
//   because its fp32 accumulator layout is, pair by pair, its A-operand
//   layout: dS (dq) and P^T, dS^T (dk/dv) at d <= 128 are rounded to bf16
//   in registers and fed straight into the next product. Each warp owns a
//   16-row slab and needs no descriptor, swizzle mode or warpgroup fence.
// - Online softmax in registers: the row max and sum are reduced across
//   the four lanes that share a row with __shfl_xor_sync; exponentials are
//   ex2.approx on scores scaled by scale * log2(e); lse is written in
//   natural-log units (m * ln 2 + ln l), as the backward reads it. dq
//   recomputes P = exp(scale S - lse) from it; each lane holds lse and
//   delta of its two rows in registers for the whole K/V loop.
// - The tiles of the looped-over sequence (K/V in the forward and dq; Q,
//   dO, lse and delta in dk/dv) are double-buffered with cp.async: the next
//   tile's copies are issued before the current tile's products, and a tile
//   costs two barriers. The block's own tiles (Q, Q and dO, or K and V) are
//   loaded once and read from shared memory at each tile (for dq, keeping
//   Q's and dO's A-fragments in registers saved no time on an H100 at
//   d = 80 and spilled at d = 40).
// - Shared rows are padded by 16 bytes (pitch (DP + 8) * 2 with DP a
//   multiple of 16, an odd number of 16-byte units), so the eight row
//   addresses of each ldmatrix phase fall in distinct bank groups.
// - head_dim is padded with zeros to DP (48, 80, 128, 512) in shared memory
//   only; the padding columns are zeroed once and never copied into.
// - d = 512 (the VAE's single head): 16 rows x 512 fp32 outputs would take
//   256 registers a thread. The output columns are split over CW = 4 warps
//   that share a 16-row slab; those warps also split the keys (forward, dq)
//   or queries (dk/dv) of the score product, so no warp idles in it. The
//   forward exchanges row maxima and sums through a small shared array,
//   and P (or dS, or P^T and dS^T) is staged once per tile as bf16 in
//   shared memory for the second product; dq exchanges nothing else, since
//   lse and delta are given. The backward kernels at d <= 128 run with
//   CW = 1, and then exchange and stage nothing.
//
// Layout: (batch, heads, seq, head_dim) inputs with any batch/head/seq
// strides (unit head_dim stride, 16-byte aligned rows); outputs contiguous.
// Each block owns one (batch, head, tile) and loops over the other sequence,
// so no two blocks share an output row: no atomics, deterministic results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {
namespace {

typedef __nv_bfloat16 bf16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// -- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- fragments ----------------------------------------------------------------
//
// m16n8k16 accumulator of a 16 x 8 tile: lane (g = lane / 4, t = lane % 4)
// holds c[0], c[1] at row g, columns 2t, 2t + 1 and c[2], c[3] at row g + 8.
// The A operand of a 16 x 16 tile holds, as bf16 pairs, rows g / g + 8 at
// columns 2t.. (a[0], a[1]) and 2t + 8.. (a[2], a[3]): the accumulators of
// two neighbouring 8-column tiles, rounded and paired.

// A operand: rows m0.., columns k0.. of a row-major shared tile (pitch LD)
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int k0,
                                       int lane) {
  ldsm_x4(a, tile + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// A operand from accumulators: 8-column tiles 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc (16 x N) += a . X^T, X = rows n0..n0+N-1, columns k0..k0+15 of a
// row-major shared tile: the score products (Q K^T; K Q^T, V dO^T).
template <int N, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const uint32_t (&a)[4],
                                        const bf16* tile, int n0, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    uint32_t b[4];
    ldsm_x4(b, tile + (n0 + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                   ((lane >> 3) & 1) * 8);
    mma(acc[2 * j], a, b[0], b[1]);
    mma(acc[2 * j + 1], a, b[2], b[3]);
  }
  if constexpr (N % 16 != 0) {  // one 8-column tile left
    uint32_t b[2];
    ldsm_x2(b, tile + (n0 + N - 8 + (lane & 7)) * LD + k0 + ((lane >> 3) & 1) * 8);
    mma(acc[N / 8 - 1], a, b[0], b[1]);
  }
}

// acc (16 x N) += a . X, X = rows k0..k0+15, columns n0..n0+N-1 of a
// row-major shared tile (read transposed): the value products (P V;
// P^T dO, dS^T Q). N is a multiple of 16.
template <int N, int LD>
__device__ __forceinline__ void mma_ab(float (&acc)[N / 8][4], const uint32_t (&a)[4],
                                       const bf16* tile, int k0, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    uint32_t b[4];
    ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + j * 16 +
                     (lane >> 4) * 8);
    mma(acc[2 * j], a, b[0], b[1]);
    mma(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// accumulators of a 16 x N slab, rounded to bf16, into rows m0.. and
// columns n0.. of a row-major shared tile
template <int N, int LD>
__device__ __forceinline__ void store_acc(bf16* tile, const float (&c)[N / 8][4], int m0,
                                          int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    bf16* p = tile + (m0 + g) * LD + n0 + j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(c[j][0], c[j][1]);
    *reinterpret_cast<uint32_t*>(p + 8 * LD) = pack_bf16(c[j][2], c[j][3]);
  }
}

// accumulators of a 16 x N slab, times the row factors, into rows
// row0, row0 + 8 of a contiguous (rows, D) bf16 array, columns n0..; whole
// 8-column tiles at or past D (head_dim padding) are skipped
template <int N>
__device__ __forceinline__ void write_rows(bf16* out, const float (&c)[N / 8][4],
                                           long long row0, int n0, int D, float f0, float f1,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col < D) {
      *reinterpret_cast<uint32_t*>(out + (row0 + g) * D + col) =
          pack_bf16(c[j][0] * f0, c[j][1] * f0);
      *reinterpret_cast<uint32_t*>(out + (row0 + g + 8) * D + col) =
          pack_bf16(c[j][2] * f1, c[j][3] * f1);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
}

// -- tile copies ---------------------------------------------------------------

// ROWS x D bf16 from device memory (row stride `stride` elements) into a
// shared tile of pitch LD, 16 bytes a copy
template <int ROWS, int LD, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long stride, int D) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * chunks; i += NT) {
    const int r = i / chunks, c = i - r * chunks;
    cp_async16(dst + r * LD + c * 8, src + r * stride + c * 8);
  }
}

// N fp32 values (N a multiple of 4, 16-byte aligned) into shared memory
template <int N, int NT>
__device__ __forceinline__ void copy_floats(float* dst, const float* src) {
  for (int i = threadIdx.x; i < N / 4; i += NT) cp_async16(dst + i * 4, src + i * 4);
}

// zero columns D..DP-1 of ROWS rows of pitch LD (head_dim padding)
template <int ROWS, int LD, int DP, int NT>
__device__ __forceinline__ void zero_padding(bf16* dst, int D) {
  const int pad = (DP - D) / 8;
  for (int i = threadIdx.x; i < ROWS * pad; i += NT) {
    const int r = i / pad, c = D / 8 + i % pad;
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// -- forward ------------------------------------------------------------------

// RW x CW warps: warp (rw, cw) owns Q rows 16 rw.., keys SN cw.. of each
// score tile and output columns ON cw..
template <int DP, int RW, int CW, int BK>
struct FwdTile {
  static constexpr int NT = RW * CW * 32, BQ = 16 * RW;
  static constexpr int SN = BK / CW, ON = DP / CW;
  static constexpr int LD = DP + 8, LDP = BK + 8;
  static_assert(DP % 16 == 0 && BK % 16 == 0 && SN % 8 == 0 && ON % 16 == 0, "bad tile");
  // the head_dims up to 128 run flash_wgmma.cu's forward: this one splits
  // the output columns of d = 512 over CW warps, which exchange row maxima
  // and sums and stage P in shared memory
  static_assert(CW > 1, "the forward splits its columns over warps");
  // shared memory in bytes: Q; [stage][K, V] tiles; P (bf16); the [CW][BQ]
  // exchange array
  static constexpr size_t q = 0;
  static constexpr size_t kv = q + size_t(BQ) * LD * 2;
  static constexpr size_t p = kv + size_t(4) * BK * LD * 2;
  static constexpr size_t red = p + size_t(BQ) * LDP * 2;
  static constexpr size_t total = red + size_t(CW) * BQ * 4;
};

template <int DP, int RW, int CW, int BK>
__global__ void __launch_bounds__(RW* CW * 32)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int H, int Sq, int Sk, int D, Strides sq, Strides sk, Strides sv, float scale) {
  using T = FwdTile<DP, RW, CW, BK>;
  constexpr int LD = T::LD, BQ = T::BQ, SN = T::SN, ON = T::ON;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + T::q);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::kv);
  bf16* sP = reinterpret_cast<bf16*>(smem + T::p);
  float* red = reinterpret_cast<float*>(smem + T::red);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % RW, cw = warp / RW;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const bf16* kb = k + bb * sk.b + hh * sk.h;
  const bf16* vb = v + bb * sv.b + hh * sv.h;
  const int nk = Sk / BK;

  auto copy_kv = [&](int stage, int kt) {
    bf16* dst = sKV + stage * 2 * BK * LD;
    copy_rows<BK, LD, T::NT>(dst, kb + (long long)kt * BK * sk.s, sk.s, D);
    copy_rows<BK, LD, T::NT>(dst + BK * LD, vb + (long long)kt * BK * sv.s, sv.s, D);
  };

  zero_padding<BQ, LD, DP, T::NT>(sQ, D);
  zero_padding<4 * BK, LD, DP, T::NT>(sKV, D);
  copy_rows<BQ, LD, T::NT>(sQ, q + bb * sq.b + hh * sq.h + (long long)qt * BQ * sq.s, sq.s,
                           D);
  copy_kv(0, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc[ON / 8][4];
  zero_acc(acc);
  float m_run[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l_run[2] = {0.0f, 0.0f};            // this lane's part of the row sum

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) copy_kv(stage ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const bf16* sK = sKV + stage * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;

    // S = Q K^T for rows 16 rw.., keys SN cw..
    float s[SN / 8][4];
    zero_acc(s);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, sQ, rw * 16, kk * 16, lane);
      mma_abt<SN, LD>(s, a, sK, cw * SN, kk * 16, lane);
    }

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < SN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sl2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    if (t == 0) {
      red[cw * BQ + rw * 16 + g] = mx[0];
      red[cw * BQ + rw * 16 + g + 8] = mx[1];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      mx[0] = fmaxf(mx[0], red[c * BQ + rw * 16 + g]);
      mx[1] = fmaxf(mx[1], red[c * BQ + rw * 16 + g + 8]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = ex2(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < SN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < ON / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V, P staged in bf16 as the A operand
    store_acc<SN, T::LDP>(sP, s, rw * 16, cw * SN, lane);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      load_a<T::LDP>(a, sP, rw * 16, kk * 16, lane);
      mma_ab<ON, LD>(acc, a, sV, kk * 16, cw * ON, lane);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  float l[2] = {quad_sum(l_run[0]), quad_sum(l_run[1])};
  if (t == 0) {
    red[cw * BQ + rw * 16 + g] = l[0];
    red[cw * BQ + rw * 16 + g + 8] = l[1];
  }
  __syncthreads();
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    l[0] += red[c * BQ + rw * 16 + g];
    l[1] += red[c * BQ + rw * 16 + g + 8];
  }
  const long long row0 = ((long long)bb * H + hh) * Sq + (long long)qt * BQ + rw * 16;
  write_rows<ON>(o, acc, row0, cw * ON, D, 1.0f / l[0], 1.0f / l[1], lane);
  if (cw == 0 && t == 0) {
    lse[row0 + g] = m_run[0] * kLn2 + logf(l[0]);
    lse[row0 + g + 8] = m_run[1] * kLn2 + logf(l[1]);
  }
}

// -- backward: dk, dv -----------------------------------------------------------

// RW x CW warps: warp (rw, cw) owns keys 16 rw.., queries QN cw.. of each
// transposed score tile and dK / dV columns ON cw..
template <int DP, int RW, int CW, int BQ>
struct DkvTile {
  static constexpr int NT = RW * CW * 32, BK = 16 * RW;
  static constexpr int QN = BQ / CW, ON = DP / CW;
  static constexpr int LD = DP + 8, LDP = BQ + 8;
  // resident blocks per SM asked of the compiler: at d <= 48 the UNet's
  // 4096-key site has 512 blocks; left free, ptxas takes 167 registers a
  // thread, 3 blocks fit an SM and the grid runs in 1.3 waves. Capped at
  // 128 registers (a few bytes of spill), 4 fit and it runs in one.
  static constexpr int MIN_BLOCKS = DP <= 48 ? 4 : 1;
  static_assert(DP % 16 == 0 && BQ % 16 == 0 && QN % 8 == 0 && ON % 16 == 0, "bad tile");
  // shared memory in bytes: K, V; [stage][Q, dO] tiles; [stage][lse, delta]
  // rows; P^T and dS^T (bf16) when CW > 1
  static constexpr size_t k = 0;
  static constexpr size_t v = k + size_t(BK) * LD * 2;
  static constexpr size_t qdo = v + size_t(BK) * LD * 2;
  static constexpr size_t rows = qdo + size_t(4) * BQ * LD * 2;
  static constexpr size_t p = rows + size_t(4) * BQ * 4;
  static constexpr size_t total = p + (CW > 1 ? size_t(2) * BK * LDP * 2 : 0);
};

template <int DP, int RW, int CW, int BQ>
__global__ void __launch_bounds__(RW* CW * 32, (DkvTile<DP, RW, CW, BQ>::MIN_BLOCKS))
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk, int D,
               Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  using T = DkvTile<DP, RW, CW, BQ>;
  constexpr int LD = T::LD, BK = T::BK, QN = T::QN, ON = T::ON;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + T::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::v);
  bf16* sQdO = reinterpret_cast<bf16*>(smem + T::qdo);
  float* sRows = reinterpret_cast<float*>(smem + T::rows);
  bf16* sPt = reinterpret_cast<bf16*>(smem + T::p);
  bf16* sDSt = sPt + BK * T::LDP;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % RW, cw = warp / RW;
  const int t = lane & 3;
  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const bf16* qb = q + bb * sq.b + hh * sq.h;
  const bf16* dob = dout + bb * sdo.b + hh * sdo.h;
  const long long qrow0 = ((long long)bb * H + hh) * Sq;
  const int nq = Sq / BQ;

  auto copy_q = [&](int stage, int qt) {
    bf16* dst = sQdO + stage * 2 * BQ * LD;
    copy_rows<BQ, LD, T::NT>(dst, qb + (long long)qt * BQ * sq.s, sq.s, D);
    copy_rows<BQ, LD, T::NT>(dst + BQ * LD, dob + (long long)qt * BQ * sdo.s, sdo.s, D);
    float* rows = sRows + stage * 2 * BQ;
    copy_floats<BQ, T::NT>(rows, lse + qrow0 + (long long)qt * BQ);
    copy_floats<BQ, T::NT>(rows + BQ, delta + qrow0 + (long long)qt * BQ);
  };

  zero_padding<2 * BK, LD, DP, T::NT>(sK, D);  // sK and sV are contiguous
  zero_padding<4 * BQ, LD, DP, T::NT>(sQdO, D);
  copy_rows<BK, LD, T::NT>(sK, k + bb * sk.b + hh * sk.h + (long long)kt * BK * sk.s, sk.s,
                           D);
  copy_rows<BK, LD, T::NT>(sV, v + bb * sv.b + hh * sv.h + (long long)kt * BK * sv.s, sv.s,
                           D);
  copy_q(0, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float dk_acc[ON / 8][4], dv_acc[ON / 8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  for (int qt = 0; qt < nq; ++qt) {
    const int stage = qt & 1;
    if (qt + 1 < nq) copy_q(stage ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const bf16* sQ = sQdO + stage * 2 * BQ * LD;
    const bf16* sDO = sQ + BQ * LD;
    const float* sLse = sRows + stage * 2 * BQ;
    const float* sDelta = sLse + BQ;

    // S^T = K Q^T and dP^T = V dO^T for keys 16 rw.., queries QN cw..
    float st[QN / 8][4], dpt[QN / 8][4];
    zero_acc(st);
    zero_acc(dpt);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, sK, rw * 16, kk * 16, lane);
      mma_abt<QN, LD>(st, a, sQ, cw * QN, kk * 16, lane);
      load_a<LD>(a, sV, rw * 16, kk * 16, lane);
      mma_abt<QN, LD>(dpt, a, sDO, cw * QN, kk * 16, lane);
    }

    // P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T - delta) scale; the
    // columns are queries, so lse and delta vary along them
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      const int c = cw * QN + j * 8 + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(sLse + c);
      const float2 dl = *reinterpret_cast<const float2*>(sDelta + c);
      const float l0 = ls.x * kLog2e, l1 = ls.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(st[j][e], sl2, -((e & 1) ? l1 : l0)));
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T in bf16 as A operands
    if constexpr (CW == 1) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, st, kk);
        mma_ab<ON, LD>(dv_acc, a, sDO, kk * 16, 0, lane);
        acc_to_a(a, dpt, kk);
        mma_ab<ON, LD>(dk_acc, a, sQ, kk * 16, 0, lane);
      }
    } else {
      store_acc<QN, T::LDP>(sPt, st, rw * 16, cw * QN, lane);
      store_acc<QN, T::LDP>(sDSt, dpt, rw * 16, cw * QN, lane);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        load_a<T::LDP>(a, sPt, rw * 16, kk * 16, lane);
        mma_ab<ON, LD>(dv_acc, a, sDO, kk * 16, cw * ON, lane);
        load_a<T::LDP>(a, sDSt, rw * 16, kk * 16, lane);
        mma_ab<ON, LD>(dk_acc, a, sQ, kk * 16, cw * ON, lane);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  const long long krow0 = ((long long)bb * H + hh) * Sk + (long long)kt * BK + rw * 16;
  write_rows<ON>(dk, dk_acc, krow0, cw * ON, D, 1.0f, 1.0f, lane);
  write_rows<ON>(dv, dv_acc, krow0, cw * ON, D, 1.0f, 1.0f, lane);
}

// -- backward: dq ----------------------------------------------------------------

// RW x CW warps: warp (rw, cw) owns Q rows 16 rw.., keys SN cw.. of each
// score tile and dQ columns ON cw..
template <int DP, int RW, int CW, int BK>
struct DqTile {
  static constexpr int NT = RW * CW * 32, BQ = 16 * RW;
  static constexpr int SN = BK / CW, ON = DP / CW;
  static constexpr int LD = DP + 8, LDS = BK + 8;
  // at d <= 48 the UNet's 4096-row site has 256 blocks of 128 rows:
  // asking for 2 resident blocks of 256 threads a SM (128 registers a
  // thread) runs them in one wave
  static constexpr int MIN_BLOCKS = DP <= 48 ? 512 / NT : 1;
  static_assert(DP % 16 == 0 && BK % 16 == 0 && SN % 8 == 0 && ON % 16 == 0, "bad tile");
  // shared memory in bytes: Q, dO; [stage][K, V] tiles; dS (bf16) when
  // CW > 1
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + size_t(BQ) * LD * 2;
  static constexpr size_t kv = dout + size_t(BQ) * LD * 2;
  static constexpr size_t ds = kv + size_t(4) * BK * LD * 2;
  static constexpr size_t total = ds + (CW > 1 ? size_t(BQ) * LDS * 2 : 0);
};

template <int DP, int RW, int CW, int BK>
__global__ void __launch_bounds__(RW* CW * 32, (DqTile<DP, RW, CW, BK>::MIN_BLOCKS))
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, int Sq, int Sk, int D, Strides sq, Strides sk,
              Strides sv, Strides sdo, float scale) {
  using T = DqTile<DP, RW, CW, BK>;
  constexpr int LD = T::LD, BQ = T::BQ, SN = T::SN, ON = T::ON;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + T::q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + T::dout);
  bf16* sKV = reinterpret_cast<bf16*>(smem + T::kv);
  bf16* sDS = reinterpret_cast<bf16*>(smem + T::ds);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % RW, cw = warp / RW;
  const int g = lane >> 2;
  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const bf16* kb = k + bb * sk.b + hh * sk.h;
  const bf16* vb = v + bb * sv.b + hh * sv.h;
  const long long row0 = ((long long)bb * H + hh) * Sq + (long long)qt * BQ + rw * 16;
  const int nk = Sk / BK;

  auto copy_kv = [&](int stage, int kt) {
    bf16* dst = sKV + stage * 2 * BK * LD;
    copy_rows<BK, LD, T::NT>(dst, kb + (long long)kt * BK * sk.s, sk.s, D);
    copy_rows<BK, LD, T::NT>(dst + BK * LD, vb + (long long)kt * BK * sv.s, sv.s, D);
  };

  zero_padding<2 * BQ, LD, DP, T::NT>(sQ, D);  // sQ and sDO are contiguous
  zero_padding<4 * BK, LD, DP, T::NT>(sKV, D);
  copy_rows<BQ, LD, T::NT>(sQ, q + bb * sq.b + hh * sq.h + (long long)qt * BQ * sq.s, sq.s,
                           D);
  copy_rows<BQ, LD, T::NT>(sDO, dout + bb * sdo.b + hh * sdo.h + (long long)qt * BQ * sdo.s,
                           sdo.s, D);
  copy_kv(0, 0);
  cp_async_commit();

  // lse (log2 units) and delta of this lane's rows g and g + 8: constant
  // along a score row, so read once into registers
  const float lse2[2] = {lse[row0 + g] * kLog2e, lse[row0 + g + 8] * kLog2e};
  const float dlt[2] = {delta[row0 + g], delta[row0 + g + 8]};
  const float sl2 = scale * kLog2e;
  float acc[ON / 8][4];
  zero_acc(acc);

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) copy_kv(stage ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const bf16* sK = sKV + stage * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;

    // S = Q K^T and dP = dO V^T for rows 16 rw.., keys SN cw..
    float s[SN / 8][4], dp[SN / 8][4];
    zero_acc(s);
    zero_acc(dp);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, sQ, rw * 16, kk * 16, lane);
      mma_abt<SN, LD>(s, a, sK, cw * SN, kk * 16, lane);
      load_a<LD>(a, sDO, rw * 16, kk * 16, lane);
      mma_abt<SN, LD>(dp, a, sV, cw * SN, kk * 16, lane);
    }

    // P = exp(scale S - lse), dS = P (dP - delta) scale, on rows g
    // (e = 0, 1) and g + 8 (e = 2, 3); dS overwrites dP
#pragma unroll
    for (int j = 0; j < SN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], sl2, -lse2[e >> 1]));
        dp[j][e] = p * (dp[j][e] - dlt[e >> 1]) * scale;
      }
    }

    // dQ += dS K, dS in bf16 as the A operand, K read transposed
    if constexpr (CW == 1) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, dp, kk);
        mma_ab<ON, LD>(acc, a, sK, kk * 16, 0, lane);
      }
    } else {
      store_acc<SN, T::LDS>(sDS, dp, rw * 16, cw * SN, lane);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        load_a<T::LDS>(a, sDS, rw * 16, kk * 16, lane);
        mma_ab<ON, LD>(acc, a, sK, kk * 16, cw * ON, lane);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  write_rows<ON>(dq, acc, row0, cw * ON, D, 1.0f, 1.0f, lane);
}

// -- launchers ------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DP, int RW, int CW, int BK>
cudaError_t launch_fwd(const Args& a) {
  using T = FwdTile<DP, RW, CW, BK>;
  static_assert(T::total <= kMaxSmem, "shared memory above the 227 KB limit");
  if (a.block_q != T::BQ || a.block_k != BK) return cudaErrorInvalidValue;
  auto kernel = fwd_kernel<DP, RW, CW, BK>;
  cudaError_t err = prepare(kernel, T::total);
  if (err != cudaSuccess) return err;
  if (a.info) return describe(kernel, T::NT, T::total, a.info);
  kernel<<<dim3(a.Sq / T::BQ, a.H, a.B), T::NT, T::total, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out0),
      static_cast<float*>(a.lse_out), a.H, a.Sq, a.Sk, a.D, a.sq, a.sk, a.sv, a.scale);
  return cudaGetLastError();
}

template <int DP, int RW, int CW, int BQ>
cudaError_t launch_dkv(const Args& a) {
  using T = DkvTile<DP, RW, CW, BQ>;
  static_assert(T::total <= kMaxSmem, "shared memory above the 227 KB limit");
  if (a.block_q != BQ || a.block_k != T::BK) return cudaErrorInvalidValue;
  auto kernel = dkv_kernel<DP, RW, CW, BQ>;
  cudaError_t err = prepare(kernel, T::total);
  if (err != cudaSuccess) return err;
  if (a.info) return describe(kernel, T::NT, T::total, a.info);
  kernel<<<dim3(a.Sk / T::BK, a.H, a.B), T::NT, T::total, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.H, a.Sq, a.Sk, a.D, a.sq,
      a.sk, a.sv, a.sdo, a.scale);
  return cudaGetLastError();
}

template <int DP, int RW, int CW, int BK>
cudaError_t launch_dq(const Args& a) {
  using T = DqTile<DP, RW, CW, BK>;
  static_assert(T::total <= kMaxSmem, "shared memory above the 227 KB limit");
  if (a.block_q != T::BQ || a.block_k != BK) return cudaErrorInvalidValue;
  auto kernel = dq_kernel<DP, RW, CW, BK>;
  cudaError_t err = prepare(kernel, T::total);
  if (err != cudaSuccess) return err;
  if (a.info) return describe(kernel, T::NT, T::total, a.info);
  kernel<<<dim3(a.Sq / T::BQ, a.H, a.B), T::NT, T::total, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.H, a.Sq, a.Sk, a.D, a.sq, a.sk, a.sv, a.sdo, a.scale);
  return cudaGetLastError();
}

}  // namespace

// Tiles per padded head_dim; (block_q, block_k) must be the pair that
// ops/flash_attention_kernel.py `_kernel_blocks` gives, or the launcher
// returns cudaErrorInvalidValue.
//   forward: d <= 128: flash_wgmma.cu            (kWgmmaBlockQ, kWgmmaBlockK)
//            d <= 512: 2 x 4 warps, 32 Q rows, 32-key tiles    (32, 32)
//   dk/dv:   d <= 80: 4 warps x 16 keys, 64-query tiles        (64, 64)
//            d <= 128: 4 warps x 16 keys, 32-query tiles       (32, 64)
//            d <= 512: 2 x 4 warps, 32 keys, 32-query tiles    (32, 32)
//   dq:      d <= 48: 8 warps x 16 Q rows, 64-key tiles        (128, 64)
//            d <= 128: 4 warps x 16 Q rows, 64-key tiles       (64, 64)
//            d <= 512: 2 x 4 warps, 32 Q rows, 32-key tiles    (32, 32)
cudaError_t fwd_bf16(const Args& a) {
  if (a.D <= 128) return fwd_wgmma_bf16(a);
  if (a.D <= 512) return launch_fwd<512, 2, 4, 32>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dkv_bf16(const Args& a) {
  if (a.D <= 48) return launch_dkv<48, 4, 1, 64>(a);
  if (a.D <= 80) return launch_dkv<80, 4, 1, 64>(a);
  if (a.D <= 128) return launch_dkv<128, 4, 1, 32>(a);
  if (a.D <= 512) return launch_dkv<512, 2, 4, 32>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dq_bf16(const Args& a) {
  if (a.D <= 48) return launch_dq<48, 8, 1, 64>(a);
  if (a.D <= 80) return launch_dq<80, 4, 1, 64>(a);
  if (a.D <= 128) return launch_dq<128, 4, 1, 64>(a);
  if (a.D <= 512) return launch_dq<512, 2, 4, 32>(a);
  return cudaErrorInvalidValue;
}

}  // namespace flash
