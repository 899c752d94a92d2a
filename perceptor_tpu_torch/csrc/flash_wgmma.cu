// Flash attention forward for Hopper (sm_90a), bf16: TMA loads, wgmma
// products, and one consumer warpgroup's softmax run while the other's
// products do.
//
// Replaces the Pallas TPU kernel perceptor_tpu/ops/flash_attention_kernel.py
// `_fwd_kernel` (launched by `_forward`) at every bf16 head_dim up to 128:
// flash_mma.cu's `fwd_bf16` sends them here by head_dim, with the pair
// kWgmmaBlockQ x kWgmmaBlockK (d = 32 and 40 run at DP = 64, d = 80 at 128);
// d = 512 stays on flash_mma.cu's `fwd_kernel`. The output is that kernel's:
// O in bf16, contiguous (B, H, Sq, D), and the row logsumexp in natural-log
// units (m * ln 2 + ln l, fp32), which dq and dk/dv read.
//
// What bounds it at d = 64 (SDXL's 70 self-attentions a UNet evaluation):
// the tensor cores, with the exponential unit almost level. Each score
// costs 4 d = 256 FLOPs and one ex2; SDXL's 23.5 G scores a step take 6.1 ms
// of the tensor cores at 989 TFLOP/s and 5.6 ms of the SFU (16 ex2 a clock
// an SM). A block that runs the softmax and the products one after the other
// cannot pass about half of the FLOP roofline; the design overlaps them.
//
// - One block an SM, persistent: it walks over 128-row Q tiles
//   (tile = blockIdx.x + i * gridDim.x). Three warpgroups: a producer and
//   two consumers, each consumer owning 64 of the tile's rows.
// - The producer (one thread) loads Q (two buffers, so the next tile's Q
//   arrives while this one is used) and a ring of K/V stages with the
//   Tensor Memory Accelerator from 4-D tensor maps (head_dim, seq, head,
//   batch) over the caller's strided views; TMA zero-fills head_dim past D,
//   so padding to DP costs no copy. Full and empty `mbarrier`s pair each
//   buffer with its consumers. `setmaxnreg` moves registers from the
//   producer (24) to the consumers (240).
// - A consumer computes S = Q K^T with `wgmma` from shared memory (both
//   operands K-major, 128-byte swizzle), the online softmax in fp32
//   registers (ex2.approx on scores scaled by scale * log2 e; row maxima and
//   sums across the four lanes that share a row), and O += P V with P
//   rounded to bf16 in registers as the A operand and V read MN-major
//   (transposed) from shared memory.
// - Overlap: the two consumers take turns on two named barriers to issue
//   their products (O += P_j V_j, then S_{j+1} = Q K_{j+1}^T); each issues
//   right after the other, so while one waits on its products and then
//   runs its softmax, the other's products keep the tensor cores busy.
//
// Layout: (batch, heads, seq, head_dim) inputs with any batch / head / seq
// strides (unit head_dim stride, 16-byte aligned strides and base); D a
// multiple of 8 up to DP (64 or 128); Sq and Sk multiples of 128.

#include <cuda.h>  // CUtensorMap and its enums (types only)
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

constexpr int kBQ = kWgmmaBlockQ;  // 2 consumer warpgroups x 64 rows
constexpr int kBK = kWgmmaBlockK;  // keys a K/V tile
constexpr int kThreads = 384;      // producer + 2 consumer warpgroups
constexpr int kRow = 128;          // bytes of a swizzled row: 64 bf16
constexpr int kConsumerWarps = 8;
constexpr int kTurn0 = 1, kTurn1 = 2;  // named barriers (0 is __syncthreads)

// -- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the 4-D tensor map at coordinates (c0 .. c3), innermost first,
// into shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of a register that an
// in-flight wgmma reads or writes across the fence or wait around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units; the tiles are 1024-byte
// aligned, so the base offset is 0
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
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

// -- wgmma ------------------------------------------------------------------
//
// A 64 x N fp32 accumulator of a warpgroup: thread (warp w, lane: g = lane
// / 4, t = lane % 4) holds d[4j], d[4j + 1] at row 16 w + g, columns 8j + 2t,
// 8j + 2t + 1 and d[4j + 2], d[4j + 3] at row 16 w + g + 8. A 64 x 16 bf16 A
// operand in registers holds, as pairs, rows 16 w + g / + 8 at columns 2t..
// (a[0], a[1]) and 2t + 8.. (a[2], a[3]): two neighbouring 8-column blocks
// of an accumulator, rounded and paired.

// d (64 x 128, fp32) (+)= A (64 x 16, shared) . B (128 x 16, shared)^T: both
// operands K-major (row-major tiles of 128-byte swizzled rows)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) . B (16 x 64, shared,
// MN-major: rows of 128-byte swizzled 64-wide rows, read transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers) . B (16 x 128, shared,
// MN-major: rows of 128-byte swizzled 128-wide rows, read transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// -- the kernel ---------------------------------------------------------------

// shared memory in bytes (after aligning the base to 1024): two Q tiles,
// [ST] K tiles, [ST] V tiles, then the barriers. A tile of R rows is DP / 64
// column blocks of R swizzled 128-byte rows.
template <int DP>
struct WgTile {
  static_assert(DP == 64 || DP == 128, "DP is 64 or 128");
  static constexpr int NB = DP / 64;        // 64-column blocks of a row
  static constexpr int ST = DP == 64 ? 3 : 2;  // K/V ring stages
  static constexpr uint32_t q_bytes = kBQ * DP * 2;
  static constexpr uint32_t kv_bytes = kBK * DP * 2;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + 2 * size_t(q_bytes);
  static constexpr size_t v = k + ST * size_t(kv_bytes);
  static constexpr size_t bars = v + ST * size_t(kv_bytes);
  // full Q [2], empty Q [2], full K [ST], empty K [ST], full V [ST], empty V [ST]
  static constexpr int n_bars = 4 + 4 * ST;
  static constexpr size_t total = bars + n_bars * 8 + 1024;  // + the base's alignment
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                     __grid_constant__ const CUtensorMap tv, bf16* __restrict__ o,
                     float* __restrict__ lse, int B, int H, int Sq, int Sk, int D, float scale) {
  using T = WgTile<DP>;
  constexpr int NB = T::NB, ST = T::ST;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 8 rows: tiles start on 1024 bytes
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + T::q, sK = base + T::k, sV = base + T::v;
  const uint32_t bar = base + T::bars;
  auto full_q = [&](int i) { return bar + 8 * i; };
  auto empty_q = [&](int i) { return bar + 8 * (2 + i); };
  auto full_k = [&](int s) { return bar + 8 * (4 + s); };
  auto empty_k = [&](int s) { return bar + 8 * (4 + ST + s); };
  auto full_v = [&](int s) { return bar + 8 * (4 + 2 * ST + s); };
  auto empty_v = [&](int s) { return bar + 8 * (4 + 3 * ST + s); };

  const int nq = Sq / kBQ, nk = Sk / kBK;
  const int ntiles = nq * H * B;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_q(i), 1);
      mbar_init(empty_q(i), kConsumerWarps);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread issues every load ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0, st = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
        const int qt = tile % nq, bh = tile / nq;
        const int hh = bh % H, bb = bh / H;
        const int qb = it & 1;
        mbar_wait(empty_q(qb), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(full_q(qb), T::q_bytes);
#pragma unroll
        for (int cb = 0; cb < NB; ++cb)
          tma_load(sQ + qb * T::q_bytes + cb * kBQ * kRow, &tq, full_q(qb), cb * 64, qt * kBQ, hh,
                   bb);
        for (int j = 0; j < nk; ++j) {
          mbar_wait(empty_k(st), ph ^ 1);
          mbar_expect_tx(full_k(st), T::kv_bytes);
#pragma unroll
          for (int cb = 0; cb < NB; ++cb)
            tma_load(sK + st * T::kv_bytes + cb * kBK * kRow, &tk, full_k(st), cb * 64, j * kBK,
                     hh, bb);
          mbar_wait(empty_v(st), ph ^ 1);
          mbar_expect_tx(full_v(st), T::kv_bytes);
#pragma unroll
          for (int cb = 0; cb < NB; ++cb)
            tma_load(sV + st * T::kv_bytes + cb * kBK * kRow, &tv, full_v(st), cb * 64, j * kBK,
                     hh, bb);
          if (++st == ST) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // -- consumers: 64 rows each ---------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int my_turn = c == 0 ? kTurn0 : kTurn1, other_turn = c == 0 ? kTurn1 : kTurn0;
    const float sl2 = scale * kLog2e;
    if (c == 1) named_arrive(kTurn0);  // consumer 0 issues first

    float s[kBK / 2];  // S (64 x kBK) accumulator, then P in fp32
    float acc[DP / 2];  // O (64 x DP) accumulator
    uint32_t p[kBK / 4];  // P in bf16, A operands of kBK / 16 products
    int it = 0, kst = 0, vst = 0;
    uint32_t kph = 0, vph = 0;

    // S = Q K^T on this consumer's 64 rows and the K tile at `k_tile`
    auto issue_s = [&](uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // 16 columns: 32 bytes into a 64-column block
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = sw128_desc(q_tile + (kk / 4) * kBQ * kRow + off, 16, 1024);
        const uint64_t db = sw128_desc(k_tile + (kk / 4) * kBK * kRow + off, 16, 1024);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
    };
    // O += P V with V's tile at `v_tile` (MN-major: 8-key groups 1024 bytes
    // apart, 64-column blocks kBK rows apart)
    auto issue_pv = [&](uint32_t v_tile) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_rs<DP>(acc, a, sw128_desc(v_tile + kk * 16 * kRow, kBK * kRow, 1024));
      }
    };
    auto release = [&](uint32_t b) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b);
    };

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      const int qt = tile % nq, bh = tile / nq;
      const bool last_tile = tile + static_cast<int>(gridDim.x) >= ntiles;
      const int qb = it & 1;
      // this consumer's 64 rows of the Q tile
      const uint32_t q_tile = sQ + qb * T::q_bytes + c * 64 * kRow;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
      float m_run[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
      float l_run[2] = {0.0f, 0.0f};            // this lane's part of the row sum

      mbar_wait(full_q(qb), (it >> 1) & 1);
      mbar_wait(full_k(kst), kph);
      named_sync(my_turn);
      fence_regs(s);
      wgmma_fence();
      issue_s(q_tile, sK + kst * T::kv_bytes);
      wgmma_commit();
      named_arrive(other_turn);
      wgmma_wait_all();
      fence_regs(s);
      release(empty_k(kst));
      if (++kst == ST) {
        kst = 0;
        kph ^= 1;
      }

      // online softmax of S on this lane's rows 16 warp + g (s[4i], s[4i + 1])
      // and + 8 (s[4i + 2], s[4i + 3]): P in s (fp32, for the row sums) and
      // in p (bf16), O rescaled
      auto softmax = [&]() {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
        float alpha[2], neg_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * sl2);
          alpha[r] = ex2(m_run[r] - m_new);
          m_run[r] = m_new;
          neg_m[r] = -m_new;
          l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          s[i] = ex2(fmaf(s[i], sl2, neg_m[(i >> 1) & 1]));
          l_run[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int i = 0; i < kBK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      };

      // every K/V tile but the last: O += P_j V_j, then S = Q K_{j+1}^T. The
      // last is peeled off, so that no product is issued on a divergent path
      // (ptxas would serialize every wgmma of the kernel).
      for (int j = 0; j + 1 < nk; ++j) {
        softmax();
        mbar_wait(full_v(vst), vph);
        mbar_wait(full_k(kst), kph);
        named_sync(my_turn);
        fence_regs(acc);
        fence_regs(p);
        fence_regs(s);
        wgmma_fence();
        issue_pv(sV + vst * T::kv_bytes);
        issue_s(q_tile, sK + kst * T::kv_bytes);
        wgmma_commit();
        named_arrive(other_turn);
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(p);
        fence_regs(s);
        release(empty_v(vst));
        release(empty_k(kst));
        if (++vst == ST) {
          vst = 0;
          vph ^= 1;
        }
        if (++kst == ST) {
          kst = 0;
          kph ^= 1;
        }
      }
      softmax();
      mbar_wait(full_v(vst), vph);
      named_sync(my_turn);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      issue_pv(sV + vst * T::kv_bytes);
      wgmma_commit();
      // the last turn of the last tile: consumer 0 takes no further one
      if (!(c == 1 && last_tile)) named_arrive(other_turn);
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p);
      release(empty_v(vst));
      if (++vst == ST) {
        vst = 0;
        vph ^= 1;
      }
      release(empty_q(qb));

      // O / l and the row logsumexp
      const float l[2] = {quad_sum(l_run[0]), quad_sum(l_run[1])};
      const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
      const long long row0 = static_cast<long long>(bh) * Sq + qt * kBQ + c * 64 + warp * 16 + g;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = i * 8 + 2 * t;
        if (i * 8 < D) {
          *reinterpret_cast<uint32_t*>(o + row0 * D + col) =
              pack_bf16(acc[4 * i] * inv[0], acc[4 * i + 1] * inv[0]);
          *reinterpret_cast<uint32_t*>(o + (row0 + 8) * D + col) =
              pack_bf16(acc[4 * i + 2] * inv[1], acc[4 * i + 3] * inv[1]);
        }
      }
      if (t == 0) {
        lse[row0] = m_run[0] * kLn2 + logf(l[0]);
        lse[row0 + 8] = m_run[1] * kLn2 + logf(l[1]);
      }
    }
  }
}

// -- the host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime API
// (cudaGetDriverEntryPoint), so that the library links libcudart alone
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// the 4-D map (head_dim, seq, head, batch) over a strided bf16 (B, H, S, D)
// view, boxes of 64 head_dim columns (one 128-byte swizzled row) by `rows`;
// false if the encoder refuses it
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D, Strides st,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  const long long elems[3] = {st.s, st.h, st.b};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of extent 1 may carry any stride; TMA takes a nonzero one
    strides[i] = dims[i + 1] == 1 && elems[i] == 0 ? 16 : cuuint64_t(elems[i]) * 2;
  }
  const cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_fwd_wgmma(const Args& a) {
  using T = WgTile<DP>;
  static_assert(T::total <= kMaxSmem, "shared memory above the 227 KB limit");
  auto kernel = fwd_wgmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::total));
  if (err != cudaSuccess) return err;
  if (a.info) return describe(kernel, kThreads, T::total, a.info);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, a.B, a.H, a.Sq, a.D, a.sq, kBQ) ||
      !make_map(&tk, a.k, a.B, a.H, a.Sk, a.D, a.sk, kBK) ||
      !make_map(&tv, a.v, a.B, a.H, a.Sk, a.D, a.sv, kBK))
    return cudaErrorInvalidValue;
  const int tiles = a.Sq / kBQ * a.H * a.B;
  kernel<<<tiles < sms ? tiles : sms, kThreads, T::total, a.stream>>>(
      tq, tk, tv, static_cast<bf16*>(a.out0), static_cast<float*>(a.lse_out), a.B, a.H, a.Sq,
      a.Sk, a.D, a.scale);
  return cudaGetLastError();
}

}  // namespace

// The pair (kWgmmaBlockQ, kWgmmaBlockK): DP = 64 up to d = 64, else 128
cudaError_t fwd_wgmma_bf16(const Args& a) {
  if (a.block_q != kBQ || a.block_k != kBK) return cudaErrorInvalidValue;
  if (a.D <= 64) return launch_fwd_wgmma<64>(a);
  if (a.D <= 128) return launch_fwd_wgmma<128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace flash
