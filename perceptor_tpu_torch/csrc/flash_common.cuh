// Launch arguments shared by the flash-attention sources of this directory:
// flash_attention.cu (the C interface and the fp32 kernels) and
// flash_mma.cu (the bf16 forward, dq and dk/dv on mma.sync).
#pragma once

#include <cuda_runtime.h>

namespace flash {

struct Strides {
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1, *lse_out;
  int B, H, Sq, Sk, D;
  // the (block_q, block_k) tile pair the caller chose; a dispatch that has
  // no instantiation for it returns cudaErrorInvalidValue
  int block_q, block_k;
  Strides sq, sk, sv, sdo;
  float scale;
  cudaStream_t stream;
  // when set, the dispatch launches nothing and fills info with the chosen
  // kernel's {registers, local bytes, dynamic shared bytes, threads,
  // resident blocks per SM}
  int* info;
};

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use

// info for `kernel` at `threads` threads and `smem` dynamic shared bytes
// (after its shared-memory attribute has been raised)
template <typename Kernel>
cudaError_t describe(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(smem);
  info[3] = threads;
  info[4] = blocks;
  return err;
}

// bf16 forward, dq and dk/dv on the tensor cores (flash_mma.cu)
cudaError_t fwd_bf16(const Args& a);
cudaError_t dq_bf16(const Args& a);
cudaError_t dkv_bf16(const Args& a);

}  // namespace flash
