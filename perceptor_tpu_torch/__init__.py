"""PyTorch/CUDA port of perceptor_tpu.

The JAX package (`perceptor_tpu`) is the reference; this package keeps its
module paths so each counterpart is found at the same place
(`perceptor_tpu_torch/ops/attention.py` <-> `perceptor_tpu/ops/attention.py`).
It imports torch and numpy only, never jax or perceptor_tpu. The
flash-attention kernels are CUDA C++ for Hopper (`csrc/`), built at first
use; every other op is plain PyTorch.
"""
