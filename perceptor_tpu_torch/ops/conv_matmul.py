"""3x3 SAME convolution (counterpart of perceptor_tpu/ops/conv_matmul.py).

The JAX module lowers some 3x3 convs to explicit matmuls to dodge a slow
XLA TPU conv emitter; that is layout work for XLA and has no use here, so
`Conv3x3` is a plain padded convolution (cuDNN) in the weight's dtype.
"""

from __future__ import annotations

from perceptor_tpu_torch.ops.layers import Conv2d


def Conv3x3(in_channels: int, out_channels: int) -> Conv2d:
    """nn.Conv(features, (3, 3), padding=1) as a torch layer."""
    return Conv2d(in_channels, out_channels, kernel_size=3, padding=1)
