"""CLIP's ModifiedResNet image tower, RN50 / RN101 / RN50x4 / x16 / x64
(counterpart of perceptor_tpu/models/clip/resnet.py), NCHW.

A 3-conv stem with a trailing 2x average pool, bottlenecks whose strides
are average pools (never strided convs) with an average-pooled downsample
branch, and a multi-head attention pool whose one query is the mean token
prepended to the positions. BatchNorm is inference mode
(`ops/layers.FrozenBatchNorm2d`). Module names are open_clip's
(`conv1..3`, `bn1..3`, `layer{1-4}.{i}` with `downsample.0` / `.1`,
`attnpool.{positional_embedding, q_proj, k_proj, v_proj, c_proj}`), so
under `visual.` the state_dict feeds the JAX package's
`models/clip/convert.py from_openclip`. Convs and projections compute in
their weights' dtype; BatchNorm, the pooled attention's softmax and the
output are fp32. The pool's attention (one query) takes the plain route.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.layers import Conv2d, FrozenBatchNorm2d, Linear


class CLIPBottleneck(nn.Module):
    """open_clip's Bottleneck (expansion 4): 1x1, 3x3, [avg pool], 1x1, and
    a [avg pool +] 1x1 + BatchNorm shortcut where the stride or width
    changes."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", Conv2d(inplanes, out, 1, bias=False)),
                ("1", FrozenBatchNorm2d(out)),
            ]))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """Multi-head attention pooling: the query is the mean token, prepended
    to the HW positions that give the keys and values."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim**2 + 1, embed_dim))
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def forward(self, x):
        n, c, h, w = x.shape
        tokens = x.reshape(n, c, h * w).transpose(1, 2)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        hd = c // self.num_heads

        def heads(t):
            return t.reshape(n, -1, self.num_heads, hd).transpose(1, 2)

        out = attention(heads(self.q_proj(tokens[:, :1])), heads(self.k_proj(tokens)),
                        heads(self.v_proj(tokens)))
        return self.c_proj(out.transpose(1, 2).reshape(n, 1, c))[:, 0].float()


class ModifiedResNet(nn.Module):
    """(N, 3, S, S) images, already resized and normalized -> (N,
    output_dim) fp32."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 image_size: int = 224, width: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width)
        inplanes = width
        for stage, count in enumerate(layers):
            planes = width * 2**stage
            blocks = []
            for i in range(count):
                blocks.append(CLIPBottleneck(inplanes, planes, 2 if stage > 0 and i == 0 else 1))
                inplanes = planes * CLIPBottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(layers)
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, heads, output_dim)

    def forward(self, images):
        h = images
        for i in (1, 2, 3):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        h = F.avg_pool2d(h, 2)
        for stage in range(self.n_stages):
            h = getattr(self, f"layer{stage + 1}")(h)
        return self.attnpool(h)
