"""torchvision ResNet / ResNeXt feature trunks (counterpart of
perceptor_tpu/models/resnet.py), NCHW, fp32.

torchvision.models.resnet's semantics: a 7x7/2 stem and a 3x3/2 max pool,
Bottleneck blocks (1x1 -> grouped 3x3 carrying the stride -> 1x1,
expansion 4) with a post-add ReLU, inference-mode BatchNorm
(`ops/layers.FrozenBatchNorm2d`). Module names are torchvision's
(`conv1`, `bn1`, `layer{s}.{i}.conv{1,2,3}` / `bn{1,2,3}`,
`downsample.{0,1}`), so a torchvision state_dict loads directly (its `fc.*`
left out). The shared backbone of ResMem (`models/resmem.py`) and, later,
MiDaS v21.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.ops.layers import FrozenBatchNorm2d


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 23, 3)
    groups: int = 1
    width_per_group: int = 64
    stem_width: int = 64
    base_planes: Tuple[int, ...] = (64, 128, 256, 512)
    expansion: int = 4
    bn_eps: float = 1e-5

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(p * self.expansion for p in self.base_planes)


RESNEXT101_32X8D = ResNetConfig(groups=32, width_per_group=8)
RESNET152 = ResNetConfig(layers=(3, 8, 36, 3))
RESNET50 = ResNetConfig(layers=(3, 4, 6, 3))
TINY_RESNEXT = ResNetConfig(
    layers=(1, 1, 1, 1), groups=2, width_per_group=32,
    stem_width=8, base_planes=(4, 8, 16, 32),
)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: width = planes * width_per_group / 64 *
    groups; a strided 1x1 + BatchNorm shortcut where the stride or the
    width changes."""

    def __init__(self, in_ch: int, planes: int, stride: int, cfg: ResNetConfig):
        super().__init__()
        width = int(planes * cfg.width_per_group / 64.0) * cfg.groups
        out_ch = planes * cfg.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width, cfg.bn_eps)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=cfg.groups,
                               bias=False)
        self.bn2 = FrozenBatchNorm2d(width, cfg.bn_eps)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_ch, cfg.bn_eps)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(out_ch, cfg.bn_eps),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNetFeatures(nn.Module):
    """Stem + 4 stages; NCHW in, the 4 stage maps out (layer1's output
    includes the stem and the max pool)."""

    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.conv1 = nn.Conv2d(3, config.stem_width, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(config.stem_width, config.bn_eps)
        channels = config.stem_width
        for stage, (planes, count) in enumerate(zip(config.base_planes, config.layers)):
            blocks = []
            for i in range(count):
                blocks.append(Bottleneck(channels, planes, 2 if (stage > 0 and i == 0) else 1,
                                         config))
                channels = planes * config.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = F.relu(self.bn1(self.conv1(images.float())))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        features = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = stage(h)
            features.append(h)
        return tuple(features)
