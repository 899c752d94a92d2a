"""ResMem memorability predictor (counterpart of
perceptor_tpu/models/resmem.py), NCHW, fp32.

A dual-branch CNN regressor (Needell & Bainbridge 2021) scoring the
memorability of 227x227 RGB crops in [0, 1] (no ImageNet normalization):
- the MemNet branch: torchvision AlexNet `features` and the fc6 / fc7 MLP,
  4096-d;
- the residual branch: a ResNet-152 trunk (`models/resnet.py`), global
  average pooled, 2048-d;
concatenated into a 1024 -> 256 -> 1 head and a sigmoid. Module names are
the upstream layout that the JAX package's `convert_resmem` reads:
`features.{0,3,6,8,10}`, `fc6`, `fc7`, `resnet.*` (torchvision names),
`head{1,2,3}`. fc6 takes the pooled map flattened in torch's (C, H, W)
order; the JAX package flattens (H, W, C), and
`convert.resmem_state_dict_from_jax` permutes between the two. No
checkpoint is in the tree: weights are seeded random at the published
widths, or loaded with `load_state_dict`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.resnet import RESNET152, TINY_RESNEXT, ResNetConfig, ResNetFeatures
from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

CROP_SIZE = 227


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet `features` (its pool's output is 6x6 at 227px,
    where torchvision's adaptive pool is the identity) and fc6 / fc7,
    dropout-free: the 4096-d fc7 activation. `width_mult` divides every
    width (the tiny config); `spatial` is the side of the last pooled map,
    which sizes fc6."""

    def __init__(self, width_mult: int = 1, spatial: int = 6):
        super().__init__()
        m = width_mult
        self.features = nn.Sequential(
            nn.Conv2d(3, 64 // m, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64 // m, 192 // m, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192 // m, 384 // m, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384 // m, 256 // m, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256 // m, 256 // m, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2),
        )
        self.fc6 = nn.Linear(256 // m * spatial * spatial, 4096 // m)
        self.fc7 = nn.Linear(4096 // m, 4096 // m)

    def alexnet(self, x: torch.Tensor) -> torch.Tensor:
        h = self.features(x).flatten(1)
        return F.relu(self.fc7(F.relu(self.fc6(h))))

    forward = alexnet


class ResMemNet(AlexNetFeatures):
    """Both branches and the head: (N, 3, crop, crop) in [0, 1] -> (N,)
    scores in (0, 1). The AlexNet branch's modules sit at the top level, as
    upstream."""

    def __init__(self, resnet_config: ResNetConfig = RESNET152, width_mult: int = 1,
                 spatial: int = 6):
        super().__init__(width_mult, spatial)
        m = width_mult
        self.resnet = ResNetFeatures(resnet_config)
        self.head1 = nn.Linear(4096 // m + resnet_config.stage_channels[-1], 1024 // m)
        self.head2 = nn.Linear(1024 // m, 256 // m)
        self.head3 = nn.Linear(256 // m, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        mem = self.alexnet(x)
        res = self.resnet(x)[-1].mean(dim=(2, 3))  # global average pool
        h = torch.cat([mem, res], dim=-1)
        h = F.relu(self.head2(F.relu(self.head1(h))))
        return torch.sigmoid(self.head3(h))[:, 0]


# name -> (ResNet config, width divisor, crop size, pooled side at the crop)
_VARIANTS = {
    "resmem": (RESNET152, 1, CROP_SIZE, 6),
    # the smallest crop the AlexNet stride chain allows
    "tiny": (TINY_RESNEXT, 8, 63, 1),
}


@cache
class ResMem:
    """Frozen memorability scorer: `predict(images)` on crops of
    `crop_size`."""

    def __init__(self, name: str = "resmem", device="cuda", seed: int = 0):
        if name not in _VARIANTS:
            raise ValueError(f"unknown ResMem variant: {name}")
        config, width_mult, self.crop_size, spatial = _VARIANTS[name]
        self.name = name
        self.device = resolve_device(device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(
            lambda cfg: ResMemNet(*cfg), (config, width_mult, spatial), self.device, generator,
            torch.float32,
        )
        path = find_checkpoint("resmem", name) if name == "resmem" else None
        if path is not None:
            load_found(path, {"module": self.module}, self._from_jax, self.load_state_dict)

    @staticmethod
    def _from_jax(params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import resmem_state_dict_from_jax

        return {"module": resmem_state_dict_from_jax(params)}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        self.module.load_state_dict(state_dict)

    def predict(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, 3, crop, crop) in [0, 1] -> (N,) memorability scores."""
        return self.module(images)
