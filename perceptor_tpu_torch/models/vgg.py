"""VGG feature trunks with torchvision's names (counterpart of
perceptor_tpu/models/vgg.py), NCHW, fp32.

`VGGFeatures` is torchvision's `features` Sequential for a config string
(a number = a 3x3 conv of that width and its ReLU, "M" = a 2x2 max pool),
so `features.{i}.weight` of a torchvision VGG state_dict loads directly;
`taps` are features indices with exclusive ends: the activation after
layer `tap - 1` is returned. `VGG19` is the raw VGG19 trunk of the
style-transfer loss, seeded random at the published widths (no checkpoint
in the tree; `load_state_dict` takes torchvision's).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_TAPS = (4, 9, 16, 23, 30, 37)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def tapped(features: nn.Sequential, taps, images: torch.Tensor) -> List[torch.Tensor]:
    """Run `features` on fp32 `images`, returning the activation after each
    layer whose index + 1 is in `taps`."""
    x, outputs = images.float(), []
    for index, layer in enumerate(features):
        x = layer(x)
        if index + 1 in taps:
            outputs.append(x)
    return outputs


def _layers(cfg) -> List[Tuple[str, int]]:
    """torchvision's layer list of a config: ("conv", width) and ("relu", 0)
    per number, ("pool", 0) per "M"; its positions are features indices."""
    layers = []
    for v in cfg:
        if v == "M":
            layers.append(("pool", 0))
        else:
            layers.append(("conv", v))
            layers.append(("relu", 0))
    return layers


class VGGFeatures(nn.Module):
    """The trunk up to the last tap; `forward` returns the activations at
    `taps` (NCHW, fp32)."""

    def __init__(self, cfg: Tuple = VGG19_CFG, taps: Tuple[int, ...] = (4, 9, 16, 23, 30)):
        super().__init__()
        self.taps = tuple(taps)
        layers, channels = [], 3
        for kind, width in _layers(cfg)[: max(self.taps)]:
            if kind == "conv":
                layers.append(nn.Conv2d(channels, width, 3, padding=1))
                channels = width
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        return tapped(self.features, self.taps, images)


@cache
class VGG19:
    """The raw VGG19 trunk: `activations(images)` returns the six slice
    taps, `forward` the last (pooled) one. Its weights are those of the
    checkpoint `find_checkpoint("vgg19", "vgg19_features")` finds, else
    seeded random."""

    def __init__(self, device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(
            functools.partial(VGGFeatures, taps=VGG19_TAPS), VGG19_CFG, self.device, generator,
            torch.float32,
        )
        path = find_checkpoint("vgg19", "vgg19_features")
        if path is not None:
            load_found(path, {"module": self.module}, self._from_jax, self._load_upstream)

    @staticmethod
    def _from_jax(params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import vgg_state_dict_from_jax

        return {"module": vgg_state_dict_from_jax(params)}

    def _load_upstream(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """A whole torchvision vgg19 state_dict: its `features.*`."""
        self.load_state_dict({k: v for k, v in state_dict.items() if k.startswith("features.")})

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """torchvision's `features.{i}.weight` / `.bias` (a whole vgg19
        state_dict's `classifier.*` must be left out)."""
        self.module.load_state_dict(state_dict)

    def activations(self, images: torch.Tensor) -> List[torch.Tensor]:
        return self.module(images)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        _, _, height, width = images.shape
        if width % 8 or height % 8:
            raise ValueError("Height and width must be divisible by 8")
        return self.activations(images)[-1]

    forward = __call__
