"""LPIPS perceptual distance, squeeze / alex / vgg backbones (counterpart
of perceptor_tpu/models/lpips.py), NCHW, fp32.

Scale-shift input normalization, the backbone's taps, per-pixel channel
L2 normalization, squared differences through non-negative 1x1 heads, the
spatial mean (or an upsampling to the image, `spatial=True`), summed over
the taps. The trunks are torchvision's `features` (alexnet, squeezenet1_1,
vgg16) under their names, the heads lpips' `lin{k}.model.1.weight`, so one
`load_state_dict` takes a torchvision trunk's `features.*` together with an
lpips checkpoint's heads. Untrained heads are uniform, 1 / C each (no
checkpoint in the tree); the trunks are seeded random.

Where the reference (the JAX package) differs from torchvision, the port
follows the reference:
- SqueezeNet's first conv is SAME-padded (flax's default; torchvision
  pads none): at even sizes its output, the first tap, has one more row
  and column than torchvision's. Its max pools are VALID, i.e. floor mode
  (torchvision's `ceil_mode=True`): the pooled maps are torchvision's at
  64, 224, 256 and 512px, but at 227px the second pool gives 27 against
  torchvision's 28.
"""

from __future__ import annotations

import functools
import math
from typing import List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.vgg import VGG16_CFG, VGGFeatures, tapped
from perceptor_tpu_torch.ops.resize import interpolate_bilinear
from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_state_dict

# lpips ScalingLayer constants
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

LPIPS_CHANNELS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}
LPIPS_VGG_TAPS = (4, 9, 16, 23, 30)


class AlexFeatures(nn.Module):
    """torchvision AlexNet `features` up to the last ReLU, tapped after each
    ReLU."""

    def __init__(self):
        super().__init__()
        self.taps = (2, 5, 8, 10, 12)
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
        )

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        return tapped(self.features, self.taps, images)


class SameConv2d(nn.Conv2d):
    """An unpadded conv that pads its input as flax's "SAME" does: the
    output is ceil(size / stride), the extra row or column at the end."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(x.shape[:-3:-1], self.kernel_size[::-1], self.stride[::-1]):
            total = max((math.ceil(size / s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class Fire(nn.Module):
    """torchvision's SqueezeNet Fire: squeeze 1x1, then expand 1x1 and 3x3
    concatenated, each ReLU'd."""

    def __init__(self, in_ch: int, squeeze_ch: int, expand_ch: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze_ch, 1)
        self.expand1x1 = nn.Conv2d(squeeze_ch, expand_ch, 1)
        self.expand3x3 = nn.Conv2d(squeeze_ch, expand_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return F.relu(torch.cat([self.expand1x1(s), self.expand3x3(s)], dim=1))


class SqueezeFeatures(nn.Module):
    """torchvision squeezenet1_1 `features`, the reference's padding and
    pooling (module docstring), 7 LPIPS taps."""

    def __init__(self):
        super().__init__()
        self.taps = (2, 5, 8, 10, 11, 12, 13)
        self.features = nn.Sequential(
            SameConv2d(3, 64, 3, stride=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            Fire(64, 16, 64), Fire(128, 16, 64), nn.MaxPool2d(3, 2),
            Fire(128, 32, 128), Fire(256, 32, 128), nn.MaxPool2d(3, 2),
            Fire(256, 48, 192), Fire(384, 48, 192), Fire(384, 64, 256), Fire(512, 64, 256),
        )

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        return tapped(self.features, self.taps, images)


class NetLinLayer(nn.Module):
    """lpips' 1x1 head, one output channel, no bias; `model.0` is lpips'
    dropout, the identity at inference."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


_TRUNKS = {
    "alex": AlexFeatures,
    "squeeze": SqueezeFeatures,
    "vgg": functools.partial(VGGFeatures, VGG16_CFG, LPIPS_VGG_TAPS),
}


class LPIPSNet(nn.Module):
    """A backbone's `features` (top-level torchvision names) and the heads
    `lin{k}`."""

    def __init__(self, name: str):
        super().__init__()
        trunk = _TRUNKS[name]()
        self.features, self.taps = trunk.features, trunk.taps
        for k, c in enumerate(LPIPS_CHANNELS[name]):
            self.add_module(f"lin{k}", NetLinLayer(c))

    @property
    def lins(self) -> List[NetLinLayer]:
        return [getattr(self, f"lin{k}") for k in range(len(self.taps))]

    def trunk(self, images: torch.Tensor) -> List[torch.Tensor]:
        return tapped(self.features, self.taps, images)


def _normalize(features: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(features), dim=1, keepdim=True))
    return features / (norm + eps)


@cache
class LPIPS:
    def __init__(self, name: str = "squeeze", linear_layers: bool = True,
                 spatial: bool = False, device="cuda", seed: int = 0):
        if name not in LPIPS_CHANNELS:
            raise ValueError(f"unknown lpips backbone: {name}")
        self.name = name
        self.linear_layers = linear_layers
        self.spatial = spatial
        self.channels = LPIPS_CHANNELS[name]
        self.device = resolve_device(device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(LPIPSNet, name, self.device, generator, torch.float32)
        with torch.no_grad():
            # uniform positive heads keep the metric meaningful untrained
            for lin, c in zip(self.module.lins, self.channels):
                lin.model[1].weight.fill_(1.0 / c)
        self._shift = torch.as_tensor(_SHIFT, device=self.device).reshape(1, 3, 1, 1)
        self._scale = torch.as_tensor(_SCALE, device=self.device).reshape(1, 3, 1, 1)
        backbone_path = find_checkpoint(f"lpips_{name}_backbone", name)
        lin_path = find_checkpoint(f"lpips_{name}_lin")
        for path, part in ((backbone_path, "features."), (lin_path, "lin")):
            if path is not None:
                self._load_part(load_state_dict(path), part)

    def _load_part(self, state_dict: Mapping[str, torch.Tensor], part: str) -> None:
        """One of the two upstream files: the torchvision trunk (its
        `features.*`) or lpips' heads (`lin{k}.model.1.weight`)."""
        own = [k for k in self.module.state_dict() if k.startswith(part)]
        missing = [k for k in own if k not in state_dict]
        if missing:
            raise ValueError(f"lpips {self.name}: the checkpoint lacks {missing[:3]}")
        self.module.load_state_dict({k: state_dict[k] for k in own}, strict=False)

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """A torchvision trunk's `features.*` and lpips' `lin{k}.model.1.weight`."""
        self.module.load_state_dict(state_dict)

    def __call__(self, images_a: torch.Tensor, images_b: torch.Tensor) -> torch.Tensor:
        """Distance of images in [0, 1]: (N, 1), or (N, 1, H, W) if
        `spatial`."""

        def scaled(images):
            return ((images * 2 - 1) - self._shift) / self._scale

        feats_a = self.module.trunk(scaled(images_a))
        feats_b = self.module.trunk(scaled(images_b))
        total = 0.0
        for fa, fb, lin in zip(feats_a, feats_b, self.module.lins):
            diff = torch.square(_normalize(fa) - _normalize(fb))
            weighted = lin(diff) if self.linear_layers else diff.mean(dim=1, keepdim=True)
            if self.spatial:
                total = total + interpolate_bilinear(
                    weighted, images_a.shape[-2:], align_corners=False)
            else:
                total = total + weighted.mean(dim=(2, 3))
        return total

    forward = __call__
