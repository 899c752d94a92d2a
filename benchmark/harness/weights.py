"""Seeded random weights for a network, drawn on the device in two calls.

The names and shapes come from the reference network built on the meta
device, so they are the upstream checkpoint's. Tensors of two or more
dimensions are drawn in bfloat16, the dtype the configurations serve
their products in; vectors and scalars in float32. Scales: a matrix or
convolution kernel N(0, 1/fan_in) (fan_in the product of all but the first
dimension; for open_clip's `proj` and `text_projection`, stored
(in, out), the first); embeddings and positional tables N(0, 0.02^2); a
vector named `.weight` (a norm's scale) 1 + N(0, 0.02^2); other vectors
N(0, 0.02^2); scalars 1.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import torch


def derived_seed(seed: int, label: str) -> int:
    """A 63-bit seed for stream `label` of run seed `seed`."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(label.encode())) % (1 << 63)


def _scale(name: str, shape) -> tuple:
    """(mean, std) of tensor `name`."""
    if len(shape) == 0:
        return 1.0, 0.0
    if "embedding" in name:
        return 0.0, 0.02
    if len(shape) == 1:
        return (1.0, 0.02) if name.endswith(".weight") else (0.0, 0.02)
    if name.endswith("proj") or name.endswith("text_projection"):
        return 0.0, 1.0 / math.sqrt(shape[0])
    return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def draw(module_cls, cfg: dict, seed: int, label: str, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every parameter of `module_cls(cfg)`, from stream
    `label` of `seed`. The tensors are views of two flat buffers."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in module_cls(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, label))
    groups = {torch.bfloat16: [k for k, s in shapes.items() if len(s) >= 2],
              torch.float32: [k for k, s in shapes.items() if len(s) < 2]}
    out = {}
    for dtype, names in groups.items():
        total = sum(math.prod(shapes[k]) for k in names)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        offset = 0
        for k in names:
            n = math.prod(shapes[k])
            mean, std = _scale(k, shapes[k])
            view = flat[offset:offset + n].view(shapes[k])
            out[k] = view.mul_(std).add_(mean)
            offset += n
    return out
