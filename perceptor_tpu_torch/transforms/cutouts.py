"""Differentiable random cutouts for guidance ensembles (counterpart of
perceptor_tpu/transforms/cutouts.py).

An axis-aligned crop-resize is a separable linear map, so each cutout is
two dense contractions with weight matrices built on the images' device
from the boxes:

    out[n, b, c, i, j] = sum_h sum_w Wy[n, i, h] * x[b, c, h, w] * Wx[n, j, w]

The triangle kernel is stretched by the per-cutout scale (antialiased
minification), shapes do not depend on the draw, and the adjoint back to
the source image is the transposed contractions, which autograd derives.
Both contractions run in fp32 with TF32 off, as the JAX einsums run at
`Precision.HIGHEST`; the output is cast back to the images' dtype.

Randomness is an explicit `torch.Generator` on the images' device: the
boxes are drawn there, so no step waits for the host. In an exported
program the generator is a `predictions.base.NoiseStream` whose uniforms
were drawn beforehand by the same calls; `RandomCutouts` is the guidance
augment that declares how many it takes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perceptor_tpu_torch.predictions.base import rand


def _axis_weights(starts, sizes, in_size: int, out_size: int) -> torch.Tensor:
    """Antialiased triangle-kernel interpolation weights for a 1-D
    crop-resize. `starts`/`sizes`: (n,) crop origin and extent in source
    pixels. Returns (n, out_size, in_size) row-stochastic weights mapping
    source pixels to the output pixels of the [start, start + size) window."""
    starts, sizes = starts.float(), sizes.float()
    device = starts.device
    scale = sizes / out_size  # source pixels per output pixel, (n,)
    o = torch.arange(out_size, dtype=torch.float32, device=device) + 0.5
    centers = starts[:, None] + o[None, :] * scale[:, None] - 0.5  # (n, out)
    # antialias: stretch the triangle's support by the scale when minifying
    support = torch.clamp(scale, min=1.0)[:, None, None]
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    dist = (src[None, None, :] - centers[..., None]) / support  # (n, out, in)
    weights = torch.clamp(1.0 - dist.abs(), min=0.0)
    # taps falling outside the image are renormalized away
    return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-12)


def crop_and_resize(images: torch.Tensor, boxes, out_size: int) -> torch.Tensor:
    """Antialiased differentiable crop-resize of normalized boxes.

    images: (B, C, H, W); boxes: (n, 4) normalized (y0, x0, y1, x1) in
    [0, 1], each applied to every batch member. Returns
    (n * B, C, out_size, out_size), cut-major (cut 0 over the batch, then
    cut 1, ...). Gradients flow to `images` through the transposed
    contractions."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=images.device)
    if boxes.ndim != 2 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (n, 4), got {tuple(boxes.shape)}")
    b, c, h, w = images.shape
    n = boxes.shape[0]
    y0, x0, y1, x1 = boxes.unbind(dim=1)
    wy = _axis_weights(y0 * h, (y1 - y0) * h, h, out_size)
    wx = _axis_weights(x0 * w, (x1 - x0) * w, w, out_size)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows = torch.einsum("nih,bchw->nbciw", wy, images.float())
        out = torch.einsum("njw,nbciw->nbcij", wx, rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.reshape(n * b, c, out_size, out_size).to(images.dtype)


def random_cutout_boxes(
    generator: torch.Generator,
    image_size,
    n_cutouts: int,
    cut_size: int = 224,
    cut_pow: float = 1.0,
) -> torch.Tensor:
    """Draw the MakeCutouts box distribution: a square of side
    `U(0,1)**cut_pow` scaled into [min(cut_size, S), S] with S = min(H, W),
    placed uniformly inside the image. Returns (n, 4) normalized
    (y0, x0, y1, x1) on the generator's device; u, then oy, then ox are
    drawn from `generator` in one (3, n) draw, or taken pre-drawn from a
    `NoiseStream`."""
    h, w = image_size
    max_size = float(min(h, w))
    min_size = float(min(h, w, cut_size))
    u, ry, rx = rand((3, n_cutouts), generator)
    sizes = u**cut_pow * (max_size - min_size) + min_size
    oy = ry * (h - sizes)
    ox = rx * (w - sizes)
    return torch.stack([oy / h, ox / w, (oy + sizes) / h, (ox + sizes) / w], dim=-1)


def random_cutouts(
    images: torch.Tensor,
    generator: torch.Generator,
    n_cutouts: int,
    cut_size: int = 224,
    cut_pow: float = 1.0,
) -> torch.Tensor:
    """Random guidance cutouts: (B, C, H, W) -> (n_cutouts * B, C, cut_size,
    cut_size), differentiable in `images`. `generator` must be on the
    images' device. The standard use is a guidance ensemble: encode the
    cutouts with a CLIP-family loss, which means the distances."""
    boxes = random_cutout_boxes(
        generator, images.shape[-2:], n_cutouts, cut_size=cut_size, cut_pow=cut_pow
    )
    return crop_and_resize(images, boxes, cut_size)


class RandomCutouts:
    """The `image_augment` `(generator, images) -> random_cutouts(...)` of
    guided sampling, with the uniform draws it makes on each call
    (`uniform_shape`), which `engine.export_guided_sample` needs to take
    them from its noise argument."""

    def __init__(self, n_cutouts: int, cut_size: int = 224, cut_pow: float = 1.0):
        self.n_cutouts, self.cut_size, self.cut_pow = n_cutouts, cut_size, cut_pow

    @property
    def uniform_shape(self) -> Tuple[int, int]:
        return (3, self.n_cutouts)

    def __call__(self, generator, images: torch.Tensor) -> torch.Tensor:
        return random_cutouts(images, generator, self.n_cutouts, cut_size=self.cut_size,
                              cut_pow=self.cut_pow)
