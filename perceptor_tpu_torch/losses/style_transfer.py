"""Style-transfer loss: weighted L1 on VGG19 features and their Gram
matrices (counterpart of perceptor_tpu/losses/style_transfer.py).

Activations at the slices (0,4)(4,9)(9,16)(16,23)(23,30) of a 256px
resize, the input prepended; losses on slices 2/3/4 weighted 5/15/2
(features) and 5^2*5e3 / 15^2*5e3 / 2^2*5e3 (Gram matrices), the total
scaled by 0.001. Style images given at construction are encoded once.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.vgg import VGG19
from perceptor_tpu_torch.ops.resize import resize


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    a, b, c, d = features.shape
    flat = features.reshape(a * b, c * d)
    return (flat @ flat.T) / (a * b * c * d)


class StyleTransfer(LossInterface):
    def __init__(self, style_images=None, **kwargs):
        """`kwargs` are `device` and `seed` of `models.VGG19`."""
        self.model = VGG19(**kwargs)
        self.encodings: Optional[List[torch.Tensor]] = None
        if style_images is not None:
            with torch.no_grad():
                self.encodings = self.encode(style_images)

    def encode(self, images) -> List[torch.Tensor]:
        """[input, slice1 .. slice5] activations."""
        if tuple(images.shape[-2:]) != (256, 256):
            images = resize(images, out_shape=(256, 256))
        return [images] + self.model.activations(images)[:5]

    def loss(self, encodings_a, encodings_b) -> torch.Tensor:
        l1 = [torch.abs(a - b).mean() for a, b in zip(encodings_a, encodings_b)]
        gram = [
            torch.abs(gram_matrix(a) - gram_matrix(b)).mean()
            for a, b in zip(encodings_a, encodings_b)
        ]
        vgg_loss = 5 * l1[2] + 15 * l1[3] + 2 * l1[4]
        vgg_loss_gram = 5**2 * 5e3 * gram[2] + 15**2 * 5e3 * gram[3] + 2**2 * 5e3 * gram[4]
        return (vgg_loss + vgg_loss_gram) * 0.001

    def forward(self, images_a, images_b=None) -> torch.Tensor:
        if images_b is None:
            if self.encodings is None:
                raise ValueError("no style images: pass images_b or style_images")
            encodings_b = self.encodings
        else:
            encodings_b = self.encode(images_b)
        return self.loss(self.encode(images_a), encodings_b)
