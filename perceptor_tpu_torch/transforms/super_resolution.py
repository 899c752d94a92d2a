"""SuperResolution transform (counterpart of
perceptor_tpu/transforms/super_resolution.py): `encode` upsamples with
Real-ESRGAN, `decode` resizes back down."""

from __future__ import annotations

from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.transforms.interface import TransformInterface


class SuperResolution(TransformInterface):
    def __init__(self, name: str = "x4", half: bool = True, **kwargs):
        """`kwargs` go to `models.SuperResolution` (`device`, `seed`)."""
        from perceptor_tpu_torch import models

        self.name = name
        self.model = models.SuperResolution(name, half, **kwargs)

    def encode(self, images):
        return self.model.upsample(images)

    def decode(self, upsampled_images, size=None):
        if size is None:
            size = [s // self.model.scale for s in upsampled_images.shape[-2:]]
        return resize(upsampled_images, out_shape=size)
