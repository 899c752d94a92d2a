"""Super-resolution self-consistency loss and the UNet discriminator loss
(counterpart of perceptor_tpu/losses/super_resolution.py).

`SuperResolution`: the images resized down by `pre_downscale`, upsampled by
Real-ESRGAN (resized back if the shapes differ) into a target that carries
no gradient, and the MSE to it. `SuperResolutionDiscriminator`: minus the
mean logit of the spectral-norm UNet discriminator, times 0.001.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.super_resolution import UNetDiscriminatorSN
from perceptor_tpu_torch.ops.resize import resize


class SuperResolution(LossInterface):
    def __init__(self, name: str = "x2", pre_downscale: Optional[int] = None, half: bool = True,
                 mode: str = "bicubic", **kwargs):
        """`kwargs` go to `models.SuperResolution` (`device`, `seed`)."""
        from perceptor_tpu_torch import transforms

        self.transform = transforms.SuperResolution(name, half, **kwargs)
        self.mode = mode
        self.pre_downscale = (
            self.transform.model.scale if pre_downscale is None else pre_downscale
        )

    def forward(self, images):
        downsampled_size = [s // self.pre_downscale for s in images.shape[-2:]]
        # the upsampled target is frozen (JAX's stop_gradient): no graph
        with torch.no_grad():
            downsampled = resize(images, out_shape=downsampled_size, resample=self.mode)
            upsampled = self.transform.encode(downsampled)
            if upsampled.shape != images.shape:
                upsampled = resize(upsampled, out_shape=tuple(images.shape[-2:]),
                                   resample=self.mode)
        return torch.square(images - upsampled).mean()


class SuperResolutionDiscriminator(LossInterface):
    def __init__(self, name: str = "RealESRGAN_x4plus_netD", device="cuda",
                 seed: Union[int, torch.Generator] = 0):
        """The discriminator in fp32 on `device` (CUDA unless the caller
        passes "cpu"), frozen, with random weights from `seed`; a basicsr
        file loads through `module.load_state_dict(
        convert_unet_discriminator(sd))`, which folds its spectral norm."""
        self.name = name
        device = resolve_device(device)
        generator = seed if isinstance(seed, torch.Generator) else torch.Generator(
            device=device).manual_seed(seed)
        self.module = random_module(UNetDiscriminatorSN, 64, device, generator, torch.float32)

    def forward(self, images):
        """-mean discriminator logit, times 0.001."""
        return -self.module(images).mean() * 0.001
