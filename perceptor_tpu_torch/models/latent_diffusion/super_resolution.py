"""LDM SuperResolution, the BSR 4x "sharpen" model (counterpart of
perceptor_tpu/models/latent_diffusion/super_resolution.py).

The conditioning is the low-resolution image itself: the UNet's input is
[latents | the LR image in x-space at latent resolution] (6 channels).
`upsample` and `conditioning` go through the differentiable antialiased
`ops.resize`; `eta` defaults to 1.0. The reference's tiled
(`convolutional`) decoding is accepted and dropped, as JAX does: the full
frame runs in one pass. This is the LDM model; `models.SuperResolution`
names the ESRGAN wrapper, which is not ported.

Weights are seeded random at the published widths (no checkpoint in the
tree); see `face.VQLatentDiffusion`.
"""

from __future__ import annotations

from typing import Optional

import torch

from perceptor_tpu_torch.models.guided_diffusion.config import ADMConfig
from perceptor_tpu_torch.models.latent_diffusion import first_stage
from perceptor_tpu_torch.models.latent_diffusion.ddim import check_method
from perceptor_tpu_torch.models.latent_diffusion.face import VQLatentDiffusion
from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.predictions import diffusion_space

SR_UNET = ADMConfig(
    image_size=64,
    model_channels=160,
    channel_mult=(1, 2, 2, 4),
    num_res_blocks=2,
    attention_ds=(8, 16),
    num_head_channels=32,
    in_channels=6,
    out_channels=3,
)

TINY_SR_UNET = ADMConfig(
    image_size=8,
    model_channels=16,
    channel_mult=(1, 2),
    num_res_blocks=1,
    attention_ds=(2,),
    num_head_channels=8,
    in_channels=6,
    out_channels=3,
)


class SuperResolution(VQLatentDiffusion):
    def __init__(self, eta: float = 1.0, convolutional: bool = False, kernel_size: int = 128,
                 stride: int = 64, fp16: bool = True, tiny: bool = False, device="cuda",
                 seed: int = 0):
        """`convolutional`, `kernel_size` and `stride` (the reference's
        tiling) are accepted and dropped; `tiny` picks the test widths;
        `fp16` stores matmul/conv weights in bf16; weights come from the
        checkpoint that `find_checkpoint("latent_diffusion_super_resolution",
        "sharpen-colab")` finds, else they are random from `seed`; `device`
        is CUDA unless the caller passes "cpu"."""
        del convolutional, kernel_size, stride  # full-frame convolutions
        self.eta = eta
        self._build(TINY_SR_UNET if tiny else SR_UNET,
                    first_stage.TINY_VQ if tiny else first_stage.VQ_F4, fp16, device, seed)
        self._discover("latent_diffusion_super_resolution", "sharpen-colab")
        self.up_f = self.vq_config.downscale  # 4 for the real vq-f4 stage
        self._set_schedule(0.0015, 0.0155)

    def upsample(self, images) -> torch.Tensor:
        """Differentiable up_f x upsample."""
        return resize(images, out_shape=[s * self.up_f for s in images.shape[-2:]])

    def conditioning(self, images) -> torch.Tensor:
        """The LR image in x-space at latent resolution."""
        lr = resize(images, out_shape=[s // self.up_f for s in images.shape[-2:]])
        return diffusion_space.encode(lr)

    def schedule_indices(self, from_index=999, to_index=0, n_steps=None):
        """(k, 2) pairs of a linear ramp; repeated indices are allowed."""
        return super().schedule_indices(from_index, to_index, n_steps, unique=False)

    def _concat_eps(self, latents, index, conditioning):
        return self._unet_eps(torch.cat([latents, conditioning], dim=1), index)

    def eps(self, latents, index, conditioning):
        if index >= 1000:
            raise ValueError("index must be less than 1000")
        return self._concat_eps(latents, index, conditioning)

    def denoise(self, latents, conditioning, index, eps=None):
        """Predicted denoised latents."""
        if eps is None:
            eps = self.eps(latents, index, conditioning)
        return self._denoised(latents, index, eps)

    forward = denoise

    @torch.no_grad()
    def sample(self, images, n_steps: int = 50, eta: Optional[float] = None,
               generator: Optional[torch.Generator] = None, from_index: int = 999,
               to_index: int = 0, method: str = "ddim") -> torch.Tensor:
        """Super-resolution conditioned on `images`, the LR content on the HR
        canvas (e.g. `upsample(lr)`): noise latents -> per schedule pair eps
        (concat conditioning) -> denoise -> DDIM step -> final denoise -> VQ
        decode. Images in [0, 1] at the canvas size. dpm++ is deterministic:
        pass eta=0, since BSR defaults to 1.0. `generator` defaults to one
        seeded 0 on the model's device."""
        eta = self.eta if eta is None else eta
        check_method(method, eta, " (pass eta=0)")
        generator = self._generator(generator)
        cond = self.conditioning(images)
        latents = torch.randn((images.shape[0], self.unet_config.out_channels, *cond.shape[-2:]),
                              generator=generator, device=self.device)
        pairs = self.schedule_indices(from_index, to_index, n_steps)
        return self.sample_loop(latents, pairs, cond, eta, generator, method)

    @torch.no_grad()
    def sample_loop(self, latents, pairs, conditioning, eta: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    method: str = "ddim") -> torch.Tensor:
        """The sampler from given latents and `conditioning()`: k schedule
        pairs are k + 1 UNet evaluations and one decode."""
        eta = self.eta if eta is None else eta
        check_method(method, eta, " (pass eta=0)")
        return self._sample_loop(
            latents, pairs, lambda x, index: self._concat_eps(x, index, conditioning),
            self.images, eta, generator, method,
        )
