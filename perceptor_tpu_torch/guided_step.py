"""The CLIP-guided Stable Diffusion denoise step (counterpart of
bench.py:48-154), the port's main path.

One step: UNet forward on the latents -> denoised latents -> VAE decode ->
antialiased resize to the CLIP input size and CLIP normalization -> CLIP
ViT image tower -> L2-normalize -> spherical distance to a fixed unit
target embedding; the gradient of that loss with respect to the latents
(back through CLIP, the VAE and the UNet, so through the flash forward and
both backward kernels) then drives `guided(grad, 0.5).step(to_idx)`.

Weights are random, drawn from a seeded `torch.Generator` in the JAX
bench's fill (`core/init.py`: normal with std 1/sqrt(fan_in) for weights,
zero biases, unit norm scales), so FLOPs and memory equal those of
pretrained weights. Matmul/conv weights are stored in
bf16 and norms in fp32.

Usage::

    step = build("sd-v1-512", device="cuda", seed=0)
    latents, context = step.initial_inputs()
    for _ in range(n):
        latents, loss = step.guided_denoise_step(latents, context)

Run as a module it prints the step's losses bit for bit, to compare two
trees of the port on one card (two trees whose step does the same
arithmetic print the same line)::

    PYTHONPATH=<tree> python3 -m perceptor_tpu_torch.guided_step [steps]
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Tuple

import numpy as np
import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss
from perceptor_tpu_torch.models.clip.configs import CLIPConfig, get_config
from perceptor_tpu_torch.models.open_clip import OpenCLIP
from perceptor_tpu_torch.models.stable_diffusion import config as sd_config
from perceptor_tpu_torch.models.stable_diffusion.unet import UNet
from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL
from perceptor_tpu_torch.predictions import LatentIndexedEpsPredictions
from perceptor_tpu_torch.schedules import scaled_linear_alphas_sigmas

FROM_INDEX = 800
TO_INDEX = 780
GUIDANCE_SCALE = 0.5

# the tiny CLIP of __graft_entry__.py's multi-chip dry run
TINY_CLIP = CLIPConfig(
    embed_dim=32,
    image_size=(32, 32),
    patch_size=8,
    vision_width=32,
    vision_layers=2,
    vision_heads=2,
    context_length=16,
    vocab_size=64,
    text_width=32,
    text_layers=2,
    text_heads=2,
)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    unet: sd_config.UNetConfig
    vae: sd_config.VAEConfig
    clip: CLIPConfig
    image_size: int
    dtype: torch.dtype


CONFIGS = {
    "sd-v1-512": StepConfig(
        sd_config.SD_V1_UNET, sd_config.SD_V1_VAE, get_config("ViT-B-32", "openai"),
        512, COMPUTE_DTYPE,
    ),
    "tiny": StepConfig(sd_config.TINY_UNET, sd_config.TINY_VAE, TINY_CLIP, 16, torch.float32),
}


class GuidedStep:
    """The three frozen models and the constants of the guided step.
    `clip_loss` is the prompt-bank loss over the CLIP wrapper, its bank the
    one fixed target; `clip` is the wrapper's module."""

    def __init__(self, cfg: StepConfig, unet: UNet, vae: AutoencoderKL, clip: OpenCLIP,
                 device: torch.device, seed: int):
        self.config = cfg
        self.unet, self.vae, self.clip = unet, vae, clip.module
        self.device = device
        self.seed = seed
        alphas, sigmas = scaled_linear_alphas_sigmas()
        self.alphas = torch.as_tensor(alphas, device=device)
        self.sigmas = torch.as_tensor(sigmas, device=device)
        # the JAX bench's target: a fixed unit embedding from numpy's rng(2)
        target = np.random.default_rng(2).normal(size=(1, cfg.clip.embed_dim))
        target = (target / np.linalg.norm(target, axis=-1, keepdims=True)).astype(np.float32)
        self.target = torch.as_tensor(target, device=device)
        self.clip_loss = PromptBankLoss(clip).add_encodings_(self.target)
        self.from_idx = torch.tensor([FROM_INDEX], device=device)
        self.to_idx = torch.tensor([TO_INDEX], device=device)

    def initial_inputs(self, batch: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Seeded (latents, context): latents (N, 4, S/8, S/8) and a random
        text context (N, 77, context_dim)."""
        cfg = self.config
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        size = cfg.image_size // cfg.vae.downscale
        latents = torch.randn(
            (batch, cfg.unet.in_channels, size, size), generator=gen, device=self.device
        )
        context = torch.randn(
            (batch, 77, cfg.unet.context_dim), generator=gen, device=self.device
        )
        return latents, context

    def predictions(self, latents, noise) -> LatentIndexedEpsPredictions:
        return LatentIndexedEpsPredictions(
            from_diffused_latents=latents,
            from_indices=self.from_idx,
            predicted_noise=noise,
            schedule_alphas=self.alphas,
            schedule_sigmas=self.sigmas,
        )

    def loss_and_noise(self, latents: torch.Tensor, context: torch.Tensor):
        noise = self.unet(latents, self.from_idx.float(), context)
        images = self.vae.decode(self.predictions(latents, noise).denoised_xs)
        return self.clip_loss(images), noise

    def guided_denoise_step(self, latents: torch.Tensor, context: torch.Tensor):
        """(stepped latents, loss) of one guided DDIM step 800 -> 780."""
        latents = latents.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, noise = self.loss_and_noise(latents, context)
            (grad,) = torch.autograd.grad(loss, latents)
        return self.step_with_gradient(latents.detach(), noise.detach(), grad), loss.detach()

    def step_with_gradient(self, latents, noise, grad) -> torch.Tensor:
        predictions = self.predictions(latents, noise)
        return predictions.guided(grad, guidance_scale=GUIDANCE_SCALE).step(self.to_idx)


def build(config: str = "sd-v1-512", device="cuda", seed: int = 0,
          remat: bool = False) -> GuidedStep:
    """The guided step at `config` ("sd-v1-512": SD-1.x UNet + VAE at 512px
    with CLIP ViT-B/32 in bf16; "tiny": the TINY configs in fp32), with
    random weights from `seed`, on `device` (CUDA unless the caller passes
    "cpu"); `remat` recomputes the UNet's res and transformer blocks in the
    backward pass."""
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}; known: {sorted(CONFIGS)}")
    device = resolve_device(device)
    cfg = CONFIGS[config]
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, remat=remat))
    gen = torch.Generator(device=device).manual_seed(seed)
    unet = random_module(UNet, cfg.unet, device, gen, cfg.dtype)
    vae = random_module(AutoencoderKL, cfg.vae, device, gen, cfg.dtype)
    # the wrapper continues the generator's stream (a call with a generator
    # is not memoized)
    clip = OpenCLIP(
        "guided-step", "random", precision=None if cfg.dtype == COMPUTE_DTYPE else "fp32",
        config=cfg.clip, device=device, seed=gen,
    )
    return GuidedStep(cfg, unet, vae, clip, device, seed)


def main(argv) -> int:
    """`steps` (default 5) full-width guided steps on CUDA from seed 0: one
    JSON line with each loss and the sum of the final latents as
    hexadecimal floats."""
    steps = int(argv[1]) if len(argv) > 1 else 5
    step = build("sd-v1-512", device="cuda", seed=0)
    latents, context = step.initial_inputs()
    losses = []
    for _ in range(steps):
        latents, loss = step.guided_denoise_step(latents, context)
        losses.append(float(loss).hex())
    print(json.dumps({"losses": losses, "latents_sum": float(latents.double().sum()).hex()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
