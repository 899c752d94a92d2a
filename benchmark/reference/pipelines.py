"""The reference's two entry points, over the plain networks in float32
(or, for the control, with every linear and convolution computed as fp8
products and the sampler's arithmetic in bfloat16).

- `GuidedReference`: the CLIP-guided SD denoise step: UNet noise at
  `from_index`, the denoised latents, the VAE decode, the resize to the
  CLIP tower's input, the image tower, the spherical distance to a fixed
  unit target, its gradient with respect to the latents, and the guided
  DDIM update to `to_index`.
- `Txt2ImgReference`: Stable Diffusion text to image: the text tower over
  tokenized prompts, the CFG noise of one batched UNet call, the DDIM
  update over the rho-spaced index schedule, the VAE decode.

Neither imports anything of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import diffusion
from benchmark.reference.clip import CLIPTextModel, OpenCLIP
from benchmark.reference.layers import build, full_precision
from benchmark.reference.sd_unet import UNet2DConditionModel
from benchmark.reference.sd_vae import AutoencoderKL
from benchmark.reference.tokenizer import BPETokenizer, tokenize

DECODE_BLOCK = 2  # images decoded at once


class _Schedule:
    def __init__(self, cfg: dict, device):
        alphas, sigmas = diffusion.scaled_linear_schedule(cfg["schedule"])
        self.alphas_np, self.sigmas_np = alphas, sigmas
        self.alphas = torch.as_tensor(alphas, device=device)
        self.sigmas = torch.as_tensor(sigmas, device=device)

    def at(self, index: int):
        return float(self.alphas_np[index]), float(self.sigmas_np[index])


def decode(vae, latents: torch.Tensor) -> torch.Tensor:
    return torch.cat([vae.decode(latents[i:i + DECODE_BLOCK].float())
                      for i in range(0, latents.shape[0], DECODE_BLOCK)])


class GuidedReference(_Schedule):
    def __init__(self, cfg: dict, states: dict, device, fp8: bool = False):
        full_precision()
        super().__init__(cfg, device)
        self.cfg = cfg
        self.unet = build(UNet2DConditionModel, cfg["unet"], states["unet"], fp8)
        self.vae = build(AutoencoderKL, cfg["vae"], states["vae"], fp8)
        self.clip = build(OpenCLIP, cfg["clip"], states["clip"], fp8)
        self.update_dtype = torch.bfloat16 if fp8 else torch.float64
        guide = cfg["guidance"]
        self.from_index, self.to_index = guide["from_index"], guide["to_index"]
        target = np.random.default_rng(guide["target_rng_seed"]).normal(
            size=(1, cfg["clip"]["embed_dim"]))
        target = target / np.linalg.norm(target, axis=-1, keepdims=True)
        self.target = torch.as_tensor(target.astype(np.float32), device=device)

    def loss_noise_grad(self, latents: torch.Tensor, context: torch.Tensor):
        """(noise, gradient of the loss with respect to `latents`, loss)."""
        a, s = self.at(self.from_index)
        x = latents.detach().float().requires_grad_(True)
        t = torch.full((x.shape[0],), float(self.from_index), device=x.device)
        with torch.enable_grad():
            noise = self.unet(x, t, context.float())
            images = self.vae.decode((x - s * noise) / a)
            inputs = diffusion.clip_input(images, self.cfg["clip"]["image_size"])
            loss = diffusion.spherical_loss(self.clip.encode_image(inputs), self.target)
            (grad,) = torch.autograd.grad(loss, x)
        return noise.detach(), grad, loss.detach()

    def update(self, latents, noise, grad) -> torch.Tensor:
        """The guided DDIM update of `latents` by `noise` and `grad`."""
        guide = self.cfg["guidance"]
        a, s = self.at(self.from_index)
        a_to, s_to = self.at(self.to_index)
        x, noise, grad = (t.to(self.update_dtype) for t in (latents, noise, grad))
        eps = diffusion.guided_eps(noise, grad, s, guide["scale"], guide["clamp"])
        return diffusion.ddim_step(x, eps, a, s, a_to, s_to)

    def step(self, latents, context) -> dict:
        """One guided step in the program's place: a record as the driver
        keeps them."""
        noise, grad, loss = self.loss_noise_grad(latents, context)
        out = self.update(latents, noise, grad).float()
        return {"latents_in": latents, "noise": noise, "grad": grad, "loss": loss,
                "latents_out": out}


class Txt2ImgReference(_Schedule):
    def __init__(self, cfg: dict, states: dict, device, fp8: bool = False):
        full_precision()
        super().__init__(cfg, device)
        self.cfg = cfg
        self.device = device
        self.unet = build(UNet2DConditionModel, cfg["unet"], states["unet"], fp8)
        self.vae = build(AutoencoderKL, cfg["vae"], states["vae"], fp8)
        self.text = build(CLIPTextModel, cfg["text_encoder"], states["text_encoder"], fp8)
        self.update_dtype = torch.bfloat16 if fp8 else torch.float32
        self.tokenizer = BPETokenizer()

    def encode(self, texts) -> torch.Tensor:
        text = self.cfg["text_encoder"]
        tokens = tokenize(self.tokenizer, texts, text["max_position_embeddings"], text["pad_id"])
        return self.text(torch.as_tensor(tokens, device=self.device))

    def pairs(self, n_steps: int, rho: float) -> np.ndarray:
        return diffusion.rho_index_pairs(self.alphas_np, self.sigmas_np, n_steps, rho)

    def initial_latents(self, n: int, size: int, generator_seed: int) -> torch.Tensor:
        """The sampler's first draw from a generator seeded `generator_seed`
        on the device."""
        gen = torch.Generator(device=self.device).manual_seed(generator_seed)
        down = 2 ** (len(self.cfg["vae"]["block_out_channels"]) - 1)
        return torch.randn((n, self.cfg["vae"]["latent_channels"], size // down, size // down),
                           generator=gen, device=self.device)

    def unet_out(self, latents, index: int, context2) -> torch.Tensor:
        """The UNet's noise for the batch of CFG: `latents` twice, under the
        empty prompts' states and the prompts'."""
        t = torch.full((2 * latents.shape[0],), float(index), device=latents.device)
        return self.unet(torch.cat([latents, latents]).float(), t, context2)

    def update(self, latents, unet_out, index: int, to_index: int, scale: float,
               dtype=torch.float64) -> torch.Tensor:
        """The CFG combination of `unet_out` and the DDIM update of
        `latents` from `index` to `to_index`, in `dtype`."""
        uncond, cond = unet_out.to(dtype).chunk(2)
        eps = diffusion.cfg_eps(uncond, cond, scale)
        return diffusion.ddim_step(latents.to(dtype), eps, *self.at(index), *self.at(to_index))

    def sample(self, prompts, generator_seed: int, mix: dict) -> dict:
        """One call in the program's place: a record as the driver keeps
        them."""
        n = len(prompts)
        context2 = self.encode([""] * n + list(prompts))
        x = self.initial_latents(n, mix["size"], generator_seed)
        latents, ts, unet_outs = [], [], []
        for i, j in self.pairs(mix["steps"], mix["rho"]):
            latents.append(x)
            ts.append(torch.full((2 * n,), float(i), device=x.device))
            unet_outs.append(self.unet_out(x, int(i), context2))
            x = self.update(x, unet_outs[-1], int(i), int(j), mix["guidance_scale"],
                            self.update_dtype).float()
        return {"prompts": list(prompts), "generator_seed": generator_seed, "context2": context2,
                "latents": latents, "ts": ts, "unet_out": unet_outs, "final_latents": x,
                "images": decode(self.vae, x)}
