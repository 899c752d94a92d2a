"""StableDiffusion wrapper: UNet + KL-VAE + CLIP text conditioning
(counterpart of perceptor_tpu/models/stable_diffusion/stable_diffusion.py).

  - DDPM scaled-linear schedule as alpha/sigma tables on the device;
  - Karras-rho `schedule_indices` snapped to the 1000-index grid;
  - `predictions()` -> LatentIndexedEpsPredictions (eps algebra);
  - `encode`/`decode` through the VAE, `preview_images_fn` without it;
  - `conditioning(texts)` through the tokenizer and the CLIP text encoder;
  - `sample()`: text to images with classifier-free guidance (CFG), DDIM
    (`eta` for the stochastic variant) or DPM-Solver++(2M), img2img
    (`init_images` + `from_index`), RePaint resampling (`n_resample`) and
    DeepCache (`cache_interval`: the UNet's deep levels rerun every k-th
    step and are reused in between) and, with the inpainting checkpoint,
    inpainting (`inpainting_masks`; `replace_diffused` re-injects the known
    region after every step);
  - `conditioning(texts, inpainting_masks, inpainting_images)`: the text
    encodings, or for the 9-channel inpainting UNet a `Conditioning` that
    also carries the blurred latent mask and the masked image's latents;
  - `finetuneable_vae()`: VAE gradients on inside, the frozen weights
    restored on exit.

CFG runs the uncond/cond pair as one batched UNet call (batch 2N), as the
JAX program does. Where JAX compiles the sampler into one `lax.scan`
program, here `sample_loop` is an eager Python loop over the schedule
pairs. Randomness comes from an explicit `torch.Generator`.

Weights come from a checkpoint found in the cache directories
(`utils/checkpoints.py`), else they are seeded random at the published
widths; stored in bf16 for matmuls and convolutions when `fp16`.
`load_state_dicts` takes real or converted weights
(`convert.stable_diffusion_state_dicts_from_jax`); an original CompVis
checkpoint's UNet keys map onto `UNet` through
`models/stable_diffusion/convert.py compvis_to_diffusers_unet`.

Stable Diffusion XL base 1.0 ("stabilityai/stable-diffusion-xl-base-1.0",
"tiny-xl" for tests) runs on the same entry points: `conditioning` encodes
with both towers and gives a `Conditioning` that carries the pooled
embedding and the size ids besides the states; with no negative prompts
the unconditional half is zeros (the pipeline's
`force_zeros_for_empty_prompt`). DeepCache, inpainting, meshes and the
exported programs are not extended to it and raise.

`export_sample` and `export_conditioning` trace the sampler and the text
encoder into `torch.export` programs (utils/serving.py); `prime` warms the
eager sampler. `sample(mesh=, rules=)` and `sample_loop(mesh=, rules=)`
sample with the weights placed on a DeviceMesh by the tensor-parallel rules
(`parallel.partition.sampling`).
"""

from __future__ import annotations

import dataclasses
import itertools
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.clip.tokenizer import SimpleTokenizer, tokenize
from perceptor_tpu_torch.models.stable_diffusion import config as sd_config
from perceptor_tpu_torch.models.stable_diffusion.convert import compvis_to_diffusers_unet
from perceptor_tpu_torch.models.stable_diffusion.text_encoder import CLIPTextEncoder
from perceptor_tpu_torch.models.stable_diffusion.unet import UNet
from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL
from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.ops.resize import interpolate_bilinear
from perceptor_tpu_torch.predictions import LatentIndexedEpsPredictions
from perceptor_tpu_torch.predictions import base as prediction_base
from perceptor_tpu_torch.schedules import indexed_schedule, scaled_linear_alphas_sigmas
from perceptor_tpu_torch.utils import profiling, serving
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

# Published SD-1.x linear latent -> RGB preview factors (rows: the 4 latent
# channels); an approximate, differentiable decode for preview and guidance.
_LATENT_RGB_FACTORS = np.array(
    [
        [0.298, 0.207, 0.208],
        [0.187, 0.286, 0.173],
        [-0.158, 0.189, 0.264],
        [-0.184, -0.271, -0.473],
    ],
    dtype=np.float32,
)

METHODS = ("ddim", "dpm++")


@dataclasses.dataclass(frozen=True, eq=False)
class Conditioning:
    """Text-encoder states plus, for the inpainting UNet, the blurred
    latent mask (N|1, 1, h, w) and the masked image's latents (N|1, 4, h, w)
    that extend its input to 9 channels, or, for SDXL, the pooled text
    embedding (N, P) and the size ids (N, 6) of its added embedding."""

    model_name: str
    encodings: torch.Tensor
    inpainting_latent_masks: Optional[torch.Tensor] = None
    inpainting_latents: Optional[torch.Tensor] = None
    pooled: Optional[torch.Tensor] = None
    size_ids: Optional[torch.Tensor] = None

    def __neg__(self) -> "Conditioning":
        """Negated encodings; the mask and latents stay."""
        return dataclasses.replace(self, encodings=-self.encodings)

    def zeros(self) -> "Conditioning":
        """Zero states and pooled embedding, the same size ids: SDXL's
        unconditional half with no negative prompt."""
        return dataclasses.replace(self, encodings=torch.zeros_like(self.encodings),
                                   pooled=torch.zeros_like(self.pooled))

    @property
    def added(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The UNet's `added` argument, or None."""
        return None if self.pooled is None else (self.pooled, self.size_ids)

    def input(self, diffused_latents: torch.Tensor) -> torch.Tensor:
        """The UNet input: the latents alone, or [latents, the mask binarized
        at 0.5, the masked latents] on dim 1, broadcast over the batch."""
        if self.inpainting_latent_masks is None:
            return diffused_latents
        n, dtype = diffused_latents.shape[0], diffused_latents.dtype
        masks = (self.inpainting_latent_masks >= 0.5).to(dtype)
        latents = self.inpainting_latents.to(dtype)
        return torch.cat(
            [diffused_latents, masks.expand(n, *masks.shape[1:]),
             latents.expand(n, *latents.shape[1:])],
            dim=1,
        )


def _gaussian_blur(images: torch.Tensor, sigma: float) -> torch.Tensor:
    """kornia's gaussian_blur2d: kernel size int(2 sigma) + 1, a normalized
    Gaussian, reflect padding, two depthwise 1-D passes (H, then W)."""
    size = int(sigma * 2) + 1
    xs = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    kernel = np.exp(-0.5 * (xs / sigma) ** 2)
    kernel = torch.as_tensor((kernel / kernel.sum()).astype(np.float32), device=images.device)
    pad, c = size // 2, images.shape[1]
    out = F.pad(images, (0, 0, pad, pad), mode="reflect")
    out = F.conv2d(out, kernel.reshape(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    out = F.pad(out, (pad, pad, 0, 0), mode="reflect")
    return F.conv2d(out, kernel.reshape(1, 1, 1, size).expand(c, 1, 1, size), groups=c)


class StableDiffusion:
    def __init__(
        self,
        name: str = "runwayml/stable-diffusion-v1-5",
        fp16: bool = True,
        tokenizer: Optional[SimpleTokenizer] = None,
        device="cuda",
        seed: int = 0,
        remat: bool = False,
    ):
        """`name` is "tiny", "tiny-inpainting", "tiny-xl" or a key of
        `config.MODEL_CONFIGS`; `fp16` stores matmul/conv weights in bf16
        (bf16 compute); weights come from the checkpoint that
        `find_checkpoint("stable_diffusion_<name with / as _>", name)` finds
        (`utils.checkpoints.load_found`: the port's artifact, JAX's
        params-v1, the port's own keys, or a CompVis or diffusers file), else
        they are random from `seed`; `device` is CUDA
        unless the caller passes "cpu"; `remat` recomputes the UNet's res and
        transformer blocks in the backward pass (guidance)."""
        if name in ("tiny", "tiny-inpainting"):
            unet = sd_config.TINY_UNET if name == "tiny" else sd_config.TINY_INPAINT_UNET
            configs = (unet, sd_config.TINY_VAE, sd_config.TINY_TEXT)
        elif name == "tiny-xl":
            configs = (sd_config.TINY_XL_UNET, sd_config.TINY_XL_VAE, sd_config.TINY_XL_TEXT,
                       sd_config.TINY_XL_TEXT_2)
        elif name in sd_config.MODEL_CONFIGS:
            configs = sd_config.MODEL_CONFIGS[name]
        else:
            raise ValueError(f"unknown stable diffusion name: {name}")
        self.name = name
        self.device = resolve_device(device)
        self.unet_config, self.vae_config, self.text_config = configs[:3]
        self.text_config_2 = configs[3] if len(configs) > 3 else None
        self.unet_config = dataclasses.replace(self.unet_config, remat=remat)
        dtype = COMPUTE_DTYPE if fp16 else torch.float32
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.unet = random_module(UNet, self.unet_config, self.device, gen, dtype)
        self.vae = random_module(AutoencoderKL, self.vae_config, self.device, gen, dtype)
        self.text_encoder = random_module(
            CLIPTextEncoder, self.text_config, self.device, gen, dtype
        )
        if self.xl:
            self.text_encoder_2 = random_module(
                CLIPTextEncoder, self.text_config_2, self.device, gen, dtype
            )
        self._tokenizer = tokenizer
        self._sample_calls = itertools.count()
        alphas, sigmas = scaled_linear_alphas_sigmas()
        self.schedule_alphas = torch.as_tensor(alphas, device=self.device)
        self.schedule_sigmas = torch.as_tensor(sigmas, device=self.device)
        path = find_checkpoint(f"stable_diffusion_{name.replace('/', '_')}", name)
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self._load_upstream)

    @property
    def xl(self) -> bool:
        """SDXL: two text towers and the added embedding."""
        return self.text_config_2 is not None

    def _refuse_xl(self, what: str) -> None:
        if self.xl:
            raise ValueError(f"{what} is not extended to {self.name}: it would run without "
                             "SDXL's second text tower and added conditioning")

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import stable_diffusion_state_dicts_from_jax

        self._refuse_xl("loading the JAX package's params")
        return stable_diffusion_state_dicts_from_jax(
            params, self.unet_config, self.vae_config, self.text_config)

    def _load_upstream(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """A CompVis checkpoint (`model.diffusion_model.*`,
        `first_stage_model.*`, `cond_stage_model.transformer.*`) or a
        diffusers pipeline's (`unet.*`, `vae.*`, `text_encoder.*`, the text
        encoder in HF names; SDXL's also `text_encoder_2.*`, an HF
        `CLIPTextModelWithProjection`). SDXL's single-file layout
        (`conditioner.embedders.*`) is not read."""
        from perceptor_tpu_torch.convert import text_encoder_state_dict_from_hf
        from perceptor_tpu_torch.models.latent_diffusion.first_stage import (
            convert_compvis_autoencoder,
        )

        def sub(prefix):
            return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

        if any(k.startswith("model.diffusion_model.") for k in state_dict):
            self._refuse_xl("a CompVis / single-file checkpoint")
            states = {
                "unet": compvis_to_diffusers_unet(state_dict, self.unet_config),
                "vae": convert_compvis_autoencoder(state_dict, self.vae_config),
                "text_encoder": text_encoder_state_dict_from_hf(
                    sub("cond_stage_model.transformer."), self.text_config),
            }
        else:
            states = {"unet": sub("unet."), "vae": sub("vae."),
                      "text_encoder": text_encoder_state_dict_from_hf(
                          sub("text_encoder."), self.text_config)}
            if self.xl:
                states["text_encoder_2"] = text_encoder_state_dict_from_hf(
                    sub("text_encoder_2."), self.text_config_2)
        self.load_state_dicts(states)

    _PARTS = ("unet", "vae", "text_encoder")

    @property
    def parts(self) -> Tuple[str, ...]:
        """The modules' names: SDXL adds "text_encoder_2"."""
        return self._PARTS + (("text_encoder_2",) if self.xl else ())

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"unet", "vae", "text_encoder"} (and SDXL's "text_encoder_2"):
        each module's parameters and buffers by name, the weights argument
        of the exported programs."""
        return {part: serving.module_params(getattr(self, part)) for part in self.parts}

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Load {"unet", "vae", "text_encoder"} (and SDXL's
        "text_encoder_2") state_dicts (each module keeps its own storage
        dtypes)."""
        for key in self.parts:
            getattr(self, key).load_state_dict(state_dicts[key])

    @property
    def tokenizer(self) -> SimpleTokenizer:
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    # -- schedule ------------------------------------------------------------

    def schedule_indices(
        self, n_steps: int = 50, from_index: int = 999, to_index: int = 0, rho: float = 7.0
    ) -> np.ndarray:
        """(k, 2) (from, to) index pairs, k <= n_steps."""
        return indexed_schedule(
            self.schedule_alphas.cpu().numpy(),
            self.schedule_sigmas.cpu().numpy(),
            n_steps=n_steps,
            from_index=from_index,
            to_index=to_index,
            rho=rho,
            strict=False,
        )

    # -- models --------------------------------------------------------------

    def _indices(self, indices, batch: int) -> torch.Tensor:
        indices = torch.as_tensor(indices, device=self.device)
        if indices.ndim == 0:
            indices = indices.expand(batch)
        return indices

    def _unet(self, latents, ts, conditioning, **kwargs) -> torch.Tensor:
        """The UNet under text encodings or a `Conditioning` (whose input
        assembly gives the inpainting UNet its 9 channels, and whose
        pooled embedding and size ids SDXL's UNet adds)."""
        if isinstance(conditioning, Conditioning):
            if conditioning.pooled is not None:
                kwargs = dict(kwargs, added=conditioning.added)
            return self.unet(conditioning.input(latents), ts, conditioning.encodings, **kwargs)
        return self.unet(latents, ts, conditioning, **kwargs)

    def predictions(
        self, diffused_latents, indices, conditioning
    ) -> LatentIndexedEpsPredictions:
        """UNet eps prediction at schedule `indices` under text encodings
        (N, 77, context_dim) or a `Conditioning`."""
        indices = self._indices(indices, diffused_latents.shape[0])
        return self._make_predictions(
            diffused_latents, indices, self._unet(diffused_latents, indices.float(), conditioning)
        )

    def _make_predictions(self, latents, indices, noise) -> LatentIndexedEpsPredictions:
        return LatentIndexedEpsPredictions(
            from_diffused_latents=latents,
            from_indices=indices,
            predicted_noise=noise,
            schedule_alphas=self.schedule_alphas,
            schedule_sigmas=self.schedule_sigmas,
            encode=self.encode,
            decode=self.decode,
        )

    def encode(self, images, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (N, 3, H, W) in [0, 1] -> scaled latents: the posterior's
        mode, or a sample from `generator`."""
        self._check_size(images.shape[-2:])
        return self.vae.encode(images, generator)

    def decode(self, latents) -> torch.Tensor:
        """scaled latents -> images (N, 3, H, W), fp32."""
        return self.vae.decode(latents)

    @contextmanager
    def finetuneable_vae(self):
        """A scope in which the VAE can be finetuned: its parameters require
        gradients inside; on exit the weights it had on entry and their
        `requires_grad` flags come back::

            with model.finetuneable_vae() as m:
                optimizer = torch.optim.Adam(m.vae.parameters())
                loss(m.decode(latents)).backward()
                optimizer.step()
            # the original frozen VAE is restored here
        """
        saved = {k: v.detach().clone() for k, v in self.vae.state_dict().items()}
        flags = {name: p.requires_grad for name, p in self.vae.named_parameters()}
        self.vae.requires_grad_(True)
        try:
            yield self
        finally:
            with torch.no_grad():
                self.vae.load_state_dict(saved)
            for name, p in self.vae.named_parameters():
                p.requires_grad_(flags[name])

    def preview_images_fn(self, latents) -> torch.Tensor:
        """Linear latent -> RGB preview at latent resolution (no VAE):
        approximate but differentiable and nearly free."""
        factors = torch.as_tensor(_LATENT_RGB_FACTORS, dtype=latents.dtype, device=latents.device)
        rgb = torch.einsum("nchw,cd->ndhw", latents, factors)
        return clamp_with_grad(rgb * 0.5 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    def latent_masks(self, masks, blur: Optional[float] = 4.0) -> torch.Tensor:
        """masks (N, 1, H, W) in [0, 1] -> (N, 1, H/8, W/8) fp32: a Gaussian
        blur of `blur` sigma (none when None or 0), then a bilinear resize
        with half-pixel centers."""
        masks = torch.as_tensor(masks, dtype=torch.float32, device=self.device)
        n, c, h, w = masks.shape
        self._check_size((h, w))
        if c != 1:
            raise ValueError("Masks must be 1-channel")
        if float(masks.max()) > 1 or float(masks.min()) < 0:
            raise ValueError("Masks must be between 0 and 1")
        if blur is not None and blur > 0:
            masks = _gaussian_blur(masks, blur)
        down = self.vae_config.downscale
        return interpolate_bilinear(masks, (h // down, w // down), align_corners=False)

    @property
    def inpainting(self) -> bool:
        """The 9-channel UNet: latents, mask, masked-image latents."""
        return self.unet_config.in_channels == 2 * self.vae_config.latent_channels + 1

    @torch.no_grad()
    def conditioning(self, texts: Sequence[str], inpainting_masks=None, inpainting_images=None,
                     mask_blur: float = 4.0, size: Optional[Tuple[int, int]] = None):
        """texts -> (N, 77, width) fp32 text-encoder states; for the
        inpainting checkpoint a `Conditioning` with them, the latent masks
        of `inpainting_masks` and the posterior mode of the masked images
        (pixels where the unblurred mask exceeds 0.5 set to 0.5). Span
        `text_encode`, `rows` the prompt count.

        SDXL: a `Conditioning` of both towers' penultimate states joined on
        the width, the second tower's pooled projection and the size ids
        (H, W, 0, 0, H, W) of the image `size` (default 1024 x 1024); one
        `text_encode` span a tower, `tower` its index."""
        texts = list(texts)
        if self.xl:
            if inpainting_masks is not None:
                self._refuse_xl("inpainting")
            return self._xl_conditioning(texts, size)
        with profiling.annotate("text_encode", rows=len(texts)):
            tokens = tokenize(texts, self.text_config.context_length, tokenizer=self.tokenizer)
            encodings = self.text_encoder(torch.from_numpy(tokens).to(self.device))
        if not self.inpainting:
            return encodings
        if inpainting_masks is None or inpainting_images is None:
            raise ValueError("the inpainting checkpoint needs inpainting_masks and "
                             "inpainting_images")
        masks = torch.as_tensor(inpainting_masks, dtype=torch.float32, device=self.device)
        images = torch.as_tensor(inpainting_images, dtype=torch.float32, device=self.device)
        latent_masks = self.latent_masks(masks, mask_blur)
        masked = images * (masks <= 0.5) + 0.5 * (masks > 0.5)
        return Conditioning(self.name, encodings, latent_masks, self.encode(masked))

    def _xl_conditioning(self, texts, size) -> Conditioning:
        height, width = size or (sd_config.SDXL_SIZE, sd_config.SDXL_SIZE)
        with profiling.annotate("text_encode", rows=len(texts), tower=0):
            # both towers share the tokenizer and its padding
            tokens = tokenize(texts, self.text_config.context_length, tokenizer=self.tokenizer)
            tokens = torch.from_numpy(tokens).to(self.device)
            states, _ = self.text_encoder.encode(tokens)
        with profiling.annotate("text_encode", rows=len(texts), tower=1):
            states_2, pooled = self.text_encoder_2.encode(tokens)
        size_ids = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                                device=self.device).expand(len(texts), 6)
        return Conditioning(self.name, torch.cat([states, states_2], dim=-1), pooled=pooled,
                            size_ids=size_ids)

    def diffuse_latents(self, latents, indices, generator: torch.Generator) -> torch.Tensor:
        """q-sample: alpha * x0 + sigma * noise."""
        indices = self._indices(indices, latents.shape[0]).long()
        alphas = self.schedule_alphas[indices][:, None, None, None]
        sigmas = self.schedule_sigmas[indices][:, None, None, None]
        noise = torch.randn(
            latents.shape, generator=generator, device=latents.device, dtype=latents.dtype
        )
        return latents * alphas + noise * sigmas

    def random_diffused_latents(
        self, shape: Tuple[int, int, int], generator: torch.Generator
    ) -> torch.Tensor:
        """(N, H, W) pixel shape -> fully diffused latents."""
        n, height, width = shape
        self._check_size((height, width))
        down = self.vae_config.downscale
        return torch.randn(
            (n, self.vae_config.latent_channels, height // down, width // down),
            generator=generator, device=self.device,
        )

    def _check_size(self, size) -> None:
        down = self.vae_config.downscale
        if size[0] % down or size[1] % down:
            raise ValueError(f"image size must be divisible by {down}, got {tuple(size)}")

    # -- samplers ------------------------------------------------------------

    @torch.no_grad()
    def sample(
        self,
        texts: Sequence[str],
        negative_texts: Optional[Sequence[str]] = None,
        n_steps: int = 50,
        guidance_scale: float = 7.0,
        size: Tuple[int, int] = (512, 512),
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
        from_index: int = 999,
        to_index: int = 0,
        n_resample: int = 0,
        init_images=None,
        method: str = "ddim",
        cache_interval: int = 1,
        inpainting_masks=None,
        mask_blur: float = 4.0,
        replace_diffused: bool = True,
        mesh=None,
        rules=None,
    ) -> torch.Tensor:
        """Text -> images (N, 3, H, W) in [0, 1], fp32.

        img2img starts from `init_images` (their VAE latents diffused to
        `from_index`); `n_resample` adds RePaint resampling iterations per
        step; `method="dpm++"` swaps the DDIM update for DPM-Solver++(2M),
        which is deterministic (no `eta`, no `n_resample`). Negative
        prompts replace the empty uncond prompt. `generator` defaults to
        one seeded 0 on the model's device. `cache_interval > 1` turns on
        DeepCache: step i runs the whole UNet when i % cache_interval == 0
        and otherwise only its shallowest level on the cached deep feature
        (fewer FLOPs at a small quality cost; 1, the default, is exact;
        `n_resample` is refused with it).

        The inpainting checkpoint takes `inpainting_masks` (N, 1, H, W),
        1 where to paint, with `init_images` the pictures to paint into;
        `mask_blur` is the latent mask's Gaussian sigma in pixels, and
        `replace_diffused` puts the init latents, diffused to each step's
        target index, back outside that mask after every step.

        `mesh` (a DeviceMesh of `parallel.create_mesh`) samples with the
        UNet, VAE and text-encoder weights placed by the tensor-parallel
        `rules` (`parallel.SD_TENSOR_PARALLEL_RULES` by default), the
        latent batch sharded over the data axis when it divides, and, with
        a context axis, the attention routed through ring/Ulysses
        (`parallel.partition.sampling`). With a data axis each data rank
        draws its stochastic noise for its own rows. `mesh=None` is the
        single-device sampler, unchanged.

        Span `sample`, `call` counting this instance's calls from 0 and
        `rows` the prompt count; inside it `text_encode`, one `sampler_step`
        a schedule pair and `vae_decode`."""
        self._check_method(method, eta, n_resample, cache_interval)
        self._check_xl(cache_interval, mesh, inpainting_masks)
        texts = list(texts)
        with profiling.annotate("sample", call=next(self._sample_calls), rows=len(texts)):
            generator, uncond, cond, pairs, latents, init_latents = self._setup(
                texts, negative_texts, n_steps, size, generator, from_index, to_index,
                init_images, inpainting_masks, mask_blur,
            )
            options = dict(eta=eta, generator=generator, n_resample=n_resample, method=method,
                           cache_interval=cache_interval, replace_diffused=replace_diffused)
            if mesh is None:
                latents = self.sample_loop(latents, pairs, uncond, cond, guidance_scale,
                                           init_latents=init_latents, **options)
                return self.decode(latents)
            from perceptor_tpu_torch.parallel.partition import sampling

            with sampling(mesh, self.serving_modules(), latents, rules) as run:
                latents = self.sample_loop(run.latents, pairs, run.rows(uncond),
                                           run.rows(cond), guidance_scale,
                                           init_latents=run.rows(init_latents), **options)
                return run.gather(self.decode(latents))

    def _setup(
        self, texts, negative_texts, n_steps, size, generator,
        from_index=999, to_index=0, init_images=None, inpainting_masks=None, mask_blur=4.0,
    ):
        """The sampler's inputs: the generator (seeded 0 on the model's
        device by default), the uncond (negative or empty prompts) and cond
        conditionings, the schedule pairs, the initial latents (random, or
        `init_images` encoded and diffused to the first index) and the init
        latents (None without `init_images`). The VAE encodes in JAX's
        order: the uncond and cond masked images, then `init_images`."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        texts = list(texts)
        inpaint = dict(inpainting_masks=inpainting_masks, inpainting_images=init_images,
                       mask_blur=mask_blur)
        if self.xl:  # no negative prompts: zeros, not the empty prompt's encodings
            cond = self.conditioning(texts, size=size, **inpaint)
            uncond = (self.conditioning(list(negative_texts), size=size, **inpaint)
                      if negative_texts else cond.zeros())
        else:
            uncond = self.conditioning(
                list(negative_texts) if negative_texts else [""] * len(texts), **inpaint)
            cond = self.conditioning(texts, **inpaint)
        pairs = self.schedule_indices(n_steps, from_index=from_index, to_index=to_index)
        if init_images is None:
            if from_index != 999:
                raise ValueError("init_images must be provided if from_index < 999")
            latents = self.random_diffused_latents((len(texts), *size), generator)
            init_latents = None
        else:
            init_images = torch.as_tensor(init_images, dtype=torch.float32, device=self.device)
            init_latents = self.encode(init_images)
            latents = self.diffuse_latents(init_latents, int(pairs[0, 0]), generator)
        return generator, uncond, cond, pairs, latents, init_latents

    @staticmethod
    def _check_method(method: str, eta, n_resample: int, cache_interval: int = 1) -> None:
        if method not in METHODS:
            raise ValueError(f"unknown sampling method: {method!r}")
        if method == "dpm++" and (eta or n_resample):
            raise ValueError("dpm++ is deterministic: eta/n_resample do not apply")
        if cache_interval > 1 and n_resample > 0:
            raise ValueError("cache_interval and n_resample are incompatible")

    def _check_xl(self, cache_interval: int = 1, mesh=None, inpainting_masks=None) -> None:
        """The sampler's options that SDXL does not have."""
        if cache_interval > 1:
            self._refuse_xl("DeepCache (cache_interval > 1)")
        if mesh is not None:
            self._refuse_xl("sampling on a mesh")
        if inpainting_masks is not None:
            self._refuse_xl("inpainting")

    def cfg_predictions(self, latents, from_idx, context2, guidance_scale, cache=None,
                        return_cache=False):
        """CFG predictions from one batched UNet call on the (uncond, cond)
        pair; `context2` is the uncond and cond encodings concatenated, or a
        `Conditioning` of them (with the cond's mask and masked latents).
        `cache` / `return_cache` pass through to the UNet's DeepCache
        branch; with `return_cache` the result is (predictions, cache). The
        combination is a `cfg_combine` span."""
        noise2 = self._unet(
            torch.cat([latents, latents]), torch.cat([from_idx, from_idx]).float(), context2,
            cache=cache, return_cache=return_cache,
        )
        if return_cache:
            noise2, cache = noise2
        with profiling.annotate("cfg_combine"):
            noise_uncond, noise_cond = noise2.chunk(2)
            predictions = self._make_predictions(
                latents, from_idx, noise_uncond
            ).classifier_free_guidance(self._make_predictions(latents, from_idx, noise_cond),
                                       guidance_scale)
        return (predictions, cache) if return_cache else predictions

    @torch.no_grad()
    def sample_loop(
        self,
        latents: torch.Tensor,
        pairs,
        uncond: torch.Tensor,
        cond: torch.Tensor,
        guidance_scale: float = 7.0,
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
        n_resample: int = 0,
        method: str = "ddim",
        cache_interval: int = 1,
        init_latents: Optional[torch.Tensor] = None,
        replace_diffused: bool = True,
        mesh=None,
        rules=None,
    ) -> torch.Tensor:
        """The sampler from given diffused latents: for each (from, to)
        pair of `pairs`, `n_resample` RePaint iterations, then one CFG
        prediction (through the DeepCache partial pass on the steps
        `cache_interval` skips) and a DDIM (or DPM-Solver++(2M)) step.
        `uncond` and `cond` are encodings or `Conditioning`s; when `cond`
        carries an inpainting mask and `init_latents` are given,
        `replace_diffused` re-injects them outside the mask after each
        step. `mesh` / `rules` as in `sample`. Returns the final latents."""
        self._check_method(method, eta, n_resample, cache_interval)
        self._check_xl(cache_interval, mesh)
        if mesh is not None:
            from perceptor_tpu_torch.parallel.partition import sampling

            with sampling(mesh, self.serving_modules(), latents, rules) as run:
                return run.gather(self.sample_loop(
                    run.latents, pairs, run.rows(uncond), run.rows(cond), guidance_scale, eta,
                    generator, n_resample, method, cache_interval, run.rows(init_latents),
                    replace_diffused))
        for latents, _ in self._steps(
            latents, pairs, uncond, cond, guidance_scale, eta, generator, n_resample, method,
            cache_interval, init_latents, replace_diffused,
        ):
            pass
        return latents

    def _steps(self, latents, pairs, uncond, cond, guidance_scale, eta, generator, n_resample,
               method, cache_interval=1, init_latents=None, replace_diffused=False):
        """Yields (latents, CFG predictions) after each (from, to) pair. Span
        `sampler_step` a pair, `step` its index, closed before the yield:
        it holds `cfg_predictions`' `unet` and `cfg_combine`, then
        `sampler_update` (each update of the latents: RePaint's resamples,
        the DDIM or DPM++ step)."""
        n = latents.shape[0]
        context2 = torch.cat([getattr(c, "encodings", c) for c in (uncond, cond)])
        masks = getattr(cond, "inpainting_latent_masks", None)
        if masks is not None:  # the cond's mask and masked latents serve both halves
            context2 = dataclasses.replace(cond, encodings=context2)
        if getattr(cond, "pooled", None) is not None:  # SDXL's added conditioning, both halves
            context2 = dataclasses.replace(
                cond, encodings=context2, pooled=torch.cat([uncond.pooled, cond.pooled]),
                size_ids=torch.cat([uncond.size_ids, cond.size_ids]))
        replace = replace_diffused and masks is not None and init_latents is not None
        pairs = torch.as_tensor(np.asarray(pairs), device=self.device).long()
        prev_x0, prev_h = torch.zeros_like(latents), torch.ones((n, 1, 1, 1), device=self.device)
        cache = None  # step 0 runs the whole UNet
        for i in range(pairs.shape[0]):
            from_idx, to_idx = pairs[i, 0].expand(n), pairs[i, 1].expand(n)
            with profiling.annotate("sampler_step", step=i):
                for _ in range(n_resample):  # RePaint
                    predictions = self.cfg_predictions(latents, from_idx, context2,
                                                       guidance_scale)
                    with profiling.annotate("sampler_update"):
                        latents = predictions.resample(to_idx, generator)
                if cache_interval > 1:
                    predictions, cache = self.cfg_predictions(
                        latents, from_idx, context2, guidance_scale,
                        cache=cache if i % cache_interval else None, return_cache=True,
                    )
                else:
                    predictions = self.cfg_predictions(latents, from_idx, context2,
                                                       guidance_scale)
                with profiling.annotate("sampler_update"):
                    if method == "dpm++":
                        latents, prev_h = predictions.dpm_solver_pp_step(to_idx, prev_x0, prev_h,
                                                                         i == 0)
                        prev_x0 = predictions.denoised_xs
                    else:
                        latents = predictions.step(to_idx, eta=eta, generator=generator)
                    if replace:  # the known region, diffused to the step's target
                        alphas = self.schedule_alphas[to_idx][:, None, None, None]
                        sigmas = self.schedule_sigmas[to_idx][:, None, None, None]
                        fresh = prediction_base.randn_like(latents, generator)
                        latents = ((init_latents * alphas + fresh * sigmas) * (1 - masks)
                                   + latents * masks)
            yield latents, predictions

    # -- serving -------------------------------------------------------------

    def prime(self, sizes=((512, 512),), n_steps: int = 50, **kwargs) -> None:
        """Warm the sampler for the given image sizes: build the flash
        kernels' library (on CUDA), then run one short `sample` at each size
        so that cuDNN's algorithm choices and the allocator's pools are
        settled before the first real call. Eager PyTorch compiles nothing,
        so this warms rather than compiles; `kwargs` go to `sample`."""
        if self.device.type == "cuda":
            from perceptor_tpu_torch.ops import flash_attention_kernel

            flash_attention_kernel.build_library()
        for size in sizes:
            self.sample([""], n_steps=n_steps, size=tuple(size), **kwargs)

    def _step_draws(self, n_pairs: int, eta: float, n_resample: int) -> int:
        """The noise draws `sample_loop` makes: one per RePaint iteration
        and, with eta > 0, one per DDIM step."""
        return n_pairs * (n_resample + (1 if float(eta) > 0.0 else 0))

    def sample_noise_shape(self, batch: int = 1, size: Tuple[int, int] = (512, 512),
                           n_steps: int = 50, from_index: int = 999, to_index: int = 0,
                           eta: float = 0.0, n_resample: int = 0) -> Tuple[int, ...]:
        """The shape of `export_sample`'s `noise` argument: (draws, batch,
        C, H/8, W/8), draws 0 when the sampler draws nothing. Draw it with
        `predictions.base.draw_noise(generator, shape)` from the generator
        `sample_loop` would use to get the same numbers."""
        down = self.vae_config.downscale
        pairs = self.schedule_indices(n_steps, from_index=from_index, to_index=to_index)
        return (self._step_draws(len(pairs), eta, n_resample), batch,
                self.vae_config.latent_channels, size[0] // down, size[1] // down)

    def export_sample(
        self,
        batch: int = 1,
        size: Tuple[int, int] = (512, 512),
        n_steps: int = 50,
        from_index: int = 999,
        to_index: int = 0,
        eta: float = 0.0,
        n_resample: int = 0,
        cache_interval: int = 1,
        platforms=None,
        method: str = "ddim",
    ) -> bytes:
        """The text-to-image program, CFG sampling and the VAE decode as one
        function, serialized by `utils.serving` (a `torch.export` archive).

        Its signature is `(params, context2, diffused_latents, noise,
        guidance_scale) -> images`: `params` is `self.params`, `context2`
        the uncond and cond text-encoder states stacked, (2 batch, 77,
        width) (the conditioning program or `conditioning` gives them),
        `diffused_latents` (batch, C, H/8, W/8), `noise` the step noise of
        `sample_noise_shape` (empty for DDIM at eta 0 and dpm++), and
        `guidance_scale` a 0-d fp32 tensor. The schedule is baked in, and
        `eta`, `n_resample`, `cache_interval` and `method` are static, as in
        the JAX package. The step loop is unrolled into the graph, so the
        artifact grows with `n_steps`. Load it with
        `utils.serving.load_program`."""
        self._refuse_xl("export_sample")
        self._check_size(size)
        self._check_method(method, eta, n_resample, cache_interval)
        pairs = self.schedule_indices(n_steps, from_index=from_index, to_index=to_index)
        stochastic = self._step_draws(len(pairs), eta, n_resample) > 0

        @torch.no_grad()
        def run(context2, latents, noise, guidance_scale):
            stream = prediction_base.NoiseStream(noise) if stochastic else None
            out = self.sample_loop(
                latents, pairs, context2[:batch], context2[batch:], guidance_scale, eta=eta,
                generator=stream, n_resample=n_resample, method=method,
                cache_interval=cache_interval,
            )
            return self.decode(out)

        def serve(params, context2, latents, noise, guidance_scale):
            return serving.functional(self.serving_modules(), params, run, context2, latents, noise,
                                      guidance_scale)

        shape = self.sample_noise_shape(batch, size, n_steps, from_index, to_index, eta,
                                        n_resample)
        example = (
            self.params,
            torch.zeros((2 * batch, self.text_config.context_length,
                         self.unet_config.context_dim), device=self.device),
            torch.zeros(shape[1:], device=self.device),
            torch.zeros(shape, device=self.device),
            torch.tensor(7.0, device=self.device),
        )
        return serving.serialize_program(serve, *example, platforms=platforms)

    def export_conditioning(self, batch: int = 1, platforms=None) -> bytes:
        """The text-conditioning program `(params, tokens) -> encoder
        states` for 2 batch prompts (the uncond and cond stack that
        `export_sample` takes), serialized like it. Tokenize on the host
        with `models.clip.tokenizer.tokenize`."""
        self._refuse_xl("export_conditioning")

        def serve(params, tokens):
            return serving.functional(self.serving_modules(), params, self.text_encoder, tokens)

        example = (self.params, torch.zeros((2 * batch, self.text_config.context_length),
                                            dtype=torch.long, device=self.device))
        return serving.serialize_program(serve, *example, platforms=platforms)

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules whose tensors `params` lists, by the same names."""
        return {part: getattr(self, part) for part in self.parts}

    @torch.no_grad()
    def sample_iter(
        self,
        texts: Sequence[str],
        negative_texts: Optional[Sequence[str]] = None,
        n_steps: int = 50,
        guidance_scale: float = 7.0,
        size: Tuple[int, int] = (512, 512),
        generator: Optional[torch.Generator] = None,
    ):
        """Generator yielding the CFG predictions of each DDIM step, for
        callbacks and previews; `sample()` gives the images."""
        generator, uncond, cond, pairs, latents, _ = self._setup(
            texts, negative_texts, n_steps, size, generator
        )
        for _, predictions in self._steps(
            latents, pairs, uncond, cond, guidance_scale, 0.0, generator, 0, "ddim"
        ):
            yield predictions
