"""LDM Face, CompVis celebahq-ldm-vq-4, unconditional (counterpart of
perceptor_tpu/models/latent_diffusion/face.py).

An ADM UNet (`FACE_UNET`, 32-channel heads) over 3-channel f4 latents of the
VQ first stage; the published model makes 256x256 images only. The index
API and the sampler are Text2Image's without conditioning.

Weights are seeded random at the published widths (no checkpoint in the
tree), stored in bf16 for matmuls and convolutions when `fp16` (the VQ
codebook stays fp32); `load_state_dicts` takes port-named state_dicts
(`convert.vq_diffusion_state_dicts_from_jax`; an original CompVis
checkpoint's `model.diffusion_model.*` keys are the UNet's names, and
`first_stage.convert_compvis_autoencoder` maps its `first_stage_model.*`);
the constructor loads the checkpoint that `utils.checkpoints.find_checkpoint`
finds. `sample(mesh=, rules=)` samples with the weights placed on a DeviceMesh by
the tensor-parallel rules (`parallel.partition.sampling`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.guided_diffusion.config import ADMConfig
from perceptor_tpu_torch.models.guided_diffusion.unet import ADMUNet
from perceptor_tpu_torch.models.latent_diffusion import first_stage
from perceptor_tpu_torch.models.latent_diffusion.ddim import LatentDiffusionSchedule, check_method
from perceptor_tpu_torch.predictions import diffusion_space
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found, strip_prefix

# celebahq-ldm-vq-4.yaml model.params schedule
TIMESTEPS = 1000
LINEAR_START = 0.0015
LINEAR_END = 0.0195

FACE_UNET = ADMConfig(
    image_size=64,
    model_channels=224,
    channel_mult=(1, 2, 3, 4),
    num_res_blocks=2,
    attention_ds=(2, 4, 8),
    num_head_channels=32,
    in_channels=3,
    out_channels=3,
)

TINY_FACE_UNET = ADMConfig(
    image_size=8,
    model_channels=16,
    channel_mult=(1, 2),
    num_res_blocks=1,
    attention_ds=(2,),
    num_head_channels=8,
    in_channels=3,
    out_channels=3,
)


class VQLatentDiffusion(LatentDiffusionSchedule):
    """What Face and SuperResolution share: an ADM UNet and a VQ first
    stage, built random from `seed` on the device."""

    def _build(self, unet_config, vq_config, fp16, device, seed) -> None:
        self.device = resolve_device(device)
        self.unet_config, self.vq_config = unet_config, vq_config
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dtype = COMPUTE_DTYPE if fp16 else torch.float32
        self.unet = random_module(ADMUNet, unet_config, self.device, gen, dtype)
        self.first_stage = random_module(first_stage.VQModel, vq_config, self.device, gen,
                                         torch.float32)
        if fp16:
            first_stage.cast_bf16_(self.first_stage)

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Load {"unet", "first_stage"} state_dicts (each module keeps its
        own storage dtypes)."""
        for key in ("unet", "first_stage"):
            getattr(self, key).load_state_dict(state_dicts[key])

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules a checkpoint fills, by name."""
        return {"unet": self.unet, "first_stage": self.first_stage}

    def _discover(self, *names: str) -> None:
        """Load the checkpoint `find_checkpoint(*names)` finds, if any
        (`utils.checkpoints.load_found`; a CompVis file: the UNet under
        `model.diffusion_model.`, the VQ stage through the first-stage key
        map)."""
        path = find_checkpoint(*names)
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self._load_upstream)

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import vq_diffusion_state_dicts_from_jax

        return vq_diffusion_state_dicts_from_jax(params, self.unet_config, self.vq_config)

    def _load_upstream(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        self.load_state_dicts({
            "unet": strip_prefix(state_dict, "model.diffusion_model."),
            "first_stage": first_stage.convert_compvis_autoencoder(state_dict, self.vq_config),
        })

    def latents(self, images) -> torch.Tensor:
        """images [0, 1] -> continuous VQ latents."""
        return self.first_stage.encode(diffusion_space.encode(images))

    def images(self, latents) -> torch.Tensor:
        """Latents -> images [0, 1] through the quantizing decode."""
        return diffusion_space.decode(self.first_stage.decode(latents))

    def _unet_eps(self, xs, index):
        return self.unet(xs, torch.full((xs.shape[0],), float(index), device=xs.device))


class Face(VQLatentDiffusion):
    def __init__(self, eta: float = 0.0, fp16: bool = True, tiny: bool = False, device="cuda",
                 seed: int = 0):
        """`tiny` picks the test widths; `fp16` stores matmul/conv weights
        in bf16; weights come from the checkpoint that
        `find_checkpoint("latent_diffusion_face", "celebahq-ldm-vq-4")` finds,
        else they are random from `seed`; `device` is CUDA unless the caller
        passes "cpu"."""
        self.eta = eta
        self._build(TINY_FACE_UNET if tiny else FACE_UNET,
                    first_stage.TINY_VQ if tiny else first_stage.VQ_F4, fp16, device, seed)
        self._discover("latent_diffusion_face", "celebahq-ldm-vq-4")
        self._set_schedule(LINEAR_START, LINEAR_END)

    def latent_shape(self, height, width):
        down = self.vq_config.downscale
        return [self.vq_config.latent_channels, height // down, width // down]

    def _check_size(self, height, width) -> None:
        if self.unet_config == FACE_UNET and (height, width) != (256, 256):
            raise ValueError("celebahq face model generates 256x256 images")

    def random_latents(self, images_shape, generator: torch.Generator) -> torch.Tensor:
        self._check_size(*images_shape[-2:])
        return torch.randn((images_shape[0], *self.latent_shape(*images_shape[-2:])),
                           generator=generator, device=self.device)

    def eps(self, latents, index):
        if index >= 1000:
            raise ValueError("index must be less than 1000")
        return self._unet_eps(latents, index)

    def denoise(self, latents, index, eps=None):
        if eps is None:
            eps = self.eps(latents, index)
        return self._denoised(latents, index, eps)

    forward = denoise

    @torch.no_grad()
    def sample(self, n_images: int = 1, n_steps: int = 50, size=(256, 256),
               eta: Optional[float] = None, generator: Optional[torch.Generator] = None,
               from_index: int = 999, to_index: int = 50, mesh=None, rules=None,
               method: str = "ddim") -> torch.Tensor:
        """Unconditional faces (N, 3, H, W) in [0, 1]: per schedule pair eps
        -> denoise -> DDIM step (or DPM-Solver++(2M), no eta), then the
        final denoise and the VQ decode. `generator` defaults to one seeded
        0 on the model's device. `mesh` / `rules` as in
        `GuidedDiffusion.sample` (`parallel.partition.sampling`)."""
        eta = self.eta if eta is None else eta
        check_method(method, eta)
        generator = self._generator(generator)
        latents = self.random_latents((n_images, 3, *size), generator)
        pairs = self.schedule_indices(from_index, to_index, n_steps)
        if mesh is None:
            return self.sample_loop(latents, pairs, eta, generator, method)
        from perceptor_tpu_torch.parallel.partition import sampling

        with sampling(mesh, self.serving_modules(), latents, rules) as run:
            return run.gather(self.sample_loop(run.latents, pairs, eta, generator, method))

    @torch.no_grad()
    def sample_loop(self, latents, pairs, eta: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    method: str = "ddim") -> torch.Tensor:
        """The sampler from given latents: k schedule pairs are k + 1 UNet
        evaluations and one decode."""
        eta = self.eta if eta is None else eta
        check_method(method, eta)
        return self._sample_loop(latents, pairs, self._unet_eps, self.images, eta, generator,
                                 method)
