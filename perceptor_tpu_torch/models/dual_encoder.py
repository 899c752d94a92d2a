"""What the CLIP-family wrappers share (SLIP, BLIP, CLOOB, LiT, RuCLIP):
a frozen tower module on a device, loaded from the checkpoint that
`find_checkpoint` finds or built by `core/init.py random_module` from a seed, its matmul weights stored in bf16 unless `precision="fp32"`;
the images' resize and normalization; `load_state_dict`; and the pairwise
squared spherical distance.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found


def _precision_dtype(precision: Optional[str]) -> torch.dtype:
    """bf16 storage for None, "fp16" and "bf16"; fp32 otherwise."""
    return COMPUTE_DTYPE if precision in (None, "fp16", "bf16") else torch.float32


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(seed)


class DualEncoder:
    """What the CLIP-family wrappers share: a frozen `module` on `device`,
    the image normalization, `load_state_dict` and `spherical_distance`."""

    # the family's prefix of checkpoint names and of its `convert` function
    _FAMILY = ""

    def _build(self, module_cls, config, precision, device, seed, mean=None, std=None) -> None:
        """`module_cls(config)` with the weights of the checkpoint that
        `find_checkpoint("<family>_<name>", name)` finds
        (`utils.checkpoints.load_found`; the upstream names through
        `load_state_dict`), else seeded random; `mean` and `std` are what
        `normalize` takes out."""
        self.config = config
        self.device = resolve_device(device)
        self.dtype = _precision_dtype(precision)
        self.module = random_module(module_cls, config, self.device,
                                    _generator(seed, self.device), self.dtype)
        if mean is not None:
            self._mean = torch.as_tensor(mean, device=self.device).reshape(1, 3, 1, 1)
            self._std = torch.as_tensor(std, device=self.device).reshape(1, 3, 1, 1)
        path = find_checkpoint(*self._checkpoint_names())
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self.load_state_dict)

    def _checkpoint_names(self):
        return (f"{self._FAMILY}_{self.name}", self.name)

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules a checkpoint fills, by name."""
        return {"module": self.module}

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch import convert

        to_state_dict = getattr(convert, f"{self._FAMILY}_state_dict_from_jax")
        return {"module": to_state_dict(params, self.config)}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load the checkpoint's names (a "module." prefix is dropped); the
        module keeps its storage dtypes."""
        state_dict = {k.removeprefix("module."): v for k, v in state_dict.items()}
        self.module.load_state_dict(state_dict)
        if self.dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.module)

    def normalize(self, images: torch.Tensor, size) -> torch.Tensor:
        """Resize to `size` (antialiased, differentiable) and normalize."""
        return (resize(images, out_shape=size) - self._mean) / self._std

    @staticmethod
    def spherical_distance(encodings_a, encodings_b) -> torch.Tensor:
        """Pairwise squared spherical distance, (len(a), len(b))."""
        diff_norm = torch.linalg.norm(encodings_a[:, None] - encodings_b[None, :], dim=2)
        return torch.square(torch.arcsin(torch.clamp(diff_norm / 2, 0.0, 1.0))) * 2
