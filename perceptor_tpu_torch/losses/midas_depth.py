"""MidasDepth loss, depth-consistency guidance (counterpart of
perceptor_tpu/losses/midas_depth.py).

MiDaS depth is affine-ambiguous, so the predicted and the target depth are
each aligned per image, the median subtracted and the mean absolute
deviation divided out, before a mean squared error. The target comes from
images (their depth estimated once, without gradient) or is given as
depth. The model is the memoized `models.MidasDepth`, so this loss and a
`models.MidasDepth` of the same arguments share one network.
"""

from __future__ import annotations

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.midas_depth import MidasDepth as MidasDepthModel


def _median(flat: torch.Tensor) -> torch.Tensor:
    """Median of each row, numpy's rule: the mean of the two middle values
    of an even count (`torch.median` returns the lower one)."""
    ordered = flat.sort(dim=1).values
    n = flat.shape[1]
    return 0.5 * (ordered[:, (n - 1) // 2] + ordered[:, n // 2])


def align_depths(depths: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-image median / mean-absolute-deviation alignment, in fp32:
    (N, 1, H, W) -> the same shape, median 0 and mean |d| 1 per image."""
    flat = depths.reshape(depths.shape[0], -1).float()
    median = _median(flat)[:, None]
    dev = (flat - median).abs().mean(dim=1, keepdim=True)
    return ((flat - median) / dev.clamp(min=eps)).reshape(depths.shape)


class MidasDepth(LossInterface):
    def __init__(self, name: str = "dpt_large", **kwargs):
        """`kwargs` are `optimize`, `device` and `seed` of
        `models.MidasDepth`."""
        self.model = MidasDepthModel(name, **kwargs)
        self.target_depths = None

    @torch.no_grad()
    def add_images_(self, images: torch.Tensor) -> "MidasDepth":
        """Estimate the depth of `images` once and use it as the target."""
        return self.add_depths_(self.model(images))

    def add_depths_(self, depths: torch.Tensor) -> "MidasDepth":
        """Use `depths` (N, 1, H, W) as the target; a per-image affine scale
        and shift is ignored (see `align_depths`)."""
        self.target_depths = align_depths(torch.as_tensor(depths).detach())
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Mean squared error between the aligned predicted and target
        depth."""
        if self.target_depths is None:
            raise ValueError("MidasDepth loss has no target; call add_images_ or add_depths_")
        depths = align_depths(self.model(images))
        if depths.shape[-2:] != self.target_depths.shape[-2:]:
            raise ValueError(
                f"target depth {tuple(self.target_depths.shape)} does not match predicted "
                f"{tuple(depths.shape)}; targets must be built at the model's native resolution")
        return torch.mean(torch.square(depths - self.target_depths))
