"""`grid_sample` with torch.nn.functional.grid_sample's semantics, and
`flow_warp` (counterpart of perceptor_tpu/ops/grid_sample.py). The JAX
function reproduces `F.grid_sample` (no Pallas kernel), so `F.grid_sample`
stands for it here, computed in fp32 as JAX computes it and returned in the
input's dtype; autograd differentiates the input and the grid."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(
    input: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """(N, C, H, W), (N, Hg, Wg, 2) normalized (x, y) -> (N, C, Hg, Wg).
    mode "bilinear" | "nearest", padding_mode "zeros" | "border"."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    if grid.shape[-1] != 2 or grid.ndim != 4:
        raise ValueError(f"grid must be (N, Hg, Wg, 2), got {tuple(grid.shape)}")
    out = F.grid_sample(input.float(), grid.float(), mode=mode, padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(input.dtype)


def flow_warp(
    x: torch.Tensor,
    flow: torch.Tensor,
    interpolation: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = True,
) -> torch.Tensor:
    """Warp (N, C, H, W) by a per-pixel flow (N, H, W, 2) in pixels."""
    n, c, h, w = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device),
        indexing="ij",
    )
    vx = gx[None] + flow[..., 0]
    vy = gy[None] + flow[..., 1]
    # to [-1, 1] with the reference's max(size - 1, 1) divisor
    vx = 2.0 * vx / max(w - 1, 1) - 1.0
    vy = 2.0 * vy / max(h - 1, 1) - 1.0
    return grid_sample(x, torch.stack([vx, vy], dim=-1), mode=interpolation,
                       padding_mode=padding_mode, align_corners=align_corners)
