"""The diffusion arithmetic of the reference: Stable Diffusion's DDPM
schedule, the rho-spaced DDIM index schedule, classifier-free guidance,
the eps DDIM update, the guided shift and the antialiased resize to a CLIP
tower's input, in float64 where it runs on the host and float32 (or the
given dtype) on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def scaled_linear_schedule(cfg: dict):
    """(alphas, sigmas) float32 arrays of the `scaled_linear` DDPM betas:
    alpha_t = sqrt(prod(1 - beta)), sigma_t = sqrt(1 - alpha_t^2)."""
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                        cfg["num_train_timesteps"], dtype=np.float64) ** 2
    cumprod = np.cumprod(1.0 - betas)
    return np.sqrt(cumprod).astype(np.float32), np.sqrt(1.0 - cumprod).astype(np.float32)


def rho_index_pairs(alphas, sigmas, n_steps: int, rho: float, start: int = None, end: int = 0):
    """(from, to) index pairs: a rho-spaced ramp of n_steps + 1 noise levels
    sigma/alpha between the schedule's ends (clipped to [1e-3, 150]), each
    level snapped to the index of nearest log-SNR, repeats dropped."""
    a, s = np.asarray(alphas, np.float64), np.asarray(sigmas, np.float64)
    start = len(a) - 1 if start is None else start
    hi = min(s[start] / a[start], 150.0)
    lo = max(s[end] / a[end], 1e-3)
    ramp = np.linspace(0.0, 1.0, n_steps + 1)
    levels = (hi ** (1 / rho) + ramp * (lo ** (1 / rho) - hi ** (1 / rho))) ** rho
    log_snr = np.log(a ** 2 / s ** 2)
    idx = np.abs(np.log(1.0 / levels ** 2)[:, None] - log_snr[None]).argmin(axis=1)
    idx = np.unique(idx)[::-1]
    return np.stack([idx[:-1], idx[1:]], axis=1)


def ddim_step(x, eps, a_from, s_from, a_to, s_to):
    """The eta-0 DDIM update of eps predictions: x0 = (x - s eps) / a, then
    x0 a' + eps s'."""
    return (x - s_from * eps) / a_from * a_to + eps * s_to


def cfg_eps(uncond, cond, scale: float):
    return uncond + (cond - uncond) * scale


def guided_eps(eps, grad, sigma, scale: float, clamp: float):
    """eps + scale sigma clamp(grad, -c, c) / c."""
    return eps + scale * sigma * torch.clamp(grad, -clamp, clamp) / clamp


def _lanczos3(x):
    eps = float(np.finfo(np.float32).eps)
    return ((np.sin(np.pi * x) * np.sin(np.pi * x / 3) + eps)
            / (np.pi ** 2 * x ** 2 / 3 + eps)) * (np.abs(x) < 3)


def _cubic(x):
    a = np.abs(x)
    return ((1.5 * a ** 3 - 2.5 * a ** 2 + 1) * (a <= 1)
            + (-0.5 * a ** 3 + 2.5 * a ** 2 - 4 * a + 2) * ((a > 1) & (a <= 2)))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased resize weights with centered pixel grids
    (ResizeRight's): Lanczos-3 to shrink, Keys cubic (a = -0.5) to grow;
    when shrinking, the kernel stretched by n_in / n_out. Each row is
    normalised over its taps, then taps outside the image are dropped
    (zero padding)."""
    scale = n_out / n_in
    kernel, support = (_lanczos3, 6.0) if n_out <= n_in else (_cubic, 4.0)
    stretch = min(scale, 1.0)
    support = support / stretch
    eps = float(np.finfo(np.float32).eps)
    centers = np.arange(n_out) / scale + (n_in - 1) / 2 - (n_out - 1) / (2 * scale)
    first = np.ceil(centers - support / 2 - eps).astype(np.int64)
    taps = first[:, None] + np.arange(int(math.ceil(support - eps)))[None]
    w = stretch * kernel(stretch * (centers[:, None] - taps))
    total = w.sum(axis=1, keepdims=True)
    w = w / np.where(total == 0, 1.0, total)
    matrix = np.zeros((n_out, n_in))
    for row in range(n_out):
        inside = (taps[row] >= 0) & (taps[row] < n_in)
        np.add.at(matrix[row], taps[row][inside], w[row][inside])
    return matrix


def clip_input(images: torch.Tensor, size: int) -> torch.Tensor:
    """Images (N, 3, H, W) in [0, 1] -> the tower's normalised (N, 3, size,
    size) input."""
    h, w = images.shape[-2:]
    rows = torch.as_tensor(resize_matrix(h, size), dtype=images.dtype, device=images.device)
    cols = torch.as_tensor(resize_matrix(w, size), dtype=images.dtype, device=images.device)
    out = torch.matmul(torch.matmul(rows, images), cols.T)
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device).reshape(1, 3, 1, 1)
    return (out - mean) / std


def spherical_loss(encodings: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of 2 arcsin(|a - b| / 2)^2 between unit
    encodings and the unit target."""
    a = encodings / torch.clamp(torch.linalg.norm(encodings, dim=-1, keepdim=True), min=1e-12)
    distance = torch.linalg.norm(a[:, None] - target[None], dim=-1)
    return (2 * torch.arcsin(torch.clamp(distance / 2, 0.0, 1.0)) ** 2).mean()
