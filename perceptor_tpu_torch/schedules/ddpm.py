"""Discrete DDPM beta schedules -> cumulative alpha/sigma tables
(counterpart of perceptor_tpu/schedules/ddpm.py). Host-side numpy."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def scaled_linear_alphas_sigmas(
    n_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable-diffusion schedule: betas linear in sqrt space."""
    betas = (
        np.linspace(beta_start**0.5, beta_end**0.5, n_timesteps, dtype=np.float64)
        ** 2
    )
    alphas_cumprod = np.cumprod(1.0 - betas)
    return (
        np.sqrt(alphas_cumprod).astype(np.float32),
        np.sqrt(1.0 - alphas_cumprod).astype(np.float32),
    )


def linear_alphas_sigmas(
    n_timesteps: int = 1000,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
) -> Tuple[np.ndarray, np.ndarray]:
    """OpenAI ADM linear schedule, scaled to the 1000-step convention."""
    scale = 1000 / n_timesteps
    betas = np.linspace(
        scale * beta_start, scale * beta_end, n_timesteps, dtype=np.float64
    )
    alphas_cumprod = np.cumprod(1.0 - betas)
    return (
        np.sqrt(alphas_cumprod).astype(np.float32),
        np.sqrt(1.0 - alphas_cumprod).astype(np.float32),
    )
