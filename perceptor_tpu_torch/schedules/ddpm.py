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
