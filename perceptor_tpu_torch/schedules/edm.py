"""EDM (Karras et al. 2022) sigma-space schedule and preconditioning
(counterpart of perceptor_tpu/schedules/edm.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EDM:
    """The EDM constants MonsterDiffusion was trained and samples with."""

    P_mean: float = -1.2
    P_std: float = 1.2
    sigma_data: float = 0.5
    rho: float = 7.0
    sigma_min: float = 1e-2
    sigma_max: float = 80.0
    S_tmin: float = 0.05
    S_tmax: float = 50.0
    S_churn: float = 80.0
    S_noise: float = 1.003


def edm_sigmas(n_steps: int, config: EDM = EDM()) -> np.ndarray:
    """The n_steps-point rho-ramp from sigma_max down to sigma_min, fp32."""
    ramp = np.linspace(0, 1, n_steps)
    min_inv_rho = config.sigma_min ** (1 / config.rho)
    max_inv_rho = config.sigma_max ** (1 / config.rho)
    return ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** config.rho).astype(np.float32)


def edm_schedule_ts(n_steps: int, config: EDM = EDM()) -> np.ndarray:
    """(n_steps - 1, 2) consecutive (from_sigma, to_sigma) pairs of the ramp."""
    sigmas = edm_sigmas(n_steps, config)
    return np.stack([sigmas[:-1], sigmas[1:]], axis=1)


def edm_preconditioning(sigma, config: EDM = EDM()):
    """(c_skip, c_out, c_in, c_noise) of EDM's table 1:
    sigma_data^2 / (sigma^2 + sigma_data^2), sigma sigma_data / sqrt(.),
    1 / sqrt(.), log(sigma) / 4."""
    sigma = torch.as_tensor(sigma)
    sd2 = config.sigma_data**2
    var = torch.square(sigma) + sd2
    c_skip = sd2 / var
    c_out = sigma * config.sigma_data / torch.sqrt(var)
    c_in = 1.0 / torch.sqrt(var)
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise
