"""Continuous-time cosine schedule math of v-diffusion (counterpart of
perceptor_tpu/schedules/cosine.py). Tensor functions, differentiable;
python and numpy numbers are taken as fp32 tensors."""

from __future__ import annotations

import math

import torch


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(value, dtype=torch.float32)


def t_to_alpha_sigma(t):
    """alpha = cos(t pi/2), sigma = sin(t pi/2)."""
    t = _tensor(t)
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


def alpha_sigma_to_t(alpha, sigma):
    return torch.atan2(_tensor(sigma), _tensor(alpha)) / math.pi * 2


def sigma_to_t(sigma):
    return torch.asin(_tensor(sigma)) / math.pi * 2


def log_snr_to_alpha_sigma(log_snr):
    log_snr = _tensor(log_snr)
    return (
        torch.sqrt(1.0 / (1.0 + torch.exp(-log_snr))),
        torch.sqrt(1.0 / (1.0 + torch.exp(log_snr))),
    )


def alpha_sigma_to_log_snr(alpha, sigma):
    return torch.log(torch.square(_tensor(alpha)) / torch.square(_tensor(sigma)))


def get_ddpm_schedule(ddpm_t):
    """Timesteps for the DDPM-paper noise schedule."""
    ddpm_t = _tensor(ddpm_t)
    log_snr = -torch.log(torch.expm1(1e-4 + 10 * torch.square(ddpm_t)))
    return alpha_sigma_to_t(*log_snr_to_alpha_sigma(log_snr))


def get_spliced_ddpm_cosine_schedule(t):
    """Spliced DDPM/cosine schedule."""
    t = _tensor(t)
    ddpm_crossover = 0.48536712
    cosine_crossover = 0.80074257
    big_t = t * (1 + cosine_crossover - ddpm_crossover)
    ddpm_part = get_ddpm_schedule(big_t + ddpm_crossover - cosine_crossover)
    return torch.where(big_t < cosine_crossover, big_t, ddpm_part)


def get_log_schedule(t, min_log_snr=-10, max_log_snr=10):
    """Logarithmically spaced schedule."""
    t = _tensor(t)
    log_snr = t * (min_log_snr - max_log_snr) + max_log_snr
    return alpha_sigma_to_t(*log_snr_to_alpha_sigma(log_snr))
