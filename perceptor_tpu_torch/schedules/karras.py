"""Karras rho-spaced schedules snapped to the discrete DDPM grid (counterpart
of perceptor_tpu/schedules/karras.py `karras_sigma_ramp` and
`indexed_schedule`). Host-side numpy: the sampler loops over the pairs."""

from __future__ import annotations

import numpy as np


def karras_sigma_ramp(
    sigma_max: float, sigma_min: float, n_steps: int, rho: float = 7.0
) -> np.ndarray:
    """sigma_i = (max^(1/rho) + i/(n-1)*(min^(1/rho)-max^(1/rho)))^rho, n_steps+1 values."""
    ramp = np.linspace(0, 1, n_steps + 1)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def indexed_schedule(
    schedule_alphas: np.ndarray,
    schedule_sigmas: np.ndarray,
    n_steps: int = 500,
    from_index: int = 999,
    to_index: int = 0,
    rho: float = 3.0,
    strict: bool = True,
) -> np.ndarray:
    """(k, 2) int array of (from_index, to_index) pairs snapped to the grid.

    A Karras rho ramp in elucidated sigma space between the endpoint
    indices' log-SNRs; each target log-SNR snaps to the nearest index of the
    discrete schedule; the indices are deduplicated, sorted descending and
    paired consecutively. `strict` refuses a schedule that lost more than a
    tenth of its steps to deduplication."""
    if from_index < to_index:
        raise ValueError("from_index must be greater than to_index")

    schedule_alphas = np.asarray(schedule_alphas, dtype=np.float64)
    schedule_sigmas = np.asarray(schedule_sigmas, dtype=np.float64)

    from_log_snr = np.log(
        schedule_alphas[from_index] ** 2 / schedule_sigmas[from_index] ** 2
    )
    to_log_snr = np.log(schedule_alphas[to_index] ** 2 / schedule_sigmas[to_index] ** 2)

    elucidated_from_sigma = min(np.sqrt(1 / np.exp(from_log_snr)), 150.0)
    elucidated_to_sigma = max(np.sqrt(1 / np.exp(to_log_snr)), 1e-3)

    sigmas = karras_sigma_ramp(elucidated_from_sigma, elucidated_to_sigma, n_steps, rho)
    target_log_snr = np.log(1.0 / sigmas**2)

    schedule_log_snr = np.log(schedule_alphas**2 / schedule_sigmas**2)

    indices = np.abs(
        target_log_snr[:, None] - schedule_log_snr[None, :]
    ).argmin(axis=1)
    indices = np.unique(indices)[::-1]

    if strict and len(indices) <= n_steps * 0.9:
        raise ValueError(
            f"Scheduled steps {len(indices)} is too far from wanted "
            f"number of steps {n_steps}"
        )
    assert (indices[:-1] != indices[1:]).all()
    return np.stack([indices[:-1], indices[1:]], axis=1).astype(np.int32)
