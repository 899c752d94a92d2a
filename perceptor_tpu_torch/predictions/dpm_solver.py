"""DPM-Solver++(2M), the second-order multistep ODE update (counterpart of
perceptor_tpu/predictions/dpm_solver.py; Lu et al. 2022, arXiv:2211.01095).

One model evaluation per step, like DDIM; the sampler carries the previous
denoised estimate and the previous log-SNR step size between steps.
"""

from __future__ import annotations

import torch


def _lam(alphas, sigmas):
    # clamp away the schedule endpoints (sigma at index 0 can be ~0)
    return torch.log(torch.clamp(alphas, min=1e-12) / torch.clamp(sigmas, min=1e-12))


def dpm_pp_2m_update(
    x,
    denoised,
    prev_denoised,
    prev_h,
    from_alphas,
    from_sigmas,
    to_alphas,
    to_sigmas,
    is_first,
):
    """One DPM-Solver++(2M) update from `from_*` to `to_*` in x-space.

    Schedule arguments broadcast against `x` ((N, 1, 1, 1)). `prev_h` is the
    previous log-SNR step size (ones on the first step: it only enters as
    h / prev_h); `is_first` (a bool or a boolean tensor) selects the
    first-order update. Returns (x_next, h): carry `h` as the next step's
    `prev_h` and `denoised` as its `prev_denoised`."""
    h = _lam(to_alphas, to_sigmas) - _lam(from_alphas, from_sigmas)
    coeff = h / (2 * prev_h)  # = 1/(2r) with r = prev_h / h
    d = torch.where(
        torch.as_tensor(is_first, device=x.device),
        denoised,
        (1 + coeff) * denoised - coeff * prev_denoised,
    )
    x_next = (to_sigmas / from_sigmas) * x - to_alphas * torch.expm1(-h) * d
    return x_next, h
