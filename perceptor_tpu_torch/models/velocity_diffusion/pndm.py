"""PNDM samplers: pseudo Runge-Kutta and pseudo linear multistep (counterpart
of perceptor_tpu/models/velocity_diffusion/pndm.py; the PNDM paper,
openreview PlKWVd2yBkY). Where JAX fuses each sampler into `lax.scan`
programs, these are eager loops: a 50-step PLMS sample makes 3 x 4 + 47
model evaluations.

All math lives in diffusion space (x in [-1, 1]); `eps_fn(xs, ts)` is the
noise-prediction model (for velocity models eps = x sigma(t) + v alpha(t)).
"""

from __future__ import annotations

from typing import Callable

import torch

from perceptor_tpu_torch.schedules.cosine import t_to_alpha_sigma

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _broadcast(values, x):
    return values.reshape(values.shape + (1,) * (x.ndim - values.ndim))


def transfer(x, eps, t_1, t_2):
    """Move x from t_1 to t_2 along the deterministic (eta = 0) DDIM flow
    implied by the noise estimate: (x at t_2, the denoised prediction)."""
    alphas, sigmas = t_to_alpha_sigma(t_1)
    next_alphas, next_sigmas = t_to_alpha_sigma(t_2)
    pred = (x - eps * _broadcast(sigmas, x)) / _broadcast(alphas, x)
    x = pred * _broadcast(next_alphas, x) + eps * _broadcast(next_sigmas, x)
    return x, pred


def prk_step(eps_fn: EpsFn, x, t_1, t_2):
    """One pseudo Runge-Kutta step: 4 model evaluations, midpoint
    weighting. Returns (x at t_2, eps', the denoised prediction)."""
    t_mid = (t_2 + t_1) / 2
    eps_1 = eps_fn(x, t_1)
    x_1, _ = transfer(x, eps_1, t_1, t_mid)
    eps_2 = eps_fn(x_1, t_mid)
    x_2, _ = transfer(x, eps_2, t_1, t_mid)
    eps_3 = eps_fn(x_2, t_mid)
    x_3, _ = transfer(x, eps_3, t_1, t_2)
    eps_4 = eps_fn(x_3, t_2)
    eps_prime = (eps_1 + 2 * eps_2 + 2 * eps_3 + eps_4) / 6
    x_new, pred = transfer(x, eps_prime, t_1, t_2)
    return x_new, eps_prime, pred


def plms_step(eps_fn: EpsFn, x, old_eps, t_1, t_2):
    """One pseudo linear-multistep (Adams-Bashforth 4) step: 1 model
    evaluation against a 3-deep eps history, `old_eps` = (e[-3], e[-2],
    e[-1]) oldest first. Returns (x at t_2, eps, the denoised prediction)."""
    eps = eps_fn(x, t_1)
    eps_prime = (55 * eps - 59 * old_eps[2] + 37 * old_eps[1] - 9 * old_eps[0]) / 24
    x_new, pred = transfer(x, eps_prime, t_1, t_2)
    return x_new, eps, pred


def _ts(ts, x) -> torch.Tensor:
    return torch.as_tensor(ts, dtype=torch.float32, device=x.device)


def prk_sample(eps_fn: EpsFn, x, ts):
    """PRK sampler over the (n + 1,) time sequence `ts` (descending for
    sampling, with the trailing 0 appended by the caller). Returns
    (x_final, pred_final)."""
    ts = _ts(ts, x)
    n = x.shape[0]
    pred = torch.zeros_like(x)
    for i in range(ts.shape[0] - 1):
        x, _, pred = prk_step(eps_fn, x, ts[i].expand(n), ts[i + 1].expand(n))
    return x, pred


def plms_sample(eps_fn: EpsFn, x, ts):
    """PLMS sampler: 3 PRK warm-up steps, then multistep updates carrying
    the eps history. Returns (x_final, pred_final)."""
    ts = _ts(ts, x)
    n = x.shape[0]
    n_steps = ts.shape[0] - 1
    history = []
    pred = torch.zeros_like(x)
    for i in range(n_steps):
        t_1, t_2 = ts[i].expand(n), ts[i + 1].expand(n)
        if i < 3:
            x, eps, pred = prk_step(eps_fn, x, t_1, t_2)
        else:
            x, eps, pred = plms_step(eps_fn, x, history, t_1, t_2)
        history = (history + [eps])[-3:]
    return x, pred


def ddim_reverse_sample(eps_fn: EpsFn, x, ts):
    """DDIM inversion: the latent that deterministic (eta = 0) sampling
    would decode into the given image. `ts` ascends from near 0 toward 1;
    returns the diffused x at ts[-1]."""
    ts = _ts(ts, x)
    n = x.shape[0]
    for i in range(ts.shape[0] - 1):
        t_1, t_2 = ts[i].expand(n), ts[i + 1].expand(n)
        x, _ = transfer(x, eps_fn(x, t_1), t_1, t_2)
    return x
