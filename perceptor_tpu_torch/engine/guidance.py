"""Guided optimization of a drawer and loss-guided diffusion sampling
(counterpart of perceptor_tpu/engine/guidance.py).

Optimization (`make_guidance_step`, `optimize`, `run_on_device`): per step
drawer.synthesize() -> every loss on the same images -> the weighted sum,
plus the drawer's own `loss()` penalty where it has one -> one backward
pass -> one optimizer step. Where the JAX package compiles a step into one
program (and `run_on_device` the whole loop into one `lax.scan`), here the
steps are eager; `run_on_device` keeps its contract, no host read-back
inside the loop and a history that stays on the device, and the JAX
package's tables of compiled programs have no counterpart. Only the
drawer's parameters are trainable: the losses' towers are frozen.

Sampling (`guided_sample`), per schedule step: model predictions at `from_index` -> the images the
losses see -> weighted loss sum -> its gradient with respect to the diffused
latents (`torch.autograd.grad`, back through the decoder and the UNet) ->
`.guided(grad, guidance_scale)` -> optional threshold -> DDIM step. Where
the JAX package compiles the loop into one `lax.scan` program, here it is
an eager Python loop; randomness comes from an explicit `torch.Generator`.

Not ported (ROADMAP queue A): `mesh`/`rules` and `export_guided_sample`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

THRESHOLDS = (None, "dynamic", "static")
LOSS_IMAGES = ("decoded", "preview")
DEFAULT_LR = 0.05

OptimizerOrFactory = Union[torch.optim.Optimizer, Callable[..., torch.optim.Optimizer], None]


def _make_optimizer(optimizer: OptimizerOrFactory, params) -> torch.optim.Optimizer:
    """`optimizer` itself, or the factory's (default Adam, lr 0.05: optax's
    adam(0.05), same betas, eps and bias correction) over `params`."""
    if isinstance(optimizer, torch.optim.Optimizer):
        return optimizer
    if optimizer is None:
        return torch.optim.Adam(params, lr=DEFAULT_LR)
    return optimizer(params)


def _loss_weights(loss_weights, n_losses: int, device) -> torch.Tensor:
    weights = list(loss_weights) if loss_weights is not None else [1.0] * n_losses
    return torch.tensor(weights, dtype=torch.float32, device=device)


def _objective(synthesize, losses, weights, params=None):
    """(weighted total, per-loss values) of a drawer or a plain
    `params -> images` callable, at the drawer's own parameters or at
    `params` given in their place."""
    synth = synthesize.synthesize if hasattr(synthesize, "synthesize") else synthesize
    args = () if params is None else (params,)
    images = synth(*args)
    values = torch.stack([loss(images).float().reshape(()) for loss in losses])
    total = (values * weights).sum()
    penalty = getattr(synthesize, "loss", None)
    if penalty is not None:
        total = total + penalty(*args)
    return total, values


def _optimizer_step(optimizer, synthesize, losses, weights, params=None):
    """One backward pass over the objective and one optimizer step: the
    (total, per-loss values) from before the update, detached."""
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        total, values = _objective(synthesize, losses, weights, params)
        total.backward()
    optimizer.step()
    return total.detach(), values.detach()


def make_guidance_step(
    drawer,
    losses: Sequence[Callable],
    optimizer: OptimizerOrFactory = None,
    loss_weights: Optional[Sequence[float]] = None,
):
    """Returns `step() -> {"loss", "losses"}` (device tensors: the total and
    the per-loss values before the update), which synthesizes, evaluates
    every loss on the same images, takes one backward pass over the weighted
    sum and steps the optimizer. `optimizer` is a `torch.optim.Optimizer`
    over `drawer.parameters()`, a factory `params -> Optimizer`, or None for
    Adam with lr 0.05."""
    params = [p for p in drawer.parameters() if p.requires_grad]
    optimizer = _make_optimizer(optimizer, params)
    weights = _loss_weights(loss_weights, len(losses), params[0].device)

    def step():
        total, values = _optimizer_step(optimizer, drawer, losses, weights)
        return {"loss": total, "losses": values}

    return step


def optimize(
    drawer,
    losses: Sequence[Callable],
    n_steps: int = 100,
    optimizer: OptimizerOrFactory = None,
    loss_weights: Optional[Sequence[float]] = None,
    callback: Optional[Callable] = None,
):
    """Host loop: optimize the drawer's parameters in place. `callback(i,
    params, aux)` runs after each step. Returns (drawer, history of total
    losses as floats); the history is read back once, after the loop."""
    step = make_guidance_step(drawer, losses, optimizer, loss_weights)
    history = []
    for i in range(n_steps):
        aux = step()
        history.append(aux["loss"])
        if callback is not None:
            callback(i, drawer.params, aux)
    return drawer, (torch.stack(history).tolist() if history else [])


def run_on_device(
    synthesize,
    losses: Sequence[Callable],
    params,
    n_steps: int,
    optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
    loss_weights: Optional[Sequence[float]] = None,
):
    """The whole optimization with no host read-back: `synthesize` is a
    drawer or a `params -> images` callable, `params` a tensor or a sequence
    of tensors, left untouched (the drawer's own parameters too: pass the
    result to `replace_`). `optimizer` is a factory `params -> Optimizer`
    (default Adam, lr 0.05); an optimizer instance is bound to other
    tensors and is refused. Returns (final params, per-step total losses as
    a device tensor)."""
    if isinstance(optimizer, torch.optim.Optimizer):
        raise TypeError("run_on_device builds its optimizer: pass a factory params -> Optimizer")
    single = isinstance(params, torch.Tensor)
    leaves = [p.detach().clone().requires_grad_(True) for p in ((params,) if single else params)]
    optimizer = _make_optimizer(optimizer, leaves)
    weights = _loss_weights(loss_weights, len(losses), leaves[0].device)
    params = leaves[0] if single else tuple(leaves)
    history = [
        _optimizer_step(optimizer, synthesize, losses, weights, params)[0] for _ in range(n_steps)
    ]
    final = [p.detach() for p in leaves]
    history = torch.stack(history) if history else torch.zeros(0, device=leaves[0].device)
    return (final[0] if single else tuple(final)), history


def guided_sample(
    model,
    losses: Sequence[Callable],
    initial_latents: torch.Tensor,
    pairs,
    conditioning=None,
    guidance_scale: float = 0.5,
    loss_weights: Optional[Sequence[float]] = None,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    correction: bool = False,
    n_resample: int = 0,
    threshold: Optional[str] = None,
    threshold_quantile: float = 0.95,
    clamp_value: float = 1e-6,
    uncond_conditioning=None,
    cfg_scale: float = 7.0,
    loss_images: str = "decoded",
    image_augment: Optional[Callable] = None,
):
    """Loss-guided DDIM sampling from `initial_latents` over `pairs`, an
    (n_steps, 2) array of (from, to) schedule indices (e.g.
    `model.schedule_indices(...)`). Each loss maps images to a scalar.

    - ``eta``: stochastic DDIM, noise from ``generator``.
    - ``correction``: after stepping, re-evaluate the model at the new
      point (forward only), average the two denoised estimates
      (``predictions.correction``) and re-step.
    - ``n_resample``: RePaint churn, that many guided resample iterations
      per step (noise from ``generator``).
    - ``threshold``: "dynamic" (percentile clamp, ``threshold_quantile``)
      or "static" ([-1, 1]), applied to the guided predictions.
    - ``clamp_value``: the ``guided()`` gradient clamp. The default turns
      the gradient into ~sign(grad), which is chaotic near zero; pass a
      larger value for a magnitude-preserving guidance signal.
    - ``uncond_conditioning``/``cfg_scale``: classifier-free guidance
      composed with the loss guidance: two model evaluations a step
      combined by ``uncond.classifier_free_guidance(cond, cfg_scale)``
      before the loss, so the gradient flows through both.
    - ``loss_images``: "decoded" (the VAE decode of the denoised latents)
      or "preview" (``model.preview_images_fn``, no VAE).
    - ``image_augment``: ``(generator, images) -> images``, applied before
      the losses each step.

    Returns (final diffused latents, per-step total loss tensor)."""
    if threshold not in THRESHOLDS:
        raise ValueError(f"threshold must be None|'dynamic'|'static', got {threshold!r}")
    if loss_images not in LOSS_IMAGES:
        raise ValueError(f"loss_images must be 'decoded'|'preview', got {loss_images!r}")
    if loss_images == "preview" and not hasattr(model, "preview_images_fn"):
        raise ValueError(
            f"{type(model).__name__} has no preview_images_fn; loss_images='preview' "
            "needs a latent model with a cheap differentiable preview decode"
        )
    if (eta > 0.0 or n_resample) and generator is None:
        raise ValueError("eta > 0 and n_resample draw noise: pass generator=")
    device = initial_latents.device
    weights = _loss_weights(loss_weights, len(losses), device)
    pairs = torch.as_tensor(np.asarray(pairs), device=device).long()

    def make_predictions(latents, from_idx):
        if uncond_conditioning is not None:
            pred_u = model.predictions(latents, from_idx, uncond_conditioning)
            pred_c = model.predictions(latents, from_idx, conditioning)
            return pred_u.classifier_free_guidance(pred_c, cfg_scale)
        return model.predictions(latents, from_idx, conditioning)

    def apply_threshold(predictions):
        with torch.no_grad():
            if threshold == "dynamic":
                return predictions.dynamic_threshold(threshold_quantile)
            if threshold == "static":
                return predictions.static_threshold()
        return predictions

    def guided_predictions(latents, from_idx):
        x = latents.detach().requires_grad_(True)
        with torch.enable_grad():
            predictions = make_predictions(x, from_idx)
            if loss_images == "preview":
                images = model.preview_images_fn(predictions.denoised_xs)
            else:
                images = predictions.denoised_images
            if image_augment is not None:
                images = image_augment(generator, images)
            values = torch.stack([loss(images).float().reshape(()) for loss in losses])
            total = (values * weights).sum()
            (grad,) = torch.autograd.grad(total, x)
        predictions = predictions.replace(
            from_diffused_latents=latents.detach(),
            predicted_noise=predictions.predicted_noise.detach(),
        )
        guided = predictions.guided(grad, guidance_scale, clamp_value=clamp_value)
        return apply_threshold(guided), total.detach()

    latents = initial_latents.detach()
    history = []
    for i in range(pairs.shape[0]):
        from_idx, to_idx = pairs[i, 0:1], pairs[i, 1:2]
        for _ in range(n_resample):  # RePaint churn, guided each iteration
            guided, _ = guided_predictions(latents, from_idx)
            latents = guided.resample(to_idx, generator)
        guided, value = guided_predictions(latents, from_idx)
        with torch.no_grad():
            stepped = guided.step(to_idx, eta, generator)
            if correction:
                corrected = apply_threshold(make_predictions(stepped, to_idx).correction(guided))
                stepped = corrected.step(to_idx, eta, generator)
        latents = stepped
        history.append(value)
    return latents, torch.stack(history) if history else torch.zeros(0, device=device)
