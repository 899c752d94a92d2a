"""Loss-guided diffusion sampling (counterpart of
perceptor_tpu/engine/guidance.py `guided_sample` and `_build_guided_run`).

Per schedule step: model predictions at `from_index` -> the images the
losses see -> weighted loss sum -> its gradient with respect to the diffused
latents (`torch.autograd.grad`, back through the decoder and the UNet) ->
`.guided(grad, guidance_scale)` -> optional threshold -> DDIM step. Where
the JAX package compiles the loop into one `lax.scan` program, here it is
an eager Python loop; randomness comes from an explicit `torch.Generator`.

Not ported (ROADMAP queue A): `mesh`/`rules`, `export_guided_sample`, and
the drawer loops `optimize`, `make_guidance_step` and `run_on_device`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

THRESHOLDS = (None, "dynamic", "static")
LOSS_IMAGES = ("decoded", "preview")


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
    weights = torch.tensor(
        list(loss_weights) if loss_weights is not None else [1.0] * len(losses),
        dtype=torch.float32, device=device,
    )
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
