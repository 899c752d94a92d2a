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

`export_guided_sample` traces the sampler into a `torch.export` program
(utils/serving.py); `torch.autograd.grad` stays inside it. `guided_sample`
takes a DeviceMesh (`mesh=`, `rules=`) as JAX's does
(parallel/partition.py `sampling`).
"""

from __future__ import annotations

import math
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
    mesh=None,
    rules=None,
):
    """Loss-guided DDIM sampling from `initial_latents` over `pairs`, an
    (n_steps, 2) array of (from, to) schedule indices (e.g.
    `model.schedule_indices(...)`) or, for a continuous-time model, of fp32
    times (`model.schedule_ts(...)`). `model.predictions(x, from, conditioning)`
    gives the predictions. Each loss maps images to a scalar.

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
      the losses each step; without a ``generator`` it gets one seeded 0 on
      the latents' device.
    - ``mesh``/``rules``: sample with the model's weights and the losses'
      towers placed on a DeviceMesh by the tensor-parallel rules, the
      latent batch sharded over the data axis when it divides, and the
      attention routed by the mesh's context-parallel plan
      (``parallel.partition.sampling``). The augment and the losses see the
      whole batch, gathered from the data ranks.

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
    if (isinstance(eta, torch.Tensor) or eta > 0.0 or n_resample) and generator is None:
        raise ValueError("eta > 0 and n_resample draw noise: pass generator=")
    if mesh is not None:
        return _guided_sample_on_mesh(
            mesh, rules, model, losses, initial_latents, pairs, conditioning=conditioning,
            guidance_scale=guidance_scale, loss_weights=loss_weights, eta=eta,
            generator=generator, correction=correction, n_resample=n_resample,
            threshold=threshold, threshold_quantile=threshold_quantile,
            clamp_value=clamp_value, uncond_conditioning=uncond_conditioning,
            cfg_scale=cfg_scale, loss_images=loss_images, image_augment=image_augment)
    device = initial_latents.device
    if generator is None:  # only the augment draws from it
        generator = torch.Generator(device=device).manual_seed(0)
    weights = _loss_weights(loss_weights, len(losses), device)
    # integer (schedule index) pairs stay integer, float (continuous t) pairs fp32
    pairs = torch.as_tensor(pairs if isinstance(pairs, torch.Tensor) else np.asarray(pairs),
                            device=device)
    pairs = pairs.float() if pairs.is_floating_point() else pairs.long()

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
        predictions = predictions.detached(latents.detach())
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


def _guided_sample_on_mesh(mesh, rules, model, losses, initial_latents, pairs, conditioning,
                           uncond_conditioning, image_augment, **options):
    """`guided_sample` inside `parallel.partition.sampling`: the model's
    modules and each loss's (as `loss<i>.<path>`) placed by the rules."""
    from perceptor_tpu_torch.parallel.partition import sampling
    from perceptor_tpu_torch.utils import serving

    modules = dict(model.serving_modules())
    for i, loss in enumerate(losses):
        for path, module in serving.object_modules(loss).items():
            modules[f"loss{i}.{path}"] = module
    with sampling(mesh, modules, initial_latents, rules) as run:
        if image_augment is not None:
            augment, seen = (lambda gen, images: image_augment(gen, run.gather(images))), losses
        else:
            augment = None
            seen = [lambda images, _loss=loss: _loss(run.gather(images)) for loss in losses]
        latents, history = guided_sample(
            model, seen, run.latents, pairs, conditioning=run.rows(conditioning),
            uncond_conditioning=run.rows(uncond_conditioning), image_augment=augment, **options)
        return run.gather(latents), history


def _augment_uniforms(image_augment) -> int:
    """The uniforms `image_augment` draws per call: the product of its
    `uniform_shape` (0 without an augment)."""
    if image_augment is None:
        return 0
    shape = getattr(image_augment, "uniform_shape", None)
    if shape is None:
        raise NotImplementedError(
            "export_guided_sample: a random image_augment must declare the uniforms it draws "
            "per call (`uniform_shape`, as transforms.RandomCutouts does) to take them from "
            "the noise argument")
    return math.prod(shape)


def _guided_draws(n_steps: int, eta, correction: bool, n_resample: int, image_augment):
    """(normal draws, uniform values) `guided_sample` makes over `n_steps`."""
    normals = n_resample + ((1 + bool(correction)) if float(eta) > 0.0 else 0)
    return n_steps * normals, n_steps * (n_resample + 1) * _augment_uniforms(image_augment)


def guided_noise_shape(example_latents, n_steps: int, eta: float = 0.0, correction: bool = False,
                       n_resample: int = 0, image_augment=None):
    """The shape of `export_guided_sample`'s `noise` argument: (rows,
    *latents' shape). The first rows are the normal draws, one per RePaint
    iteration and, with eta > 0, one per DDIM step and one per correction
    re-step; the rows after them hold the uniforms of `image_augment`
    (its `uniform_shape` per call, one call per guided evaluation), flat
    and zero-padded. Draw it with `draw_guided_noise` from the generator
    `guided_sample` would use to get its numbers."""
    normals, uniforms = _guided_draws(n_steps, eta, correction, n_resample, image_augment)
    per_row = math.prod(example_latents.shape)
    return (normals + -(-uniforms // per_row), *example_latents.shape)


def draw_guided_noise(generator: torch.Generator, example_latents, n_steps: int,
                      eta: float = 0.0, correction: bool = False, n_resample: int = 0,
                      image_augment=None) -> torch.Tensor:
    """The `noise` argument of `guided_noise_shape`, drawn from `generator`
    in `guided_sample`'s order (per step: each RePaint iteration's augment
    uniforms then its normal draw, the step's augment uniforms, then its
    DDIM and correction draws) and in its shapes, so the numbers are the
    eager sampler's."""
    from perceptor_tpu_torch.predictions.base import rand

    shape = guided_noise_shape(example_latents, n_steps, eta, correction, n_resample,
                               image_augment)
    per_call = _augment_uniforms(image_augment)
    stochastic = float(eta) > 0.0
    normals, uniforms = [], []

    def augment():
        if per_call:
            uniforms.append(rand(image_augment.uniform_shape, generator).reshape(-1))

    def normal():
        normals.append(torch.randn(shape[1:], generator=generator, device=generator.device))

    for _ in range(n_steps):
        for _ in range(n_resample):
            augment()
            normal()
        augment()
        if stochastic:
            normal()
            if correction:
                normal()
    out = torch.zeros(shape, device=generator.device)
    if normals:
        out[:len(normals)] = torch.stack(normals)
    if uniforms:
        flat = torch.cat(uniforms)
        out[len(normals):].view(-1)[:flat.shape[0]] = flat
    return out


def export_guided_sample(
    model,
    losses: Sequence[Callable],
    example_latents: torch.Tensor,
    example_pairs,
    conditioning=None,
    loss_weights: Optional[Sequence[float]] = None,
    eta: float = 0.0,
    correction: bool = False,
    n_resample: int = 0,
    threshold: Optional[str] = None,
    threshold_quantile: float = 0.95,
    clamp_value: float = 1e-6,
    uncond_conditioning=None,
    loss_images: str = "decoded",
    image_augment=None,
    platforms=None,
) -> bytes:
    """`guided_sample` as a `torch.export` program (utils/serving.py), as bytes.

    Its signature is `(model_params, latents, pairs, loss_params,
    conditioning, noise, guidance_scale, eta) -> (latents, loss_history)`:
    `model_params` is `model.params`, `loss_params` a list with
    `utils.serving.object_params(loss)` of each loss (its model's modules and
    its prompt bank), `noise` the pre-drawn step noise of
    `guided_noise_shape`, drawn by `draw_guided_noise` (empty when nothing
    is drawn), `guidance_scale` and
    `eta` 0-d fp32 tensors. With `uncond_conditioning` the conditioning slot
    is the (cond, uncond) pair and a ninth argument, `cfg_scale`, follows.
    Static options (correction, threshold, n_resample, whether eta > 0) are
    baked in; the examples fix the shapes and the step count, whose loop is
    unrolled. `torch.autograd.grad` stays inside the program, which
    non-strict export traces; on CUDA the flash forward, dq and dk/dv are
    nodes of its graph. Losses must be loss objects of the port (whose
    tensors the export can reach); a plain callable would bake its state
    into the artifact and is refused. A random `image_augment` takes its
    uniforms from the noise argument and must say how many it draws per
    call (`uniform_shape`, as `transforms.RandomCutouts` does); one that
    does not raises `NotImplementedError`, as does `platforms=("cuda",)`
    on a host without CUDA: the autograd engine of a CPU-only build cannot
    run on fake CUDA tensors."""
    from perceptor_tpu_torch.losses.interface import LossInterface
    from perceptor_tpu_torch.predictions.base import NoiseStream
    from perceptor_tpu_torch.utils import serving

    if any(not isinstance(loss, LossInterface) for loss in losses):
        raise ValueError(
            "export requires loss objects of the port (LossInterface); plain callables would "
            "bake their state into the artifact"
        )
    if threshold not in THRESHOLDS:
        raise ValueError(f"threshold must be None|'dynamic'|'static', got {threshold!r}")
    if platforms is not None and "cuda" in platforms and not torch.cuda.is_available():
        raise NotImplementedError("export_guided_sample for CUDA needs a CUDA build: its "
                                  "autograd cannot be traced on fake CUDA tensors")
    losses = list(losses)
    stochastic = float(eta) > 0.0
    use_cfg = uncond_conditioning is not None
    n_steps = len(example_pairs)
    noise_shape = guided_noise_shape(example_latents, n_steps, eta, correction, n_resample,
                                     image_augment)
    n_normal = _guided_draws(n_steps, eta, correction, n_resample, image_augment)[0]
    modules = model.serving_modules()

    def run(latents, pairs, loss_params, conds, noise, guidance_scale, eta_arg, cfg_scale):
        bound = [_BoundLoss(loss, params) for loss, params in zip(losses, loss_params)]
        cond, uncond = conds if use_cfg else (conds, None)
        return guided_sample(
            model, bound, latents, pairs, conditioning=cond, guidance_scale=guidance_scale,
            loss_weights=loss_weights, eta=eta_arg if stochastic else 0.0,
            generator=NoiseStream(noise[:n_normal], noise[n_normal:].reshape(-1))
            if noise_shape[0] else None, correction=correction,
            n_resample=n_resample, threshold=threshold, threshold_quantile=threshold_quantile,
            clamp_value=clamp_value, uncond_conditioning=uncond,
            cfg_scale=cfg_scale if use_cfg else 7.0, loss_images=loss_images,
            image_augment=image_augment,
        )

    def serve(model_params, latents, pairs, loss_params, conds, noise, guidance_scale, eta_arg,
              cfg_scale=None):
        return serving.functional(modules, model_params, run, latents, pairs, loss_params, conds,
                                  noise, guidance_scale, eta_arg, cfg_scale)

    device = example_latents.device
    example = (
        model.params, example_latents,
        torch.as_tensor(np.asarray(example_pairs), device=device),
        [serving.object_params(loss) for loss in losses],
        (conditioning, uncond_conditioning) if use_cfg else conditioning,
        torch.zeros(noise_shape, device=device),
        torch.tensor(0.5, device=device), torch.tensor(float(eta), device=device),
    )
    if use_cfg:
        example = example + (torch.tensor(7.0, device=device),)
    return serving.serialize_program(serve, *example, platforms=platforms, grad=True)


class _BoundLoss:
    """A loss whose tensors are `params` (see `utils.serving.call_with`)."""

    def __init__(self, loss, params):
        self.loss, self.params = loss, params

    def __call__(self, images):
        from perceptor_tpu_torch.utils import serving

        return serving.call_with(self.loss, self.params, self.loss, images)
