"""The port's `engine.guided_sample` against the JAX package's at TINY size,
fp32 on the CPU, on shared weights (the JAX tiny model's param tree re-drawn
from a seeded numpy rng, carried across with `convert`): without CFG, with
CFG (the loss gradient must flow through both UNet evaluations), and with
`correction` plus `threshold="static"`. Parity runs use `clamp_value=1.0`:
the default 1e-6 turns the gradient into ~sign(grad), which is chaotic near
zero, so it is only checked for finiteness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.engine import guided_sample as j_guided_sample
from perceptor_tpu.models.clip.tokenizer import SimpleTokenizer
from perceptor_tpu.models.stable_diffusion import StableDiffusion as JStableDiffusion
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu_torch import convert
from perceptor_tpu_torch.engine import guided_sample
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

torch.set_num_threads(2)

# relative L2 over the final latents and over the per-step losses: fp32 on
# both sides, through the UNet, the VAE decode and their gradients
RTOL = 1e-4
# guidance must move the latents far more than RTOL, or parity would not
# show that the gradient is right
MIN_GUIDANCE_EFFECT = 1e-2
WEIGHTS = (1.0, 0.5)


def _fill_params(params, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(leaf)
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(out.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.fixture(scope="module")
def setup():
    jsd = JStableDiffusion("tiny", fp16=False, tokenizer=SimpleTokenizer(merges=[]))
    jsd.params = _fill_params(jsd.params, seed=1)
    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    sd.load_state_dicts(convert.stable_diffusion_state_dicts_from_jax(
        jsd.params, jsd_config.TINY_UNET, jsd_config.TINY_VAE, jsd_config.TINY_TEXT))
    cfg = jsd_config.TINY_TEXT
    rng = np.random.default_rng(50)
    inputs = {
        "latents": rng.standard_normal((1, 4, 8, 8)).astype(np.float32),
        "cond": rng.standard_normal((1, cfg.context_length, cfg.width)).astype(np.float32),
        "uncond": rng.standard_normal((1, cfg.context_length, cfg.width)).astype(np.float32),
        "target": rng.uniform(size=(1, 3, 16, 16)).astype(np.float32),
        "pairs": sd.schedule_indices(3, from_index=700),
    }
    return jsd, sd, inputs


def _losses(target):
    """A summed squared distance to a target image and the mean brightness."""
    return [lambda images: ((images - target) ** 2).sum(), lambda images: images.mean()]


CASES = {
    "plain": {},
    "cfg": {"cfg": True},
    "correction_static": {"correction": True, "threshold": "static"},
}


def _run_both(setup, guidance_scale=40.0, cfg=False, **options):
    jsd, sd, x = setup
    kwargs = dict(guidance_scale=guidance_scale, loss_weights=WEIGHTS, clamp_value=1.0,
                  cfg_scale=3.0, **options)
    j_latents, j_history = j_guided_sample(
        jsd, _losses(jnp.asarray(x["target"])), jnp.asarray(x["latents"]), x["pairs"],
        conditioning=jnp.asarray(x["cond"]),
        uncond_conditioning=jnp.asarray(x["uncond"]) if cfg else None, **kwargs,
    )
    t_latents, t_history = guided_sample(
        sd, _losses(torch.from_numpy(x["target"])), torch.from_numpy(x["latents"]),
        x["pairs"], conditioning=torch.from_numpy(x["cond"]),
        uncond_conditioning=torch.from_numpy(x["uncond"]) if cfg else None, **kwargs,
    )
    return (np.asarray(j_latents), np.asarray(j_history)), (t_latents, t_history)


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", list(CASES))
def test_guided_sample_matches_jax(setup, case):
    (j_latents, j_history), (t_latents, t_history) = _run_both(setup, **CASES[case])
    assert t_latents.shape == j_latents.shape and t_history.shape == (len(setup[2]["pairs"]),)
    assert _rel_l2(t_latents.numpy(), j_latents) <= RTOL
    assert _rel_l2(t_history.numpy(), j_history) <= RTOL
    # the guidance moved the result well beyond the tolerance
    _, sd, x = setup
    unguided, _ = guided_sample(
        sd, _losses(torch.from_numpy(x["target"])), torch.from_numpy(x["latents"]),
        x["pairs"], conditioning=torch.from_numpy(x["cond"]), guidance_scale=0.0,
        clamp_value=1.0, loss_weights=WEIGHTS,
        uncond_conditioning=torch.from_numpy(x["uncond"]) if CASES[case].get("cfg") else None,
        cfg_scale=3.0, **{k: v for k, v in CASES[case].items() if k != "cfg"},
    )
    assert _rel_l2(unguided.numpy(), t_latents.numpy()) >= MIN_GUIDANCE_EFFECT


def test_cfg_gradient_flows_through_both_unet_evaluations(setup, monkeypatch):
    """With CFG the guided latents depend on the uncond branch's gradient:
    cutting it (a detach on the uncond noise) moves the result away from
    JAX's, far beyond the parity tolerance."""
    (j_latents, _), _ = _run_both(setup, cfg=True)
    _, sd, _ = setup
    predictions = sd.predictions
    calls = []

    def detach_uncond(latents, indices, conditioning):
        out = predictions(latents, indices, conditioning)
        calls.append(conditioning)
        if len(calls) % 2 == 1:  # guided_sample evaluates uncond first
            out = out.replace(predicted_noise=out.predicted_noise.detach())
        return out

    monkeypatch.setattr(sd, "predictions", detach_uncond)
    _, (cut_latents, _) = _run_both(setup, cfg=True)
    assert _rel_l2(cut_latents.numpy(), j_latents) > 100 * RTOL


def test_guided_sample_default_clamp_and_stochastic_options_are_finite(setup):
    _, sd, x = setup
    losses = _losses(torch.from_numpy(x["target"]))
    base = dict(conditioning=torch.from_numpy(x["cond"]),
                uncond_conditioning=torch.from_numpy(x["uncond"]))
    latents, history = guided_sample(sd, losses, torch.from_numpy(x["latents"]), x["pairs"],
                                     **base)
    assert torch.isfinite(latents).all() and torch.isfinite(history).all()

    def run(seed):
        # preview images are at latent resolution: a size-free loss
        return guided_sample(
            sd, [lambda images: (images**2).mean()], torch.from_numpy(x["latents"]),
            x["pairs"], eta=0.5, n_resample=1,
            threshold="dynamic", loss_images="preview", correction=True,
            generator=torch.Generator().manual_seed(seed),
            image_augment=lambda gen, images: images + 0.01 * torch.randn(
                images.shape, generator=gen), **base,
        )

    first = run(0)
    assert all(torch.isfinite(t).all() for t in first)
    assert torch.equal(first[0], run(0)[0]) and not torch.equal(first[0], run(1)[0])


def test_guided_sample_rejects_bad_options(setup):
    _, sd, x = setup
    args = (sd, [lambda images: images.mean()], torch.from_numpy(x["latents"]), x["pairs"])
    cond = torch.from_numpy(x["cond"])
    with pytest.raises(ValueError, match="threshold"):
        guided_sample(*args, conditioning=cond, threshold="median")
    with pytest.raises(ValueError, match="loss_images"):
        guided_sample(*args, conditioning=cond, loss_images="latent")
    with pytest.raises(ValueError, match="generator"):
        guided_sample(*args, conditioning=cond, eta=0.5)
