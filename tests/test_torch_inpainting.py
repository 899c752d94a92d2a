"""The port's Stable Diffusion inpainting against the JAX package at TINY
size ("tiny-inpainting": the tiny UNet with a 9-channel input), fp32 on the
CPU: `ops.resize.interpolate_bilinear`, the kornia-style blur, the latent
masks, `Conditioning`, `conditioning()` with masks, a 9-channel
`predictions` call, the CFG sampling loop with `replace_diffused` against
JAX's compiled `_get_sample_run()` program, and one CFG-guided inpainting
step of `engine.guided_sample`. The models share weights: the JAX tiny
model's param tree, every leaf re-drawn from a seeded numpy rng, carried
across with `convert.stable_diffusion_state_dicts_from_jax`. The replace
step's noise is one fixed tensor fed to both sides (JAX PRNG draws cannot be
replayed by a `torch.Generator`); the prompts go through an in-range
stand-in tokenizer (TINY_TEXT has 128 token ids).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import perceptor_tpu.predictions.base as jbase
from perceptor_tpu.engine import guided_sample as j_guided_sample
from perceptor_tpu.models.stable_diffusion import StableDiffusion as JStableDiffusion
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu.models.stable_diffusion import convert as jsd_convert
from perceptor_tpu.models.stable_diffusion.stable_diffusion import Conditioning as JConditioning
from perceptor_tpu.models.stable_diffusion.stable_diffusion import _gaussian_blur as j_blur
from perceptor_tpu.ops.resize import interpolate_bilinear as j_interpolate_bilinear
from perceptor_tpu_torch import convert
from perceptor_tpu_torch.engine import guided_sample
from perceptor_tpu_torch.models.stable_diffusion import Conditioning, StableDiffusion
from perceptor_tpu_torch.models.stable_diffusion.stable_diffusion import _gaussian_blur
from perceptor_tpu_torch.ops.resize import _bilinear_matrices, interpolate_bilinear
from perceptor_tpu_torch.predictions import base as tbase

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# masks, blur and resize: a few fp32 products summed, both sides
OP_ATOL = 1e-5
# fp32 model outputs: max error over max magnitude
MODEL_RTOL = 1e-4
# relative L2 over the final latents of a sampling loop or a guided run
LOOP_RTOL = 1e-4
PROMPTS = ["a photo of a cat", "a dog"]


class InRangeTokenizer:
    """A stand-in tokenizer whose ids fit TINY_TEXT's 128-entry table."""

    sot_token, eot_token = 126, 127

    def encode(self, text):
        return [ord(c) % 126 for c in text]


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
def models():
    # a tokenizer object of its own keys a JAX model instance of its own
    jsd = JStableDiffusion("tiny-inpainting", fp16=False, tokenizer=InRangeTokenizer())
    jsd.params = _fill_params(jsd.params, seed=0)
    sd = StableDiffusion("tiny-inpainting", fp16=False, tokenizer=InRangeTokenizer(),
                         device="cpu")
    sd.load_state_dicts(convert.stable_diffusion_state_dicts_from_jax(
        jsd.params, jsd_config.TINY_INPAINT_UNET, jsd_config.TINY_VAE, jsd_config.TINY_TEXT))
    return jsd, sd


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(seed, n=1, size=16):
    """Images in [0, 1] and a mask: 1 (paint) on the left half, soft
    values near its edge, 0 on the right."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, 3, size, size)).astype(np.float32)
    masks = np.zeros((n, 1, size, size), np.float32)
    masks[..., : size // 2] = 1.0
    masks[..., size // 2 - 1] = 0.7
    masks[..., size // 2] = 0.3
    return images, masks


# -- ops and masks ---------------------------------------------------------------


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("out_shape", [(8, 6), (21, 13), (1, 5)])
def test_interpolate_bilinear_matches_jax_and_torch(align_corners, out_shape):
    x = np.random.default_rng(1).standard_normal((2, 3, 11, 9)).astype(np.float32)
    got = interpolate_bilinear(torch.from_numpy(x), out_shape, align_corners)
    want = j_interpolate_bilinear(jnp.asarray(x), out_shape, align_corners)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=OP_ATOL)
    np.testing.assert_allclose(
        got.numpy(), F.interpolate(torch.from_numpy(x), out_shape, mode="bilinear",
                                   align_corners=align_corners).numpy(), atol=OP_ATOL)
    # the device matrices are built once per key: the second call copies nothing
    hits = _bilinear_matrices.cache_info().hits
    again = interpolate_bilinear(torch.from_numpy(x), out_shape, align_corners)
    assert _bilinear_matrices.cache_info().hits == hits + 1 and torch.equal(again, got)
    assert interpolate_bilinear(torch.from_numpy(x).double(), out_shape,
                                align_corners).dtype == torch.float64


@pytest.mark.parametrize("sigma", [4.0, 2.0, 1.0])
def test_gaussian_blur_matches_jax(sigma):
    x = np.random.default_rng(2).uniform(size=(2, 1, 16, 12)).astype(np.float32)
    got = _gaussian_blur(torch.from_numpy(x), sigma)
    np.testing.assert_allclose(got.numpy(), _np(j_blur(jnp.asarray(x), sigma)), atol=OP_ATOL)
    assert got.shape == x.shape


def test_latent_masks_match_jax(models):
    jsd, sd = models
    _, masks = _inputs(3, n=2)
    for blur in (4.0, 1.0, None, 0):
        np.testing.assert_allclose(sd.latent_masks(masks, blur).numpy(),
                                   _np(jsd.latent_masks(masks, blur)), atol=OP_ATOL)
    assert sd.latent_masks(masks).shape == (2, 1, 8, 8)
    with pytest.raises(ValueError, match="1-channel"):
        sd.latent_masks(np.zeros((1, 2, 16, 16), np.float32))
    with pytest.raises(ValueError, match="between 0 and 1"):
        sd.latent_masks(np.full((1, 1, 16, 16), 1.5, np.float32))
    with pytest.raises(ValueError, match="divisible"):
        sd.latent_masks(np.zeros((1, 1, 15, 16), np.float32))


def test_conditioning_input_and_negation_match_jax():
    rng = np.random.default_rng(4)
    latents = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    encodings = rng.standard_normal((3, 16, 32)).astype(np.float32)
    masks = rng.uniform(size=(1, 1, 8, 8)).astype(np.float32)
    masked = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    j_cond = JConditioning("tiny-inpainting", jnp.asarray(encodings), jnp.asarray(masks),
                           jnp.asarray(masked))
    t = torch.from_numpy
    cond = Conditioning("tiny-inpainting", t(encodings), t(masks), t(masked))
    got = cond.input(t(latents))
    assert got.shape == (3, 9, 8, 8)
    np.testing.assert_array_equal(got.numpy(), _np(j_cond.input(jnp.asarray(latents))))
    negated = -cond
    np.testing.assert_array_equal(negated.encodings.numpy(), _np((-j_cond).encodings))
    assert negated.inpainting_latent_masks is cond.inpainting_latent_masks
    assert negated.inpainting_latents is cond.inpainting_latents
    plain = Conditioning("tiny", t(encodings))
    assert plain.input(t(latents)) is not None and torch.equal(plain.input(t(latents)),
                                                               t(latents))


# -- conditioning and the 9-channel UNet ------------------------------------------


def _conditionings(models, seed, blur=4.0, n=1):
    jsd, sd = models
    images, masks = _inputs(seed, n=n)
    j_cond = jsd.conditioning(PROMPTS[:n], inpainting_masks=masks, inpainting_images=images,
                              mask_blur=blur)
    cond = sd.conditioning(PROMPTS[:n], inpainting_masks=masks, inpainting_images=images,
                           mask_blur=blur)
    return images, masks, j_cond, cond


def test_conditioning_with_masks_matches_jax(models):
    jsd, sd = models
    images, masks, j_cond, cond = _conditionings(models, 5, n=2)
    assert isinstance(cond, Conditioning) and cond.model_name == "tiny-inpainting"
    np.testing.assert_allclose(cond.encodings.numpy(), _np(j_cond.encodings), atol=1e-5)
    np.testing.assert_allclose(cond.inpainting_latent_masks.numpy(),
                               _np(j_cond.inpainting_latent_masks), atol=OP_ATOL)
    want = _np(j_cond.inpainting_latents)
    assert cond.inpainting_latents.shape == (2, 4, 8, 8)
    assert float(np.abs(cond.inpainting_latents.numpy() - want).max()) <= (
        MODEL_RTOL * float(np.abs(want).max()))
    # the masked image is encoded to the posterior mode: no randomness
    again = sd.conditioning(PROMPTS[:2], inpainting_masks=masks, inpainting_images=images)
    assert torch.equal(again.inpainting_latents, cond.inpainting_latents)
    with pytest.raises(ValueError, match="needs inpainting_masks"):
        sd.conditioning(PROMPTS[:1])
    # a 4-channel checkpoint returns the raw encodings, masks or not
    tiny = StableDiffusion("tiny", fp16=False, tokenizer=InRangeTokenizer(), device="cpu")
    plain = tiny.conditioning(["a"], inpainting_masks=masks[:1], inpainting_images=images[:1])
    assert isinstance(plain, torch.Tensor) and plain.shape == (1, 16, 32)


def test_nine_channel_predictions_match_jax(models):
    jsd, sd = models
    _, _, j_cond, cond = _conditionings(models, 6, n=2)
    latents = np.random.default_rng(7).standard_normal((2, 4, 8, 8)).astype(np.float32)
    want = jsd.predictions(jnp.asarray(latents), 600, j_cond)
    with torch.no_grad():
        got = sd.predictions(torch.from_numpy(latents), 600, cond)
    scale = float(np.abs(_np(want.predicted_noise)).max())
    assert float(np.abs(got.predicted_noise.numpy() - _np(want.predicted_noise)).max()) <= (
        MODEL_RTOL * scale)
    unet_sd = sd.unet.state_dict()
    assert unet_sd["conv_in.weight"].shape == (32, 9, 3, 3)
    back = jsd_convert.unet_from_diffusers({k: v.numpy() for k, v in unet_sd.items()},
                                           jsd_config.TINY_INPAINT_UNET)
    np.testing.assert_array_equal(_np(back["conv_in"]["kernel"]),
                                  _np(jsd.params["unet"]["conv_in"]["kernel"]))


# -- the sampling loop with the replace step ---------------------------------------


@pytest.mark.parametrize("method", ["ddim", "dpm++"])
def test_inpainting_sample_loop_matches_jax_program(models, method, monkeypatch):
    """Three CFG steps from the same latents and conditionings, the known
    region re-injected after each with the one fixed noise tensor."""
    jsd, sd = models
    _, _, j_cond, cond = _conditionings(models, 8)
    _, _, j_uncond, uncond = _conditionings(models, 9)
    rng = np.random.default_rng(10)
    latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    init_latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    monkeypatch.setattr(jbase.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tbase, "randn_like", lambda reference, generator: torch.from_numpy(noise))
    pairs = sd.schedule_indices(3)
    cond2 = JConditioning("tiny-inpainting",
                          jnp.concatenate([j_uncond.encodings, j_cond.encodings]),
                          j_cond.inpainting_latent_masks, j_cond.inpainting_latents)
    want = jsd._get_sample_run()(
        jsd.params, jnp.asarray(latents), jnp.asarray(pairs), cond2, jnp.asarray(init_latents),
        jax.random.PRNGKey(0), jnp.float32(7.0), jnp.float32(0.0), 0, True, 1, False, method)
    got = sd.sample_loop(torch.from_numpy(latents), pairs, uncond, cond, 7.0, method=method,
                         generator=torch.Generator().manual_seed(0),
                         init_latents=torch.from_numpy(init_latents))
    assert got.shape == latents.shape and torch.isfinite(got).all()
    assert _rel_l2(got, want) <= LOOP_RTOL
    # outside the mask the result is the init latents diffused to the last index
    to = int(pairs[-1, 1])
    known = cond.inpainting_latent_masks.expand_as(got) == 0
    assert bool(known.any())
    expected = (torch.from_numpy(init_latents) * sd.schedule_alphas[to]
                + torch.from_numpy(noise) * sd.schedule_sigmas[to])
    np.testing.assert_allclose(got[known].numpy(), expected[known].numpy(), atol=1e-6)
    # without the replace the known region is the model's
    free = sd.sample_loop(torch.from_numpy(latents), pairs, uncond, cond, 7.0, method=method,
                          generator=torch.Generator().manual_seed(0),
                          init_latents=torch.from_numpy(init_latents), replace_diffused=False)
    assert _rel_l2(free[known], expected[known]) > 0.1


def test_inpainting_sample_end_to_end(models, monkeypatch):
    """`sample()` encodes the uncond and cond masked images, then the init
    images (JAX's order), and returns finite images; seeded, repeatable."""
    _, sd = models
    images, masks = _inputs(11)
    encoded = []
    encode = sd.encode
    monkeypatch.setattr(sd, "encode", lambda x, *a: encoded.append(x.clone()) or encode(x, *a))

    def run(seed, **kwargs):
        return sd.sample(["a cat"], n_steps=3, size=(16, 16), init_images=images,
                         inpainting_masks=masks, generator=torch.Generator().manual_seed(seed),
                         **kwargs)

    out = run(0)
    assert out.shape == (1, 3, 16, 16) and torch.isfinite(out).all()
    assert len(encoded) == 3
    masked = torch.from_numpy(images * (masks <= 0.5) + 0.5 * (masks > 0.5))
    assert torch.equal(encoded[0], masked) and torch.equal(encoded[1], masked)
    assert torch.equal(encoded[2], torch.from_numpy(images))
    assert torch.equal(out, run(0)) and not torch.equal(out, run(1))
    for options in ({"method": "dpm++"}, {"eta": 0.5, "n_resample": 1},
                    {"replace_diffused": False, "mask_blur": 0.0}):
        assert torch.isfinite(run(0, **options)).all()
    with pytest.raises(ValueError, match="needs inpainting_masks"):
        sd.sample(["a cat"], n_steps=2, size=(16, 16))


def test_guided_inpainting_step_matches_jax(models):
    """One CFG-guided step of `engine.guided_sample` on Conditionings: the
    loss gradient flows through both 9-channel UNet evaluations."""
    jsd, sd = models
    _, _, j_cond, cond = _conditionings(models, 12)
    _, _, j_uncond, uncond = _conditionings(models, 13)
    rng = np.random.default_rng(14)
    latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    target = rng.uniform(size=(1, 3, 16, 16)).astype(np.float32)
    pairs = sd.schedule_indices(2, from_index=700)[:1]
    kwargs = dict(guidance_scale=40.0, clamp_value=1.0, cfg_scale=3.0)
    j_latents, j_history = j_guided_sample(
        jsd, [lambda images: ((images - jnp.asarray(target)) ** 2).sum()], jnp.asarray(latents),
        pairs, conditioning=j_cond, uncond_conditioning=j_uncond, **kwargs)
    t_losses = [lambda images: ((images - torch.from_numpy(target)) ** 2).sum()]
    got, history = guided_sample(sd, t_losses, torch.from_numpy(latents), pairs,
                                 conditioning=cond, uncond_conditioning=uncond, **kwargs)
    assert _rel_l2(got, j_latents) <= LOOP_RTOL
    assert _rel_l2(history, j_history) <= LOOP_RTOL
    unguided, _ = guided_sample(sd, t_losses, torch.from_numpy(latents), pairs,
                                conditioning=cond, uncond_conditioning=uncond,
                                **dict(kwargs, guidance_scale=0.0))
    assert _rel_l2(unguided, got) >= 1e-2


def test_inpainting_model_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusion("runwayml/stable-diffusion-inpainting")
