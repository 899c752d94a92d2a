"""The port's text-to-image path against the JAX package at TINY size, fp32
on the CPU: the CLIP tokenizer (real vocab), the SD text encoder, the Karras
index schedule, the prediction methods `sample()` and `guided_sample` run,
and the CFG sampling loop from given latents and encodings against JAX's
compiled `_get_sample_run()` program. The two models share weights: the JAX
tiny model's param tree, every leaf re-drawn from a seeded numpy rng, carried
across with `convert.stable_diffusion_state_dicts_from_jax`.

TINY_TEXT has 128 token ids, fewer than any real tokenizer emits: JAX's
gather clamps an out-of-range id silently, the port raises. So parity runs
on in-range ids (drawn directly, or from `InRangeTokenizer`), and the
real-vocab tokenizer is held against JAX on its own.
"""

import importlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceptor_tpu.predictions.base as jbase
from perceptor_tpu.models.clip import tokenizer as jtok
from perceptor_tpu.models.stable_diffusion import CLIPTextEncoder as JTextEncoder
from perceptor_tpu.models.stable_diffusion import StableDiffusion as JStableDiffusion
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu.models.stable_diffusion import convert as jsd_convert
from perceptor_tpu.models.stable_diffusion.stable_diffusion import Conditioning
from perceptor_tpu.predictions import LatentIndexedEpsPredictions as JPred
from perceptor_tpu.predictions.base import PredictionAlgebra as JAlgebra
from perceptor_tpu.schedules import indexed_schedule as j_indexed_schedule
from perceptor_tpu.schedules import karras_sigma_ramp as j_karras_sigma_ramp
from perceptor_tpu_torch import convert
from perceptor_tpu_torch.models.clip import tokenizer as ttok
from perceptor_tpu_torch.models.guided_diffusion import ADMUNet
from perceptor_tpu_torch.models.guided_diffusion.config import ADMConfig
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion, UNet
from perceptor_tpu_torch.models.stable_diffusion import config as sd_config
from perceptor_tpu_torch.models.stable_diffusion.convert import compvis_to_diffusers_unet
tattn = importlib.import_module("perceptor_tpu_torch.ops.attention")
from perceptor_tpu_torch.ops import flash_attention_kernel as tfa
from perceptor_tpu_torch.predictions.base import PredictionAlgebra
from perceptor_tpu_torch.schedules import indexed_schedule, karras_sigma_ramp

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 text encoder and single prediction methods: summation order only
TEXT_ATOL = 1e-5
ALGEBRA_ATOL = 1e-5
# the CFG loop multiplies the UNet's fp32 difference by the guidance scale
# (7) at every step; relative L2 over the final latents
LOOP_RTOL = 1e-4

PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "Hello, World!!! (it's 3:45pm) -- what's up?",
    "1234567890 and 3.14159 or 1e-6",
    "",
    "   lots   of\twhitespace\n and &amp; html   ",
    "café naïve jalapeño über",
    " ".join(["a very long prompt that keeps going"] * 12),
]


class InRangeTokenizer:
    """A stand-in tokenizer whose ids fit TINY_TEXT's 128-entry table."""

    sot_token, eot_token = 126, 127

    def encode(self, text):
        return [ord(c) % 126 for c in text]


def _fill_params(params, seed):
    """The tree's shapes, every leaf re-drawn: kernels and embeddings
    N(0, 1/fan_in), norm scales N(1, 0.1), biases N(0, 0.1)."""
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
    jsd = JStableDiffusion("tiny", fp16=False, tokenizer=jtok.SimpleTokenizer(merges=[]))
    jsd.params = _fill_params(jsd.params, seed=0)
    sd = StableDiffusion("tiny", fp16=False, tokenizer=InRangeTokenizer(), device="cpu")
    sd.load_state_dicts(convert.stable_diffusion_state_dicts_from_jax(
        jsd.params, jsd_config.TINY_UNET, jsd_config.TINY_VAE, jsd_config.TINY_TEXT))
    return jsd, sd


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- tokenizer ---------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizers():
    return jtok.SimpleTokenizer(), ttok.SimpleTokenizer()


@pytest.mark.parametrize("pattern", ["regex", "ascii"])
def test_tokenizer_matches_jax(tokenizers, pattern, monkeypatch):
    """Equal (N, 77) arrays for ASCII, punctuation, numbers, HTML entities,
    non-ASCII letters, empty and over-long prompts, under the `regex`
    pattern and the std-`re` ASCII fallback."""
    j_tok, t_tok = tokenizers
    if pattern == "ascii":
        monkeypatch.setattr(jtok, "_regex_module", lambda: None)
        j_tok = jtok.SimpleTokenizer(merges=list(j_tok.bpe_ranks))
        t_tok = ttok.SimpleTokenizer(merges=list(t_tok.bpe_ranks))
        t_tok.pat = ttok.word_pattern(False)
    want = jtok.tokenize(PROMPTS, 77, tokenizer=j_tok)
    got = ttok.tokenize(PROMPTS, 77, tokenizer=t_tok)
    assert got.dtype == np.int64 and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    # the over-long prompt is cut with EOT last; the empty one is SOT, EOT
    assert got[-1, -1] == t_tok.eot_token
    np.testing.assert_array_equal(got[3, :3], [t_tok.sot_token, t_tok.eot_token, 0])
    end = list(got[0]).index(t_tok.eot_token)
    assert t_tok.decode(got[0, 1:end]).strip() == PROMPTS[0]


def test_tokenizer_ships_its_own_vocab():
    assert ttok.DEFAULT_BPE_PATH.startswith(str(ttok.__file__).rsplit("/", 1)[0])
    assert len(ttok.SimpleTokenizer().encoder) == 49408


# -- text encoder ------------------------------------------------------------


def test_text_encoder_matches_jax(models):
    jsd, sd = models
    cfg = jsd_config.TINY_TEXT
    tokens = np.random.default_rng(20).integers(0, cfg.vocab_size, (2, cfg.context_length))
    want = JTextEncoder(cfg).apply({"params": jsd.params["text_encoder"]}, jnp.asarray(tokens))
    with torch.no_grad():
        got = sd.text_encoder(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, cfg.context_length, cfg.width)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TEXT_ATOL)
    # conditioning() is the tokenizer and the encoder
    tokens = ttok.tokenize(["a photo"], cfg.context_length, tokenizer=InRangeTokenizer())
    np.testing.assert_allclose(
        sd.conditioning(["a photo"]).numpy(),
        _np(JTextEncoder(cfg).apply({"params": jsd.params["text_encoder"]}, jnp.asarray(tokens))),
        atol=TEXT_ATOL,
    )


def test_text_encoder_raises_on_out_of_range_ids(models):
    _, sd = models
    vocab = jsd_config.TINY_TEXT.vocab_size
    for bad in (vocab, -1):
        tokens = torch.zeros((1, 16), dtype=torch.long)
        tokens[0, 3] = bad
        with pytest.raises(ValueError, match="token ids must lie"):
            sd.text_encoder(tokens)
    # the real vocabulary's ids do not fit the tiny table
    tiny = StableDiffusion("tiny", fp16=False, tokenizer=ttok.SimpleTokenizer(merges=[]),
                           device="cpu")
    with pytest.raises(ValueError, match="token ids must lie"):
        tiny.conditioning(["a photo"])


def test_text_encoder_attention_takes_the_plain_route():
    """A causal mask keeps the text encoder (S = 77) off the flash kernels,
    on a CUDA tensor too; on the CPU nothing launches."""
    cuda = type("CudaStandIn", (), {"is_cuda": True})()
    assert not tattn.flash_route(77, 77, True, cuda)
    sd = StableDiffusion("tiny", fp16=False, tokenizer=InRangeTokenizer(), device="cpu")
    tfa.reset_launches()
    sd.conditioning(["a photo", "b"])
    assert all(count == 0 for count in tfa.LAUNCHES.values())


# -- schedules ---------------------------------------------------------------


@pytest.mark.parametrize("n_steps,from_index,to_index,rho", [
    (50, 999, 0, 7.0), (20, 999, 0, 7.0), (10, 999, 0, 3.0), (4, 999, 0, 7.0),
    (25, 600, 0, 7.0), (8, 800, 100, 1.0), (500, 999, 0, 3.0),
])
def test_indexed_schedule_matches_jax(models, n_steps, from_index, to_index, rho):
    jsd, sd = models
    alphas, sigmas = sd.schedule_alphas.numpy(), sd.schedule_sigmas.numpy()
    for strict in (False, True):
        try:
            want = j_indexed_schedule(alphas, sigmas, n_steps, from_index, to_index, rho, strict)
        except ValueError:
            with pytest.raises(ValueError):
                indexed_schedule(alphas, sigmas, n_steps, from_index, to_index, rho, strict)
            continue
        got = indexed_schedule(alphas, sigmas, n_steps, from_index, to_index, rho, strict)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sd.schedule_indices(n_steps, from_index, to_index, rho),
        jsd.schedule_indices(n_steps, from_index, to_index, rho),
    )
    np.testing.assert_array_equal(
        karras_sigma_ramp(14.6, 0.03, n_steps, rho), j_karras_sigma_ramp(14.6, 0.03, n_steps, rho)
    )


# -- prediction methods ------------------------------------------------------


def _prediction_pair(models, seed=30):
    jsd, sd = models
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    noise = (2.0 * rng.standard_normal((2, 4, 8, 8))).astype(np.float32)
    idx = np.array([800, 300])
    jp = JPred(
        from_diffused_latents=jnp.asarray(latents), from_indices=jnp.asarray(idx),
        predicted_noise=jnp.asarray(noise), schedule_alphas=jsd.schedule_alphas,
        schedule_sigmas=jsd.schedule_sigmas,
        encode=lambda images: jsd.encode_fn(jsd.params, images),
        decode=lambda lat: jsd.decode_fn(jsd.params, lat),
    )
    tp = sd._make_predictions(torch.from_numpy(latents), torch.from_numpy(idx),
                              torch.from_numpy(noise))
    return rng, jp, tp


def test_prediction_methods_match_jax(models):
    rng, jp, tp = _prediction_pair(models)
    other_noise = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    j_other, t_other = jp.replace(predicted_noise=jnp.asarray(other_noise)), tp.replace(
        predicted_noise=torch.from_numpy(other_noise))
    to = np.array([780, 250])
    prev_x0 = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    prev_h = np.full((2, 1, 1, 1), 0.3, np.float32)
    pairs = {
        "classifier_free_guidance": (
            jp.classifier_free_guidance(j_other, 7.0).predicted_noise,
            tp.classifier_free_guidance(t_other, 7.0).predicted_noise),
        "correction": (j_other.correction(jp).predicted_noise,
                       t_other.correction(tp).predicted_noise),
        "static_threshold": (jp.static_threshold().predicted_noise,
                             tp.static_threshold().predicted_noise),
        "base dynamic_threshold": (
            JAlgebra.dynamic_threshold(jp, 0.9).predicted_noise,
            PredictionAlgebra.dynamic_threshold(tp, 0.9).predicted_noise),
        "latent_dynamic_threshold": (jp.latent_dynamic_threshold(0.9).predicted_noise,
                                     tp.latent_dynamic_threshold(0.9).predicted_noise),
        "vae dynamic_threshold": (jp.dynamic_threshold(0.95).predicted_noise,
                                  tp.dynamic_threshold(0.95).predicted_noise),
        "denoised_latents": (jp.denoised_latents, tp.denoised_latents),
        "denoised_images": (jp.denoised_images, tp.denoised_images),
        "dpm++ first": (jp.dpm_solver_pp_step(to, jnp.asarray(prev_x0), jnp.asarray(prev_h), True)[0],
                        tp.dpm_solver_pp_step(torch.from_numpy(to), torch.from_numpy(prev_x0),
                                              torch.from_numpy(prev_h), True)[0]),
        "dpm++ second": (
            jp.dpm_solver_pp_step(to, jnp.asarray(prev_x0), jnp.asarray(prev_h), False)[0],
            tp.dpm_solver_pp_step(torch.from_numpy(to), torch.from_numpy(prev_x0),
                                  torch.from_numpy(prev_h), torch.tensor(False))[0]),
        "dpm++ h": (jp.dpm_solver_pp_step(to, jnp.asarray(prev_x0), jnp.asarray(prev_h), False)[1],
                    tp.dpm_solver_pp_step(torch.from_numpy(to), torch.from_numpy(prev_x0),
                                          torch.from_numpy(prev_h), False)[1]),
    }
    for name, (want, got) in pairs.items():
        np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=ALGEBRA_ATOL,
                                   rtol=1e-5, err_msg=name)
    # the thresholds change something at these inputs
    assert not np.allclose(tp.latent_dynamic_threshold(0.9).predicted_noise.numpy(),
                           tp.predicted_noise.numpy())
    assert not np.allclose(tp.static_threshold().predicted_noise.numpy(),
                           tp.predicted_noise.numpy())


def test_stochastic_methods_match_jax_formula_with_replayed_noise(models, monkeypatch):
    """`step(eta > 0)`, `resample_noise` and `resample` draw from the given
    generator; JAX's formulas, fed the same noise, give the same result."""
    _, jp, tp = _prediction_pair(models, seed=31)
    to = np.array([780, 250])

    def replay(seed):
        noise = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(seed))
        monkeypatch.setattr(jbase.jax.random, "normal",
                            lambda key, shape, dtype=None: jnp.asarray(noise.numpy()))
        return torch.Generator().manual_seed(seed)

    key = jax.random.PRNGKey(0)
    cases = {
        "step eta=0.5": (lambda: jp.step(to, eta=0.5, key=key),
                         lambda g: tp.step(torch.from_numpy(to), eta=0.5, generator=g)),
        "step eta tensor": (lambda: jp.step(to, eta=jnp.float32(0.3), key=key),
                            lambda g: tp.step(torch.from_numpy(to), eta=torch.tensor(0.3),
                                              generator=g)),
        "resample_noise": (lambda: jp.resample_noise(to, key),
                           lambda g: tp.resample_noise(torch.from_numpy(to), g)),
        "resample": (lambda: jp.resample(to, key), lambda g: tp.resample(torch.from_numpy(to), g)),
    }
    for i, (name, (j_fn, t_fn)) in enumerate(cases.items()):
        generator = replay(40 + i)
        np.testing.assert_allclose(t_fn(generator).numpy(), _np(j_fn()), atol=ALGEBRA_ATOL,
                                   rtol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="generator"):
        tp.resample(torch.from_numpy(to))


def test_preview_images_match_jax(models):
    jsd, sd = models
    latents = np.random.default_rng(32).standard_normal((2, 4, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(sd.preview_images_fn(torch.from_numpy(latents)).numpy(),
                               _np(jsd.preview_images_fn(jnp.asarray(latents))), atol=1e-6)


# -- the sampling loop -------------------------------------------------------


@pytest.mark.parametrize("method", ["ddim", "dpm++"])
def test_sample_loop_matches_jax_program(models, method):
    """The eager CFG loop against JAX's compiled sampling program, from the
    same latents and encodings (deterministic: eta 0, no resampling)."""
    jsd, sd = models
    cfg = jsd_config.TINY_TEXT
    rng = np.random.default_rng(33)
    latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    uncond, cond = (rng.standard_normal((2, cfg.context_length, cfg.width)).astype(np.float32)
                    for _ in range(2))
    pairs = sd.schedule_indices(4)
    run = jsd._get_sample_run()
    want = run(
        jsd.params, jnp.asarray(latents), jnp.asarray(pairs),
        Conditioning("tiny", jnp.concatenate([jnp.asarray(uncond), jnp.asarray(cond)])),
        jnp.zeros(latents.shape), jax.random.PRNGKey(0), jnp.float32(7.0), jnp.float32(0.0),
        0, False, 1, False, method,
    )
    got = sd.sample_loop(torch.from_numpy(latents), pairs, torch.from_numpy(uncond),
                         torch.from_numpy(cond), 7.0, method=method)
    assert got.shape == latents.shape and torch.isfinite(got).all()
    assert _rel_l2(got.numpy(), want) <= LOOP_RTOL


# -- sample() end to end -----------------------------------------------------


def test_sample_end_to_end_finite_and_seeded_repeatable(models):
    _, sd = models

    def run(seed, **kwargs):
        return sd.sample(["a photo", "a dog"], n_steps=3, size=(16, 16),
                         generator=torch.Generator().manual_seed(seed), **kwargs)

    images = run(0)
    assert images.shape == (2, 3, 16, 16) and images.dtype == torch.float32
    assert torch.isfinite(images).all()
    assert torch.equal(images, run(0)) and not torch.equal(images, run(1))
    assert torch.equal(sd.sample(["a photo", "a dog"], n_steps=3, size=(16, 16)), images)
    negative = run(0, negative_texts=["blurry", "blurry"])
    assert torch.isfinite(negative).all() and not torch.equal(negative, images)
    dpm = run(0, method="dpm++")
    assert torch.isfinite(dpm).all() and not torch.equal(dpm, images)
    steps = list(sd.sample_iter(["a photo"], n_steps=3, size=(16, 16),
                                generator=torch.Generator().manual_seed(0)))
    assert len(steps) == len(sd.schedule_indices(3))
    assert torch.isfinite(steps[-1].denoised_latents).all()


def test_sample_img2img_with_resample(models):
    _, sd = models
    init_images = torch.from_numpy(
        np.random.default_rng(34).uniform(size=(1, 3, 32, 32)).astype(np.float32))

    def run(seed):
        return sd.sample(["a test"], n_steps=3, size=(32, 32), from_index=500,
                         init_images=init_images, n_resample=1, eta=0.5,
                         generator=torch.Generator().manual_seed(seed))

    images = run(0)
    assert images.shape == (1, 3, 32, 32) and torch.isfinite(images).all()
    assert torch.equal(images, run(0)) and not torch.equal(images, run(1))
    with pytest.raises(ValueError, match="init_images"):
        sd.sample(["a test"], n_steps=2, size=(32, 32), from_index=500)
    with pytest.raises(ValueError, match="deterministic"):
        sd.sample(["a test"], n_steps=2, size=(32, 32), method="dpm++", eta=0.5)
    with pytest.raises(ValueError, match="unknown sampling method"):
        sd.sample(["a test"], n_steps=2, size=(32, 32), method="euler")
    with pytest.raises(ValueError, match="divisible"):
        sd.sample(["a test"], n_steps=2, size=(17, 16))


def test_stable_diffusion_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusion("tiny")
    with pytest.raises(ValueError, match="unknown stable diffusion name"):
        StableDiffusion("sd-9", device="cpu")


# -- DeepCache, the CompVis key map, finetuneable_vae ------------------------


def test_unet_deepcache_passes_match_jax(models):
    """`return_cache=True` returns the deep feature entering the last up
    level, and `cache=` runs only the shallow level on it: both against the
    JAX UNet's branch, and the full pass is unchanged."""
    jsd, sd = models
    cfg = jsd_config.TINY_TEXT
    rng = np.random.default_rng(35)
    latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    ts = np.array([700.0, 650.0], np.float32)
    context = rng.standard_normal((2, cfg.context_length, cfg.width)).astype(np.float32)
    apply = jax.jit(lambda x, **kw: jsd.unet.apply({"params": jsd.params["unet"]}, x,
                                                   jnp.asarray(ts), jnp.asarray(context), **kw),
                    static_argnames=("return_cache",))
    j_out, j_cache = apply(jnp.asarray(latents), return_cache=True)
    other = (latents + 0.3).astype(np.float32)
    j_partial = apply(jnp.asarray(other), cache=j_cache)
    args = (torch.from_numpy(ts), torch.from_numpy(context))
    with torch.no_grad():
        out, cache = sd.unet(torch.from_numpy(latents), *args, return_cache=True)
        partial = sd.unet(torch.from_numpy(other), *args, cache=cache)
        again, same = sd.unet(torch.from_numpy(other), *args, cache=cache, return_cache=True)
        full = sd.unet(torch.from_numpy(latents), *args)
    assert cache.shape == (2, 64, 8, 8)  # the last up level's input: level 1 upsampled
    np.testing.assert_allclose(out.numpy(), _np(j_out), atol=1e-4)
    # JAX's cache is NHWC, the port's NCHW
    np.testing.assert_allclose(cache.permute(0, 2, 3, 1).numpy(), _np(j_cache), atol=1e-4)
    np.testing.assert_allclose(partial.numpy(), _np(j_partial), atol=1e-4)
    assert torch.equal(full, out) and torch.equal(again, partial) and same is cache


@pytest.mark.parametrize("method", ["ddim", "dpm++"])
def test_sample_loop_with_deepcache_matches_jax_program(models, method):
    """`cache_interval=3` over 5 pairs: full UNet passes at steps 0 and 3,
    the partial pass on the cache at 1, 2 and 4; against JAX's program."""
    jsd, sd = models
    cfg = jsd_config.TINY_TEXT
    rng = np.random.default_rng(36)
    latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    uncond, cond = (rng.standard_normal((1, cfg.context_length, cfg.width)).astype(np.float32)
                    for _ in range(2))
    pairs = sd.schedule_indices(5)
    assert len(pairs) == 5
    want = jsd._get_sample_run()(
        jsd.params, jnp.asarray(latents), jnp.asarray(pairs),
        Conditioning("tiny", jnp.concatenate([jnp.asarray(uncond), jnp.asarray(cond)])),
        jnp.zeros(latents.shape), jax.random.PRNGKey(0), jnp.float32(7.0), jnp.float32(0.0),
        0, False, 3, False, method,
    )
    args = (torch.from_numpy(latents), pairs, torch.from_numpy(uncond), torch.from_numpy(cond), 7.0)
    got = sd.sample_loop(*args, method=method, cache_interval=3)
    assert _rel_l2(got.numpy(), want) <= LOOP_RTOL
    # the cached steps change the result; cache_interval 1 is the exact sampler
    assert _rel_l2(got.numpy(), sd.sample_loop(*args, method=method).numpy()) > 1e-4
    with pytest.raises(ValueError, match="incompatible"):
        sd.sample_loop(*args, n_resample=1, cache_interval=2)
    with pytest.raises(ValueError, match="incompatible"):
        sd.sample(["a"], n_steps=3, size=(16, 16), n_resample=1, cache_interval=2)


# the ADM spatial-transformer config that describes TINY_UNET's network
ADM_TWIN = ADMConfig(
    image_size=8, model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_ds=(1,),
    num_heads=2, in_channels=4, out_channels=4, spatial_transformer=True, context_dim=32,
)


def test_compvis_to_diffusers_unet_matches_jax_and_its_adm_twin():
    """On one CompVis-named state_dict (an ADM spatial-transformer UNet's,
    under `model.diffusion_model.`): the same keys and values as the JAX
    map; loaded into the SD UNet, the same output as the ADM UNet."""
    adm = ADMUNet(ADM_TWIN).eval()
    gen = torch.Generator().manual_seed(37)
    with torch.no_grad():
        for p in adm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    compvis = {f"model.diffusion_model.{k}": v for k, v in adm.state_dict().items()}
    compvis["first_stage_model.encoder.conv_in.weight"] = torch.zeros(1)  # not the UNet's
    got = compvis_to_diffusers_unet(compvis, sd_config.TINY_UNET)
    want = jsd_convert.compvis_to_diffusers_unet(compvis, jsd_config.TINY_UNET)
    assert set(got) == set(want) and len(got) == len(adm.state_dict())
    assert all(got[k] is want[k] for k in want)
    unet = UNet(sd_config.TINY_UNET).eval()
    unet.load_state_dict(got)  # strict: every key of the SD UNet is covered
    rng = np.random.default_rng(38)
    xs = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ts = torch.tensor([900.0, 30.0])
    context = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(unet(xs, ts, context).numpy(), adm(xs, ts, context).numpy(),
                                   atol=1e-5)
    # bare keys work too
    assert set(compvis_to_diffusers_unet(adm.state_dict(), sd_config.TINY_UNET)) == set(got)


def test_finetuneable_vae_restores_weights_and_flags(models):
    _, sd = models
    before = {k: v.clone() for k, v in sd.vae.state_dict().items()}
    latents = torch.from_numpy(np.random.default_rng(39).standard_normal((1, 4, 8, 8))
                               .astype(np.float32))
    sd.vae.requires_grad_(False)
    with sd.finetuneable_vae() as m:
        assert m is sd and all(p.requires_grad for p in sd.vae.parameters())
        optimizer = torch.optim.SGD(sd.vae.parameters(), lr=0.1)
        m.decode(latents).square().mean().backward()
        optimizer.step()
        changed = sd.vae.decoder.conv_out.weight.detach().clone()
    assert not torch.equal(changed, before["decoder.conv_out.weight"])
    assert not any(p.requires_grad for p in sd.vae.parameters())
    after = sd.vae.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before)
    # restored on an exception too
    with pytest.raises(RuntimeError, match="stop"):
        with sd.finetuneable_vae():
            with torch.no_grad():
                sd.vae.decoder.conv_out.weight.add_(1.0)
            raise RuntimeError("stop")
    assert torch.equal(sd.vae.decoder.conv_out.weight, before["decoder.conv_out.weight"])
    # the JAX config's fields are the port's; the fields only SDXL sets (the
    # port's own) keep the values that build the SD-1.x UNet
    port, jax_fields = dataclasses.asdict(sd_config.TINY_UNET), dataclasses.asdict(jsd_config.TINY_UNET)
    assert {k: port[k] for k in jax_fields} == jax_fields
    assert {k: v for k, v in port.items() if k not in jax_fields} == {
        "head_dim": None, "linear_projection": False, "added_time_dim": None,
        "added_input_dim": None}
