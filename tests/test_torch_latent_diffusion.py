"""The port's latent-diffusion family against the JAX package at TINY size,
fp32 on the CPU: the ADM UNet's spatial-transformer branch, the BERT
encoder and WordPiece tokenizer, the VQ first stage and the CompVis key
map, and the Text2Image / Face / SuperResolution samplers against JAX's
compiled `_build_sample_run` programs from the same latents. The models
share weights: each JAX tiny wrapper's param tree, every leaf re-drawn from
a seeded numpy rng, carried across with `convert`. JAX PRNG draws cannot be
replayed by a `torch.Generator`, so the stochastic sampler runs with one
fixed noise tensor fed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceptor_tpu.predictions.base as jbase
from perceptor_tpu.models.guided_diffusion import ADMUNet as JADMUNet
from perceptor_tpu.models.guided_diffusion import convert as jadm_convert
from perceptor_tpu.models.latent_diffusion import Face as JFace
from perceptor_tpu.models.latent_diffusion import SuperResolution as JSuperResolution
from perceptor_tpu.models.latent_diffusion import Text2Image as JText2Image
from perceptor_tpu.models.latent_diffusion import bert as jbert
from perceptor_tpu.models.latent_diffusion import first_stage as jfirst_stage
from perceptor_tpu.models.latent_diffusion import text2image as jtext2image
from perceptor_tpu_torch import convert, models
from perceptor_tpu_torch.models.guided_diffusion import ADMUNet
from perceptor_tpu_torch.models.guided_diffusion.unet import AttentionBlock
from perceptor_tpu_torch.models.latent_diffusion import (
    BERTEncoder,
    BERTTokenizer,
    Face,
    SuperResolution,
    Text2Image,
    VectorQuantizer,
    VQModel,
    convert_compvis_autoencoder,
)
from perceptor_tpu_torch.models.latent_diffusion import bert as tbert
from perceptor_tpu_torch.models.latent_diffusion import face as tface
from perceptor_tpu_torch.models.latent_diffusion import first_stage
from perceptor_tpu_torch.models.latent_diffusion import super_resolution as tsr
from perceptor_tpu_torch.models.latent_diffusion import text2image as ttext2image
from perceptor_tpu_torch.models.stable_diffusion.unet import SpatialTransformer
from perceptor_tpu_torch.predictions import base as tbase

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides through the whole UNet: summation order only
UNET_ATOL = 1e-4
# max |gradient error| over max |gradient|
GRAD_RTOL = 1e-4
# fp32 text encoder and first stage: summation order only
ENCODER_ATOL = 1e-5
# relative L2 over the sampler's final images (k + 1 UNet evaluations)
LOOP_RTOL = 1e-4

_TINY_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat", "photo", "of", "##s", "the"]
PROMPTS = ["a photo of cats", "the cat", "A PHOTO, of the cats!", "dogs", "",
           " ".join(["a photo of the cats"] * 5)]


def fill_params(params, seed):
    """Every leaf re-drawn: kernels N(0, 1/fan_in), norm scales N(1, 0.1),
    biases N(0, 0.1); the VQ codebook N(0, 1), so that its entries spread
    like the latents and nearest codes are far from ties."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "embedding":
            out = rng.standard_normal(shape)
        elif len(shape) >= 2:
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(out.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, params)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def wrappers():
    """The three JAX tiny wrappers (their own instances: the constructor
    arguments differ from test_latent_diffusion.py's) and the port's, on the
    same weights."""
    jt = JText2Image(fp16=False, tiny=True, guidance_scale=3.0,
                     tokenizer=jbert.BERTTokenizer(vocab=_TINY_VOCAB, max_length=16))
    jt.params = fill_params(jt.params, seed=1)
    t = Text2Image(fp16=False, tiny=True, guidance_scale=3.0, device="cpu",
                   tokenizer=BERTTokenizer(vocab=_TINY_VOCAB, max_length=16))
    t.load_state_dicts(convert.text2image_state_dicts_from_jax(
        _numpy_tree(jt.params), t.unet_config, t.vae_config, t.bert_config))
    jf = JFace(eta=0.0, fp16=False, tiny=True)
    jf.params = fill_params(jf.params, seed=2)
    f = Face(fp16=False, tiny=True, device="cpu")
    f.load_state_dicts(convert.vq_diffusion_state_dicts_from_jax(
        _numpy_tree(jf.params), f.unet_config, f.vq_config))
    js = JSuperResolution(eta=1.0, fp16=False, tiny=True)
    js.params = fill_params(js.params, seed=3)
    s = SuperResolution(fp16=False, tiny=True, device="cpu")
    s.load_state_dicts(convert.vq_diffusion_state_dicts_from_jax(
        _numpy_tree(js.params), s.unet_config, s.vq_config))
    return {"text2image": (jt, t), "face": (jf, f), "super_resolution": (js, s)}


# -- the ADM UNet's spatial-transformer branch -------------------------------


def test_spatial_transformer_unet_forward_and_input_gradient_match_jax():
    cfg = ttext2image.TINY_UNET
    jmodule = JADMUNet(jtext2image.TINY_UNET, dtype=jnp.float32)
    params = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)),
                            jnp.zeros((1,)), jnp.zeros((1, 5, 32)))
    params = fill_params(params["params"], seed=4)
    module = ADMUNet(cfg).eval()
    module.load_state_dict(convert.adm_state_dict_from_jax(_numpy_tree(params), cfg))
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    ts = np.array([800.0, 12.0], np.float32)
    context = rng.standard_normal((2, 7, 32)).astype(np.float32)
    probe = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)

    def j_out(x):
        return jmodule.apply({"params": params}, x, jnp.asarray(ts), jnp.asarray(context))

    want = jax.jit(j_out)(jnp.asarray(xs))
    want_grad = jax.jit(jax.grad(lambda x: (j_out(x) * probe).sum()))(jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_(True)
    got = module(x, torch.from_numpy(ts), torch.from_numpy(context))
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), x)
    assert got.shape == (2, 4, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=UNET_ATOL)
    assert np.abs(got_grad.numpy() - _np(want_grad)).max() <= GRAD_RTOL * np.abs(want_grad).max()
    # every attention block is a spatial transformer; context is required
    assert not any(isinstance(m, AttentionBlock) for m in module.modules())
    assert sum(isinstance(m, SpatialTransformer) for m in module.modules()) == 4
    with pytest.raises(ValueError, match="needs context"):
        module(x, torch.from_numpy(ts))


def test_spatial_transformer_state_dict_round_trips_through_the_jax_converter_exactly():
    cfg = ttext2image.TINY_UNET
    module = ADMUNet(cfg)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    state = module.state_dict()
    assert "input_blocks.3.1.transformer_blocks.0.attn1.to_q.weight" in state
    assert "middle_block.1.proj_in.weight" in state
    back = convert.adm_state_dict_from_jax(jadm_convert.from_torch(state), cfg)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)


# -- BERT --------------------------------------------------------------------


def test_bert_encoder_matches_jax_and_reads_the_jax_converters_names():
    cfg = tbert.TINY_BERT
    jmodule = jbert.BERTEncoder(jbert.TINY_BERT, dtype=jnp.float32)
    params = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    params = params["params"]
    params = fill_params(params, seed=7)
    module = BERTEncoder(cfg).eval()
    module.load_state_dict(convert.bert_state_dict_from_jax(_numpy_tree(params), cfg))
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 16))
    apply = jax.jit(lambda tokens: jmodule.apply({"params": params}, tokens))
    want = apply(jnp.asarray(tokens))
    with torch.no_grad():
        got = module(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (3, 16, cfg.width)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ENCODER_ATOL)
    # shorter sequences take the first positions
    np.testing.assert_allclose(
        module(torch.from_numpy(tokens[:, :9])).detach().numpy(),
        _np(apply(jnp.asarray(tokens[:, :9]))), atol=ENCODER_ATOL)
    # the module's state_dict is an x-transformer one: JAX's convert_bert reads it
    back = jbert.convert_bert(
        {f"cond_stage_model.transformer.{k}": v.numpy() for k, v in module.state_dict().items()},
        jbert.TINY_BERT)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, _numpy_tree(params))
    with pytest.raises(ValueError, match="token ids must lie"):
        module(torch.full((1, 4), cfg.vocab_size))


@pytest.mark.parametrize("max_length", [16, 6])
def test_bert_tokenizer_matches_jax(max_length):
    """Equal ids, with `##` pieces, unknown words, punctuation and the cut
    to max_length (the last id of a cut row is [SEP])."""
    want = jbert.BERTTokenizer(vocab=_TINY_VOCAB, max_length=max_length)(PROMPTS)
    got = BERTTokenizer(vocab=_TINY_VOCAB, max_length=max_length)(PROMPTS)
    assert got.dtype == np.int32 and got.shape == (len(PROMPTS), max_length)
    np.testing.assert_array_equal(got, want)
    assert list(got[0, :6]) == [2, 4, 6, 7, 5, 8][:max_length - 1] + [3] * (max_length < 7)
    assert got[-1, -1] == 3 and 1 in got[3]  # [SEP] last; "dogs" is [UNK]


def test_bert_tokenizer_needs_a_vocab(monkeypatch, tmp_path):
    missing = (str(tmp_path / "none.txt"),)
    monkeypatch.setattr(tbert, "_VOCAB_PATHS", missing)
    monkeypatch.setattr(jbert, "_VOCAB_PATHS", missing)
    for tokenizer in (BERTTokenizer, jbert.BERTTokenizer):
        with pytest.raises(FileNotFoundError, match="pass vocab="):
            tokenizer()
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(_TINY_VOCAB) + "\n", encoding="utf-8")
    monkeypatch.setattr(tbert, "_VOCAB_PATHS", (str(path),))
    np.testing.assert_array_equal(
        BERTTokenizer(max_length=8)(PROMPTS), jbert.BERTTokenizer(_TINY_VOCAB, 8)(PROMPTS))


# -- the VQ first stage ------------------------------------------------------


@pytest.fixture(scope="module")
def vq_pair():
    jmodule = jfirst_stage.VQModel(jfirst_stage.TINY_VQ, n_embed=256, dtype=jnp.float32)
    params = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))
    params = params["params"]
    params = fill_params(params, seed=9)
    module = VQModel(first_stage.TINY_VQ, n_embed=256).eval()
    module.load_state_dict(convert.vq_state_dict_from_jax(_numpy_tree(params),
                                                          first_stage.TINY_VQ))
    return jmodule, params, module


def test_vector_quantizer_indices_match_jax_and_gradient_is_straight_through(vq_pair):
    jmodule, params, module = vq_pair
    z = np.random.default_rng(10).standard_normal((2, 3, 8, 8)).astype(np.float32)
    codebook = params["quantize"]["embedding"]
    flat = jnp.asarray(z).transpose(0, 2, 3, 1).reshape(-1, 3)
    want_idx = jnp.argmin(jnp.sum(flat**2, 1, keepdims=True) - 2 * flat @ codebook.T
                          + jnp.sum(codebook**2, 1)[None], axis=1)
    quantizer = module.quantize
    assert isinstance(quantizer, VectorQuantizer)
    got_idx = quantizer.indices(torch.from_numpy(z))
    np.testing.assert_array_equal(got_idx.reshape(-1).numpy(), np.asarray(want_idx))
    assert len(np.unique(got_idx.numpy())) > 10
    want = jfirst_stage.VectorQuantizer(256, 3).apply(
        {"params": {"embedding": codebook}}, jnp.asarray(z))
    x = torch.from_numpy(z).requires_grad_(True)
    out = quantizer(x)
    np.testing.assert_allclose(out.detach().numpy(), _np(want), atol=1e-6)
    probe = torch.randn(x.shape, generator=torch.Generator().manual_seed(11))
    (grad,) = torch.autograd.grad((out * probe).sum(), x)
    assert torch.equal(grad, probe)


def test_vq_model_encode_and_decode_match_jax(vq_pair):
    jmodule, params, module = vq_pair
    rng = np.random.default_rng(12)
    xs = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        latents = module.encode(torch.from_numpy(xs))
        decoded = module.decode(latents)
        raw = module.decode(latents, force_not_quantize=True)
    want_latents = jax.jit(lambda xs: jmodule.apply({"params": params}, xs,
                                                    method=jmodule.encode))(jnp.asarray(xs))
    assert latents.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(latents.numpy(), _np(want_latents), atol=ENCODER_ATOL)
    # decode from the same latents on both sides (quantization snaps them)
    for got, force in ((decoded, False), (raw, True)):
        want = jax.jit(lambda z: jmodule.apply({"params": params}, z, force,
                                               method=jmodule.decode))(jnp.asarray(latents.numpy()))
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ENCODER_ATOL)
    assert not torch.allclose(decoded, raw)


def _compvis_first_stage(cfg, vq, seed):
    """A CompVis-named first-stage state_dict of `cfg`'s shapes, values
    random: the port's own state_dict renamed by hand."""
    module = VQModel(cfg, n_embed=32) if vq else models.stable_diffusion.AutoencoderKL(cfg)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    n_levels = len(cfg.channel_mults)
    for key, value in module.state_dict().items():
        value = torch.randn(value.shape, generator=gen)
        parts = key.split(".")
        if parts[1] in ("down_blocks", "up_blocks"):
            level = int(parts[2]) if parts[1] == "down_blocks" else n_levels - 1 - int(parts[2])
            head = f"{parts[0]}.{'down' if parts[1] == 'down_blocks' else 'up'}.{level}"
            if parts[3] == "resnets":
                name = {"conv_shortcut": "nin_shortcut"}.get(parts[5], parts[5])
                key = f"{head}.block.{parts[4]}.{name}.{parts[-1]}"
            else:  # downsamplers.0.conv / upsamplers.0.conv
                key = f"{head}.{parts[3][:-2]}.conv.{parts[-1]}"
        elif parts[1] == "mid_block":
            if parts[2] == "resnets":
                name = {"conv_shortcut": "nin_shortcut"}.get(parts[4], parts[4])
                key = f"{parts[0]}.mid.block_{int(parts[3]) + 1}.{name}.{parts[-1]}"
            else:
                name = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v",
                        "to_out": "proj_out"}[parts[4]]
                if value.ndim == 2:
                    value = value[:, :, None, None]
                key = f"{parts[0]}.mid.attn_1.{name}.{parts[-1]}"
        elif parts[1] == "conv_norm_out":
            key = f"{parts[0]}.norm_out.{parts[-1]}"
        sd[f"first_stage_model.{key}"] = value
    return sd


@pytest.mark.parametrize("stage", ["vq", "kl"])
def test_compvis_first_stage_key_map_matches_the_jax_converter(stage):
    """convert_compvis_autoencoder gives the tensors that JAX's converter
    followed by `vq_state_dict_from_jax` (or `vae_...`) gives, under every
    one of the port module's names."""
    vq = stage == "vq"
    cfg = first_stage.TINY_VQ if vq else dataclasses.replace(
        first_stage.KL_F8, base_channels=16, channel_mults=(1, 2), n_res_blocks=1)
    compvis = _compvis_first_stage(cfg, vq, seed=13)
    got = convert_compvis_autoencoder(compvis, cfg)
    jparams = jfirst_stage.convert_compvis_autoencoder(
        {k: v.numpy() for k, v in compvis.items()}, cfg)
    want = (convert.vq_state_dict_from_jax if vq else convert.vae_state_dict_from_jax)(
        jparams, cfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    module = VQModel(cfg, n_embed=32) if vq else models.stable_diffusion.AutoencoderKL(cfg)
    assert set(got) == set(module.state_dict())
    module.load_state_dict(got)


# -- the wrappers ------------------------------------------------------------


def _start(name, t, rng):
    """Initial latents (and conditioning) for a sampler run at 16 x 16."""
    if name == "text2image":
        latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
        return latents, (["a photo of cats", "the cat"], ["", ""])
    if name == "face":
        return rng.standard_normal((2, 3, 8, 8)).astype(np.float32), None
    images = rng.uniform(size=(2, 3, 16, 16)).astype(np.float32)
    return rng.standard_normal((2, 3, 8, 8)).astype(np.float32), images


def _fixed_noise(monkeypatch, shape, seed):
    """The same noise tensor for every draw on both sides."""
    noise = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(jbase.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tbase, "randn_like", lambda reference, generator: torch.from_numpy(noise))


@pytest.mark.parametrize("case", ["ddim", "dpm++", "ddim_eta"])
@pytest.mark.parametrize("name", ["text2image", "face", "super_resolution"])
def test_sample_loop_matches_jax_program(wrappers, name, case, monkeypatch):
    """The eager loop against the JAX wrapper's compiled sampler from the
    same latents and conditioning; eta > 0 with one fixed noise tensor on
    both sides."""
    jw, w = wrappers[name]
    rng = np.random.default_rng(14)
    latents, extra = _start(name, w, rng)
    method = "dpm++" if case == "dpm++" else "ddim"
    eta = 0.5 if case == "ddim_eta" else 0.0
    pairs = w.schedule_indices(999, 100, 5)
    if eta:
        _fixed_noise(monkeypatch, latents.shape, seed=15)
    key = jax.random.PRNGKey(0)
    if name == "text2image":
        jcond = jw.conditioning(*extra)
        cond = w.conditioning(*extra)
        np.testing.assert_allclose(cond.numpy(), _np(jcond), atol=ENCODER_ATOL)
        want = jw._build_sample_run(eta > 0, True, method)(
            jw.params, jnp.asarray(latents), jnp.asarray(pairs), jcond, key, jnp.float32(3.0),
            jnp.float32(eta))
        got = w.sample_loop(torch.from_numpy(latents), pairs, cond, eta=eta, method=method,
                            generator=torch.Generator().manual_seed(0))
    elif name == "face":
        want = jw._build_sample_run(eta > 0, method)(
            jw.params, jnp.asarray(latents), jnp.asarray(pairs), None, key, jnp.float32(0.0),
            jnp.float32(eta))
        got = w.sample_loop(torch.from_numpy(latents), pairs, eta=eta, method=method,
                            generator=torch.Generator().manual_seed(0))
    else:
        jcond = jw.conditioning(jnp.asarray(extra))
        cond = w.conditioning(torch.from_numpy(extra))
        np.testing.assert_allclose(cond.numpy(), _np(jcond), atol=1e-5)
        want = jw._build_sample_run(eta > 0, method)(
            jw.params, jnp.asarray(latents), jnp.asarray(pairs), jcond, key, jnp.float32(0.0),
            jnp.float32(eta))
        got = w.sample_loop(torch.from_numpy(latents), pairs, cond, eta=eta, method=method,
                            generator=torch.Generator().manual_seed(0))
    assert got.shape == (2, 3, 16, 16) and torch.isfinite(got).all()
    assert _rel_l2(got.numpy(), want) <= LOOP_RTOL


@pytest.mark.parametrize("name", ["text2image", "face", "super_resolution"])
def test_index_api_matches_jax(wrappers, name):
    """eps, denoise, step (with given noise), diffuse, latents and images
    at single indices, and the schedule tables."""
    jw, w = wrappers[name]
    rng = np.random.default_rng(16)
    latents, extra = _start(name, w, rng)
    noise = rng.standard_normal(latents.shape).astype(np.float32)
    np.testing.assert_array_equal(w.schedule_alphas.numpy(), _np(jw.schedule_alphas))
    np.testing.assert_array_equal(w.schedule_indices(999, 0, 7), jw.schedule_indices(999, 0, 7))
    x, jx = torch.from_numpy(latents), jnp.asarray(latents)
    np.testing.assert_allclose(
        w.diffuse(x, 600, noise=torch.from_numpy(noise)).numpy(),
        _np(jw.diffuse(jx, 600, noise=jnp.asarray(noise))), atol=1e-6)
    if name == "text2image":
        cond, jcond = w.conditioning(*extra), jw.conditioning(*extra)
        eps_args, jeps_args = (700, cond), (700, jcond)
        args, jargs = eps_args, jeps_args  # denoise(latents, index, conditioning)
    elif name == "face":
        eps_args = jeps_args = args = jargs = (700,)
    else:
        cond, jcond = w.conditioning(torch.from_numpy(extra)), jw.conditioning(jnp.asarray(extra))
        eps_args, jeps_args = (700, cond), (700, jcond)
        args, jargs = (cond, 700), (jcond, 700)  # denoise(latents, conditioning, index)
    with torch.no_grad():
        np.testing.assert_allclose(w.eps(x, *eps_args).numpy(), _np(jw.eps(jx, *jeps_args)),
                                   atol=UNET_ATOL)
        denoised = w.denoise(x, *args)
    jdenoised = jw.denoise(jx, *jargs)
    np.testing.assert_allclose(denoised.numpy(), _np(jdenoised), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(
        w.step(x, denoised, 700, 500, noise=torch.from_numpy(noise)).numpy(),
        _np(jw.step(jx, jnp.asarray(denoised.numpy()), 700, 500, noise=jnp.asarray(noise))),
        atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        images = w.images(x)
    np.testing.assert_allclose(images.numpy(), _np(jw.images(jx)), atol=ENCODER_ATOL)
    pixels = rng.uniform(size=(1, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        encoded = w.latents(torch.from_numpy(pixels))
    np.testing.assert_allclose(encoded.numpy(), _np(jax.jit(jw.latents)(jnp.asarray(pixels))),
                               atol=ENCODER_ATOL)


def test_refusals_match_jax(wrappers):
    t, f, s = (wrappers[n][1] for n in ("text2image", "face", "super_resolution"))
    x = torch.zeros((1, 3, 8, 8))
    cond = t.conditioning(["a cat"])
    for fn in (lambda: t.eps(torch.zeros((1, 4, 8, 8)), 1000, cond), lambda: f.eps(x, 1000),
               lambda: s.eps(x, 1000, x)):
        with pytest.raises(ValueError, match="less than 1000"):
            fn()
    with pytest.raises(ValueError, match="deterministic"):
        t.sample(["a cat"], n_steps=3, size=(16, 16), eta=0.5, method="dpm++")
    with pytest.raises(ValueError, match=r"pass eta=0"):
        s.sample(torch.zeros((1, 3, 16, 16)), n_steps=3, method="dpm++")  # eta defaults to 1
    with pytest.raises(ValueError, match="unknown sampling method"):
        f.sample(n_steps=3, size=(16, 16), method="plms")
    with pytest.raises(ValueError, match="smaller than from_index"):
        f.step(x, x, 500, 700)
    with pytest.raises(ValueError, match="greater than to_index"):
        t.schedule_indices(100, 200)
    with pytest.raises(ValueError, match="unique"):
        f.schedule_indices(60, 50, 30)
    assert len(s.schedule_indices(60, 50, 30)) == 29  # SR allows repeats, as JAX
    with pytest.raises(ValueError, match="generator"):
        f.diffuse(x, 500)
    with pytest.raises(ValueError, match="stochastic"):
        SuperResolution(fp16=False, tiny=True, device="cpu").step(x, x, 700, 500)
    # the published face model makes 256 x 256 images only
    f256 = Face(fp16=False, tiny=True, device="cpu")
    f256.unet_config = tface.FACE_UNET
    with pytest.raises(ValueError, match="256x256"):
        f256.random_latents((1, 3, 128, 128), torch.Generator())
    assert f256.random_latents((1, 3, 256, 256), torch.Generator()).shape == (1, 3, 128, 128)


def test_sample_end_to_end_is_finite_and_seeded_repeatable(wrappers):
    t, f, s = (wrappers[n][1] for n in ("text2image", "face", "super_resolution"))
    runs = {
        "text2image": lambda g, **kw: t.sample(["a cat", "the photo"], n_steps=3, size=(16, 16),
                                               generator=g, **kw),
        "face": lambda g, **kw: f.sample(n_images=2, n_steps=3, size=(16, 16), generator=g, **kw),
        "super_resolution": lambda g, **kw: s.sample(
            s.upsample(torch.rand((2, 3, 8, 8), generator=torch.Generator().manual_seed(17))),
            n_steps=3, generator=g, **kw),
    }
    for name, run in runs.items():
        first = run(torch.Generator().manual_seed(1))
        assert first.shape == (2, 3, 16, 16) and torch.isfinite(first).all(), name
        assert torch.equal(first, run(torch.Generator().manual_seed(1))), name
        assert not torch.equal(first, run(torch.Generator().manual_seed(2))), name
        assert torch.isfinite(run(None, method="dpm++", eta=0.0)).all(), name
    # the guidance scale takes effect; 1.0 (and None) turn CFG off
    g = torch.Generator().manual_seed(1)
    assert not torch.equal(runs["text2image"](g, guidance_scale=8.0),
                           runs["text2image"](torch.Generator().manual_seed(1)))


def test_exports_and_cuda_is_the_default():
    assert models.latent_diffusion.Text2Image is Text2Image
    assert models.latent_diffusion.SuperResolution is SuperResolution
    assert models.latent_diffusion.convert_compvis_autoencoder is convert_compvis_autoencoder
    if not torch.cuda.is_available():
        for cls in (Text2Image, Face, SuperResolution):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cls(tiny=True)


def test_configs_are_copies_of_the_jax_ones():
    from perceptor_tpu.models.latent_diffusion import face as jface
    from perceptor_tpu.models.latent_diffusion import super_resolution as jsr

    pairs = [
        (ttext2image.TXT2IMG_UNET, jtext2image.TXT2IMG_UNET), (ttext2image.TINY_UNET, jtext2image.TINY_UNET),
        (tface.FACE_UNET, jface.FACE_UNET), (tface.TINY_FACE_UNET, jface.TINY_FACE_UNET),
        (tsr.SR_UNET, jsr.SR_UNET), (tsr.TINY_SR_UNET, jsr.TINY_SR_UNET),
        (first_stage.VQ_F4, jfirst_stage.VQ_F4), (first_stage.KL_F8, jfirst_stage.KL_F8),
        (first_stage.TINY_VQ, jfirst_stage.TINY_VQ), (tbert.BERTConfig(), jbert.BERTConfig()),
        (tbert.TINY_BERT, jbert.TINY_BERT),
    ]
    for port, jax_config in pairs:
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_config)
    assert (ttext2image.LINEAR_START, ttext2image.LINEAR_END, ttext2image.SCALE_FACTOR) == (
        jtext2image.LINEAR_START, jtext2image.LINEAR_END, jtext2image.SCALE_FACTOR)
    assert (tface.LINEAR_START, tface.LINEAR_END) == (jface.LINEAR_START, jface.LINEAR_END)


@pytest.mark.parametrize("name", ["text2image", "face", "super_resolution"])
def test_full_width_construction_on_the_meta_device(name):
    """The published configs build, and their attention sites have the
    head dims of PERF.md's kernel table; no weight is materialized."""
    with torch.device("meta"):
        if name == "text2image":
            unet = ADMUNet(ttext2image.TXT2IMG_UNET)
            bert = BERTEncoder(tbert.BERTConfig())
            count = sum(p.numel() for m in (unet, bert) for p in m.parameters())
        else:
            unet = ADMUNet(tface.FACE_UNET if name == "face" else tsr.SR_UNET)
            vq = VQModel(first_stage.VQ_F4)
            count = sum(p.numel() for m in (unet, vq) for p in m.parameters())
    if name == "text2image":
        sites = {(m.transformer_blocks[0].attn1.heads, m.transformer_blocks[0].attn1.dim_head)
                 for m in unet.modules() if isinstance(m, SpatialTransformer)}
        assert (8, 40) in sites and count > 1.2e9
    else:
        blocks = [m for m in unet.modules() if isinstance(m, AttentionBlock)]
        assert {m.qkv.weight.shape[1] // m.n_heads for m in blocks} == {32}
        if name == "face":
            assert {m.n_heads for m in blocks} >= {14}
