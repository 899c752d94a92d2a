"""The port's models against the JAX package at TINY sizes, in fp32 on the
CPU, on the same weights: flax params (every leaf re-drawn from a seeded
numpy rng, so biases and norm affines are exercised too) carried across
with `perceptor_tpu_torch.convert`. Also the weight round trips through the
JAX package's own diffusers/open_clip converters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.models.clip import convert as jclip_convert
from perceptor_tpu.models.clip.model import CLIP as JCLIP
from perceptor_tpu.models.stable_diffusion import AutoencoderKL as JVAE
from perceptor_tpu.models.stable_diffusion import UNet as JUNet
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu.models.stable_diffusion import convert as jsd_convert
from perceptor_tpu_torch import convert
from perceptor_tpu_torch.guided_step import TINY_CLIP
from perceptor_tpu_torch.models.clip.model import CLIP
from perceptor_tpu_torch.models.stable_diffusion import config as sd_config
from perceptor_tpu_torch.models.stable_diffusion.unet import UNet, timestep_embedding
from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL

torch.set_num_threads(2)

# fp32 model parity, within the README's 2e-5..5e-4 bar
UNET_ATOL = 1e-4
VAE_ATOL = 5e-5
CLIP_ATOL = 2e-5


def _random_params(init_fn, *args, seed):
    """Flax params of the shapes `init_fn` makes (traced with eval_shape, so
    nothing compiles): kernels ~ N(0, 1/fan_in), norm scales ~ N(1, 0.1),
    biases and other vectors ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(out.astype(np.float32))

    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def unet_pair():
    cfg = jsd_config.TINY_UNET
    params = _random_params(
        JUNet(cfg).init, jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 8, cfg.context_dim)), seed=0,
    )
    module = UNet(sd_config.TINY_UNET)
    module.load_state_dict(convert.unet_state_dict_from_jax(params, cfg))
    return params, module.eval()


@pytest.fixture(scope="module")
def vae_pair():
    cfg = jsd_config.TINY_VAE
    params = _random_params(JVAE(cfg).init, jnp.zeros((1, 3, 16, 16)), seed=1)
    module = AutoencoderKL(sd_config.TINY_VAE)
    module.load_state_dict(convert.vae_state_dict_from_jax(params, cfg))
    return params, module.eval()


@pytest.fixture(scope="module")
def clip_pair():
    params = _random_params(
        JCLIP(TINY_CLIP).init, jnp.zeros((1, 3, 32, 32)),
        jnp.zeros((1, TINY_CLIP.context_length), jnp.int32), seed=2,
    )
    module = CLIP(TINY_CLIP)
    module.load_state_dict(convert.clip_state_dict_from_jax(params, TINY_CLIP))
    return params, module.eval()


def test_timestep_embedding_matches_jax():
    from perceptor_tpu.models.stable_diffusion.unet import timestep_embedding as j_emb

    t = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            timestep_embedding(torch.from_numpy(t), dim).numpy(),
            _np(j_emb(jnp.asarray(t), dim)), atol=1e-5,
        )


def test_unet_forward_and_latent_grad_match_jax(unet_pair):
    params, module = unet_pair
    rng = np.random.default_rng(10)
    latents = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    context = rng.standard_normal((2, 8, 32)).astype(np.float32)
    probe = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = np.array([800.0, 10.0], np.float32)

    def j_loss(x):
        out = JUNet(jsd_config.TINY_UNET).apply({"params": params}, x, jnp.asarray(t),
                                                jnp.asarray(context))
        return jnp.sum(out * probe), out

    (_, j_out), j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jnp.asarray(latents)
    )
    x = torch.from_numpy(latents).requires_grad_(True)
    out = module(x, torch.from_numpy(t), torch.from_numpy(context))
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(j_out), atol=UNET_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), _np(j_grad), atol=UNET_ATOL)


def test_vae_decode_matches_jax(vae_pair):
    params, module = vae_pair
    latents = np.random.default_rng(11).standard_normal((1, 4, 8, 8)).astype(np.float32)
    want = jax.jit(lambda p, z: JVAE(jsd_config.TINY_VAE).apply({"params": p}, z,
                                                               method="decode"))(
        params, jnp.asarray(latents)
    )
    with torch.no_grad():
        got = module.decode(torch.from_numpy(latents))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=VAE_ATOL)


def test_vae_encode_matches_jax(vae_pair):
    params, module = vae_pair
    images = np.random.default_rng(12).uniform(size=(1, 3, 16, 16)).astype(np.float32)
    jvae = JVAE(jsd_config.TINY_VAE)
    j_mean, j_logvar = jax.jit(lambda p, x: jvae.apply({"params": p}, x, method="moments"))(
        params, jnp.asarray(images)
    )
    want = j_mean * jsd_config.TINY_VAE.scaling_factor
    with torch.no_grad():
        got = module.encode(torch.from_numpy(images))
        mean, logvar = module.moments(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=VAE_ATOL)
    np.testing.assert_allclose(mean.numpy(), _np(j_mean), atol=VAE_ATOL)
    np.testing.assert_allclose(logvar.numpy(), _np(j_logvar), atol=VAE_ATOL)
    sampled = module.encode(torch.from_numpy(images), torch.Generator().manual_seed(0))
    assert sampled.shape == got.shape and not torch.equal(sampled, got)


def test_vae_level_attention_matches_jax():
    """Taming-style per-level AttnBlocks (encoder level 1, decoder level 0),
    which the SD configs leave empty."""
    cfg = dataclasses.replace(
        jsd_config.TINY_VAE, encoder_attn_levels=(1,), decoder_attn_levels=(0,)
    )
    params = _random_params(JVAE(cfg).init, jnp.zeros((1, 3, 16, 16)), seed=4)
    module = AutoencoderKL(sd_config.VAEConfig(**dataclasses.asdict(cfg))).eval()
    module.load_state_dict(convert.vae_state_dict_from_jax(params, cfg))
    rng = np.random.default_rng(14)
    latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    images = rng.uniform(size=(1, 3, 16, 16)).astype(np.float32)
    jvae = JVAE(cfg)
    want_images = jax.jit(lambda p, z: jvae.apply({"params": p}, z, method="decode"))(
        params, jnp.asarray(latents))
    want_mean, _ = jax.jit(lambda p, x: jvae.apply({"params": p}, x, method="moments"))(
        params, jnp.asarray(images))
    with torch.no_grad():
        got_images = module.decode(torch.from_numpy(latents))
        got_mean, _ = module.moments(torch.from_numpy(images))
    np.testing.assert_allclose(got_images.numpy(), _np(want_images), atol=VAE_ATOL)
    np.testing.assert_allclose(got_mean.numpy(), _np(want_mean), atol=VAE_ATOL)


def test_clip_encode_image_matches_jax(clip_pair):
    params, module = clip_pair
    images = np.random.default_rng(13).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = jax.jit(lambda p, x: JCLIP(TINY_CLIP).apply({"params": p}, x,
                                                       method=JCLIP.encode_image))(
        params, jnp.asarray(images)
    )
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=CLIP_ATOL)


def _assert_same_tree(got, want):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want), set(flat_got) ^ set(flat_want)
    for path, value in flat_want.items():
        np.testing.assert_array_equal(_np(flat_got[path]), _np(value), err_msg=str(path))


def test_unet_weights_round_trip_through_diffusers_converter(unet_pair):
    params, module = unet_pair
    _assert_same_tree(jsd_convert.unet_from_diffusers(module.state_dict(), jsd_config.TINY_UNET),
                      params)


def test_vae_weights_round_trip_through_diffusers_converter(vae_pair):
    params, module = vae_pair
    _assert_same_tree(jsd_convert.vae_from_diffusers(module.state_dict(), jsd_config.TINY_VAE),
                      params)


def _openclip_text_state_dict(text, layers):
    """The JAX text tower in open_clip keys (from_openclip reads it too)."""
    sd = {
        "token_embedding.weight": _np(text["token_embedding"]),
        "positional_embedding": _np(text["positional_embedding"]),
        "text_projection": _np(text["text_projection"]),
        "ln_final.weight": _np(text["ln_final"]["scale"]),
        "ln_final.bias": _np(text["ln_final"]["bias"]),
    }
    for i in range(layers):
        block, prefix = text["transformer"][f"resblocks_{i}"], f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{prefix}.{ln}.weight"] = _np(block[ln]["scale"])
            sd[f"{prefix}.{ln}.bias"] = _np(block[ln]["bias"])
        attn = block["attn"]
        sd[f"{prefix}.attn.in_proj_weight"] = np.concatenate(
            [_np(attn[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")])
        sd[f"{prefix}.attn.in_proj_bias"] = np.concatenate(
            [_np(attn[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
        for src, dst in (("out_proj", "attn.out_proj"), ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
            p = attn[src] if src == "out_proj" else block["mlp"][src]
            sd[f"{prefix}.{dst}.weight"] = _np(p["kernel"]).T
            sd[f"{prefix}.{dst}.bias"] = _np(p["bias"])
    return sd


def test_clip_visual_weights_round_trip_through_openclip_converter(clip_pair):
    params, module = clip_pair
    sd = dict(module.state_dict())
    sd.update(_openclip_text_state_dict(params["text"], TINY_CLIP.text_layers))
    sd["logit_scale"] = _np(params["logit_scale"])
    converted = jclip_convert.from_openclip(sd, TINY_CLIP)
    _assert_same_tree(converted["visual"], params["visual"])
    # the text tower went through the same rules both ways
    _assert_same_tree(converted["text"], params["text"])
