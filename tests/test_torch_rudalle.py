"""The port's ruDALL-E drawer (`drawers/rudalle.py`: the Haar DWT, the
Gumbel VQGAN over the SD VAE's encoder / decoder, `BruteRuDalle`) and its
key maps against the JAX package at tiny size, on the CPU.

Both packages hold the same weights: the JAX module's param tree, every
leaf re-drawn from a seeded numpy rng, carried across with
`convert.rudalle_state_dict_from_jax`. fp32 runs are held to RTOL of the
reference's largest magnitude; the bf16 drawer's images to BF16_RTOL
relative L2, its gradient to BF16_FACTOR times JAX's own bf16 error. The
encode is compared without Gumbel noise: JAX's key and the port's
generator draw different streams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.drawers import rudalle as jrudalle
from perceptor_tpu_torch import convert, drawers
from perceptor_tpu_torch.core.init import random_module
from perceptor_tpu_torch.drawers import rudalle
from perceptor_tpu_torch.models.latent_diffusion.first_stage import convert_gumbel_vqgan

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

RTOL = 1e-4
BF16_RTOL = 3e-2
# a bf16 gradient against JAX's fp32 one: within this factor of JAX's own
# bf16 error on the same input (no two packages round bf16 alike)
BF16_FACTOR = 2.5
# the tiny config with taming's per-level attention, as GUMBEL_F8 has it
TINY_ATTN = dataclasses.replace(rudalle.TINY_GUMBEL, encoder_attn_levels=(1,),
                                decoder_attn_levels=(0,))
EMBED_DIM, N_EMBED = 16, 64


def fill_params(params, seed):
    """Every leaf re-drawn: weights N(0, 1 / fan_in), biases N(0, 0.1),
    norm scales near 1."""
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


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rtol, err


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _images(seed, shape=(2, 3, 32, 32)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_haar_dwt_and_idwt_match_jax_and_round_trip():
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(np.float32)
    low, high = rudalle.haar_dwt(torch.from_numpy(x))
    jlow, jhigh = jrudalle.haar_dwt(jnp.asarray(x))
    close(low, jlow, 1e-6)
    close(high, jhigh, 1e-6)
    close(rudalle.haar_idwt(low, high), x, 1e-6)
    # the [[a, c], [b, d]] block layout, from bands JAX did not make
    rng = np.random.default_rng(1)
    ll, bands = rng.standard_normal((2, 3, 8, 8)), rng.standard_normal((2, 3, 3, 8, 8))
    ll, bands = ll.astype(np.float32), bands.astype(np.float32)
    close(rudalle.haar_idwt(torch.from_numpy(ll), torch.from_numpy(bands)),
          jrudalle.haar_idwt(jnp.asarray(ll), jnp.asarray(bands)), 1e-6)


def _pair(cfg, dwt, seed):
    """The JAX GumbelVQGAN (fp32) with re-drawn params, and the port's
    with the same weights."""
    jmodule = jrudalle.GumbelVQGAN(cfg, embed_dim=EMBED_DIM, n_embed=N_EMBED, dwt=dwt)
    params = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"]
    params = fill_params(params, seed)
    config = rudalle.GumbelConfig(cfg, embed_dim=EMBED_DIM, n_embed=N_EMBED, dwt=dwt)
    port = random_module(rudalle.GumbelVQGAN, config, torch.device("cpu"),
                         torch.Generator().manual_seed(0), torch.float32)
    port.load_state_dict(convert.rudalle_state_dict_from_jax(np_tree(params), cfg))
    return jmodule, params, port


def _codes(quant, embed):
    """Each latent's codebook index, by its nearest codebook row."""
    flat = np.asarray(quant).transpose(0, 2, 3, 1).reshape(-1, embed.shape[1])
    return ((flat[:, None] - embed[None]) ** 2).sum(-1).argmin(-1)


@pytest.mark.parametrize("cfg,dwt", [(rudalle.TINY_GUMBEL, False), (TINY_ATTN, False),
                                     (TINY_ATTN, True)], ids=["tiny", "attn", "attn_dwt"])
def test_gumbel_vqgan_matches_jax(cfg, dwt):
    """fp32: the deterministic encode's codes exactly and its latents, the
    decode, and the straight-through input gradient of decode(encode(x))."""
    jmodule, params, port = _pair(cfg, dwt, seed=3)
    xs = _images(4) * 2 - 1
    want_quant = jax.jit(lambda p, x: jmodule.apply({"params": p}, x, method=jmodule.encode))(
        params, jnp.asarray(xs))
    quant = port.encode(torch.from_numpy(xs))
    embed = np.asarray(params["embed"])
    np.testing.assert_array_equal(_codes(quant, embed), _codes(want_quant, embed))
    close(quant, want_quant)
    images = port.decode(quant)
    want = jax.jit(lambda p, q: jmodule.apply({"params": p}, q, method=jmodule.decode))(
        params, want_quant)
    assert images.shape == ((2, 3, 64, 64) if dwt else (2, 3, 32, 32))
    close(images, want)

    probe = np.random.default_rng(5).standard_normal(images.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jmodule.apply({"params": p}, x) * probe)

    want_grad = jax.jit(jax.grad(jloss, argnums=1))(params, jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_(True)
    (port(x) * torch.from_numpy(probe)).sum().backward()
    assert float(x.grad.abs().max()) > 0
    close(x.grad, want_grad)


def test_gumbel_noise_draws_from_the_generator():
    _, _, port = _pair(rudalle.TINY_GUMBEL, False, seed=6)
    xs = torch.from_numpy(_images(7) * 2 - 1)
    first = port.encode(xs, torch.Generator().manual_seed(1))
    again = port.encode(xs, torch.Generator().manual_seed(1))
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    assert not torch.equal(first, port.encode(xs))
    assert torch.equal(port.encode(xs), port.encode(xs))


def test_brute_rudalle_matches_the_jax_drawer():
    """The bf16 drawers at tiny size: the port, given the JAX drawer's
    weights and latents, decodes them and takes an image loss's gradient;
    its own encode is the latent it starts from."""
    images = _images(8, (1, 3, 32, 32))
    jdrawer = jrudalle.BruteRuDalle(jnp.asarray(images), tiny=True)
    jdrawer.model_params = fill_params(jdrawer.model_params, 9)
    jdrawer.params = jdrawer.encode(jnp.asarray(images))
    drawer = drawers.BruteRuDalle(images, tiny=True, device="cpu")
    drawer.model.load_state_dict(
        convert.rudalle_state_dict_from_jax(np_tree(jdrawer.model_params), rudalle.TINY_GUMBEL))
    assert drawer.model.quantize.embed.weight.dtype == torch.float32
    assert drawer.model.quantize.proj.weight.dtype == torch.float32
    assert drawer.model.encoder.conv_in.weight.dtype == torch.bfloat16
    drawer.replace_(torch.from_numpy(np.array(jdrawer.params)))
    assert rel_l2(drawer.synthesize().detach(), jdrawer.synthesize()) <= BF16_RTOL

    # the gradient: 8 % of the tiny decoder's pixels sit on the clip to
    # [-1, 1], so bf16 rounding moves whole pixels in or out of it; held to
    # JAX's fp32 gradient within BF16_FACTOR of JAX's own bf16 error
    target = _images(10, (1, 3, 32, 32))
    fp32 = jrudalle.GumbelVQGAN(rudalle.TINY_GUMBEL, embed_dim=EMBED_DIM, n_embed=N_EMBED)

    def jgrad(module):
        return jax.jit(jax.grad(lambda q: jnp.square(module.apply(
            {"params": jdrawer.model_params}, q, method=module.decode) - target).mean()))(
                jdrawer.params)

    want, jax_bf16 = jgrad(fp32), jgrad(jdrawer.module)
    torch.square(drawer.synthesize() - torch.from_numpy(target)).mean().backward()
    assert rel_l2(drawer.quant.grad, want) <= BF16_FACTOR * rel_l2(jax_bf16, want)
    assert [name for name, _ in drawer.named_parameters()] == ["quant"]
    # the drawer encodes its init images at construction
    fresh = drawers.BruteRuDalle(images, tiny=True, device="cpu")
    torch.testing.assert_close(fresh.quant.detach(), fresh.encode(torch.from_numpy(images)))
    dwt = drawers.BruteRuDalle(images, tiny=True, dwt=True, device="cpu")
    out = dwt.synthesize().detach()
    assert out.shape == (1, 3, 64, 64) and float(out.min()) >= 0 and float(out.max()) <= 1


def _taming_state_dict(cfg, dwt, seed):
    """A taming-named GumbelVQ state_dict of `cfg`'s shapes, values random:
    the port module's state_dict renamed by hand, under "model." as the DWT
    files have it."""
    config = rudalle.GumbelConfig(cfg, embed_dim=EMBED_DIM, n_embed=N_EMBED, dwt=dwt)
    module = rudalle.GumbelVQGAN(config)
    gen = torch.Generator().manual_seed(seed)
    n_levels = len(cfg.channel_mults)
    renames = {"conv_shortcut": "nin_shortcut", "group_norm": "norm", "to_q": "q", "to_k": "k",
               "to_v": "v", "to_out": "proj_out"}
    sd = {}
    for key, value in module.state_dict().items():
        value = torch.randn(value.shape, generator=gen)
        parts = key.split(".")
        if parts[0] in ("encoder", "decoder") and parts[1] in ("down_blocks", "up_blocks"):
            down = parts[1] == "down_blocks"
            level = int(parts[2]) if down else n_levels - 1 - int(parts[2])
            head = f"{parts[0]}.{'down' if down else 'up'}.{level}"
            if parts[3] in ("resnets", "attentions"):
                kind = "block" if parts[3] == "resnets" else "attn"
                key = f"{head}.{kind}.{parts[4]}.{renames.get(parts[5], parts[5])}.{parts[-1]}"
            else:
                key = f"{head}.{parts[3][:-2]}.conv.{parts[-1]}"
        elif parts[0] in ("encoder", "decoder") and parts[1] == "mid_block":
            if parts[2] == "resnets":
                key = (f"{parts[0]}.mid.block_{int(parts[3]) + 1}."
                       f"{renames.get(parts[4], parts[4])}.{parts[-1]}")
            else:
                key = f"{parts[0]}.mid.attn_1.{renames[parts[4]]}.{parts[-1]}"
        elif parts[0] in ("encoder", "decoder") and parts[1] == "conv_norm_out":
            key = f"{parts[0]}.norm_out.{parts[-1]}"
        if value.ndim == 2 and ".attn" in key:
            value = value[:, :, None, None]
        sd[f"model.{key}"] = value
    return sd


@pytest.mark.parametrize("dwt", [False, True], ids=["plain", "dwt"])
def test_taming_key_map_matches_the_jax_converter(dwt):
    """convert_gumbel_vqgan gives the tensors that JAX's converter (after
    the drawer's "model." strip) followed by rudalle_state_dict_from_jax
    gives, under every one of the port module's names."""
    taming = _taming_state_dict(TINY_ATTN, dwt, seed=11)
    got = convert_gumbel_vqgan({"state_dict": taming}, TINY_ATTN)
    stripped = {k.removeprefix("model."): v.numpy() for k, v in taming.items()}
    want = convert.rudalle_state_dict_from_jax(
        jrudalle.convert_gumbel_vqgan(stripped, TINY_ATTN), TINY_ATTN)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    config = rudalle.GumbelConfig(TINY_ATTN, embed_dim=EMBED_DIM, n_embed=N_EMBED, dwt=dwt)
    rudalle.GumbelVQGAN(config).load_state_dict(got)
