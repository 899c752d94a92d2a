"""The port's FLOP counter (perceptor_tpu_torch/utils/flops.py) against the
JAX package's: the TINY guided step's model FLOPs, the resize and cutout
products, and the per-op breakdown on toys; `mfu` against the card table."""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.models.clip.model import CLIP as JCLIP
from perceptor_tpu.models.stable_diffusion import AutoencoderKL as JVAE
from perceptor_tpu.models.stable_diffusion import UNet as JUNet
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu.models.velocity_diffusion import configs as jvelocity_configs
from perceptor_tpu.models.velocity_diffusion.net import VDiffusionUNet as JVNet
from perceptor_tpu.ops.resize import resize as jresize
from perceptor_tpu.transforms.cutouts import random_cutouts as jrandom_cutouts
from perceptor_tpu.utils import flops as jflops
from perceptor_tpu_torch import guided_step
from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion
tattention = importlib.import_module("perceptor_tpu_torch.ops.attention")
from perceptor_tpu_torch.ops.resize import resize as tresize
from perceptor_tpu_torch.transforms import random_cutouts as trandom_cutouts
from perceptor_tpu_torch.utils import flops

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)
from test_torch_guided_step import _jax_guided_step




def _shapes(init_fn, *args):
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)["params"]


def test_tiny_guided_step_model_flops_match_jax():
    """Forward and input gradient of the TINY guided step: the port's count
    under the plain route against JAX's `count_model_flops` of bench.py's
    step at the same configs (traced on shapes alone). They differ by one
    named term: JAX counts a stride-2 convolution's input gradient over the
    dilated grid, 4 times its forward, torch as its forward, so each UNet
    downsampler adds 3 forwards to JAX's count."""
    clip_cfg = guided_step.TINY_CLIP
    params = (
        _shapes(JUNet(jsd_config.TINY_UNET).init, jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
                jnp.zeros((1, 8, 32))),
        _shapes(JVAE(jsd_config.TINY_VAE).init, jnp.zeros((1, 3, 16, 16))),
        _shapes(JCLIP(clip_cfg).init, jnp.zeros((1, 3, 32, 32)),
                jnp.zeros((1, clip_cfg.context_length), jnp.int32)),
    )
    step = guided_step.build("tiny", device="cpu", seed=0)
    latents, context = step.initial_inputs()
    want = jflops.count_model_flops(
        _jax_guided_step, *params, jax.ShapeDtypeStruct(tuple(latents.shape), jnp.float32),
        jax.ShapeDtypeStruct(tuple(context.shape), jnp.float32),
        jax.ShapeDtypeStruct((1, clip_cfg.embed_dim), jnp.float32))
    got = flops.count_model_flops(step.guided_denoise_step, latents, context)
    size, gap = latents.shape[-1], 0
    for ch in jsd_config.TINY_UNET.block_channels[:-1]:
        size //= 2
        gap += 3 * 2 * (ch * size * size) * (ch * 3 * 3)
    assert got > 0 and want - got == gap, (got, want, gap)


def test_tiny_velocity_unet_model_flops_equal_jax():
    """The TINY v-diffusion UNet's forward and input gradient, its bilinear
    upsampling included (JAX counts `jax.image.resize`'s contractions):
    the same count in both packages."""
    cfg = jvelocity_configs.MODEL_CONFIGS["tiny"]
    shape = (1, 3, *cfg.image_size)
    net = JVNet(cfg)
    params = _shapes(net.init, jnp.zeros(shape), jnp.zeros((1,)))

    def jax_grad(params, x, t):
        return jax.grad(lambda x: net.apply({"params": params}, x, t).sum())(x)

    want = jflops.count_model_flops(jax_grad, params, jax.ShapeDtypeStruct(shape, jnp.float32),
                                    jax.ShapeDtypeStruct((1,), jnp.float32))
    module = VelocityDiffusion("tiny", fp16=False, device="cpu").module

    def port_grad():
        xs = torch.zeros(shape, requires_grad=True)
        torch.autograd.grad(module(xs, torch.zeros(1)).sum(), xs)

    assert flops.count_model_flops(port_grad) == want > 0


def test_resize_and_cutout_products_count_as_in_jax():
    """The antialiased resize's two matrix products and the cutouts' two
    einsums are counted, as JAX counts their dot_generals."""
    images = np.random.default_rng(0).random((1, 3, 64, 48)).astype(np.float32)
    want = jflops.count_flops(lambda x: jresize(x, out_shape=(20, 24)), jnp.asarray(images))
    got = flops.count_flops(lambda: tresize(torch.from_numpy(images), out_shape=(20, 24)))
    assert got == want > 0
    want = jflops.count_flops(
        lambda x: jrandom_cutouts(x, jax.random.PRNGKey(0), 5, cut_size=16, cut_pow=0.5),
        jnp.asarray(images))
    got = flops.count_flops(lambda: trandom_cutouts(
        torch.from_numpy(images), torch.Generator().manual_seed(0), 5, cut_size=16,
        cut_pow=0.5))
    assert got == want > 0


def test_count_flops_by_op_on_a_conv_a_linear_and_an_attention():
    gen = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3).requires_grad_(False)
    linear = torch.nn.Linear(32, 16)
    x = torch.randn((2, 3, 10, 10), generator=gen)
    tokens = torch.randn((4, 5, 32), generator=gen)
    q, k, v = (torch.randn((1, 2, 16, 8), generator=gen) for _ in range(3))
    conv_flops = 2 * (2 * 8 * 8 * 8) * (3 * 3 * 3)
    linear_flops = 2 * 20 * 32 * 16
    product = 2 * 1 * 2 * 16 * 16 * 8  # q k^T, and p v

    def toys():
        conv(x)
        linear(tokens)
        tattention.dot_product_attention(q, k, v)

    by_op = flops.count_flops_by_op(toys)
    assert sorted(by_op.values()) == sorted([(conv_flops, 1), (linear_flops, 1),
                                             (product, 1), (product, 1)]), by_op
    assert any(label.startswith("convolution") for label in by_op)
    assert flops.count_flops(toys) == conv_flops + linear_flops + 2 * product

    # a frozen weight gets no gradient: the backward counts the input's only
    def conv_backward():
        conv(x.clone().requires_grad_(True)).sum().backward()

    assert flops.count_flops(conv_backward) == 2 * conv_flops
    conv.requires_grad_(True)
    assert flops.count_flops(conv_backward) == 3 * conv_flops


def test_model_flops_trace_sends_every_attention_to_the_plain_route(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tattention.flash_route(1024, 1024)
    calls = []
    monkeypatch.setattr(tattention, "flash_attention", lambda *a, **k: calls.append(1))
    q = torch.randn((1, 1, 8, 8))
    with tattention.model_flops_trace():
        assert not tattention.flash_route(1024, 1024)
        out = tattention.attention(q, q, q, use_flash=True)
    assert not calls and out.shape == q.shape
    assert tattention.flash_route(1024, 1024)


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12), ("NVIDIA H100 NVL", 835e12),
])
def test_mfu_against_the_card_table(name, peak):
    assert flops.card_peaks(name)[0] == peak
    assert flops.mfu(peak / 2, 1.0, flops.card_peaks(name)[0]) == pytest.approx(0.5)
    assert flops.mfu(3e12, 0.01, peak) == pytest.approx(3e14 / peak)
    with pytest.raises(ValueError):
        flops.mfu(1e12, 0.0, peak)
    # no TPU peak is the port's
    assert "197" not in inspect.getsource(flops)
