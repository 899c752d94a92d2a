"""The port's MiDaS models, wrapper and loss (`models/midas_depth.py`,
`losses/midas_depth.py`, `convert.dpt_state_dict_from_jax`,
`midas_net_state_dict_from_jax` and `midas_net_small_state_dict_from_jax`)
against the JAX package on the CPU, on the same weights (flax params
re-drawn from a seeded numpy rng) and the same inputs, JAX jitted, at the
TINY configs; dpt_large at 384px under `-m slow`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from perceptor_tpu.losses import midas_depth as jloss_lib
from perceptor_tpu.models import adabins_depth as jad
from perceptor_tpu.models import midas_depth as jmd
from perceptor_tpu.models import resnet as jresnet
from perceptor_tpu_torch import convert, losses, models
from perceptor_tpu_torch.losses.midas_depth import align_depths
from perceptor_tpu_torch.models import midas_depth as md
from perceptor_tpu_torch.ops.layers import pad_same

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)
from test_torch_adabins import (
    assert_round_trip, close, close_l2, images, random_params, random_state_dict)

# fp32 builds: max error over the max magnitude (RTOL); input gradients in
# relative L2 (GRAD_RTOL_L2); loss values relative (LOSS_RTOL)
RTOL = 1e-4
GRAD_RTOL_L2 = 1e-3
LOSS_RTOL = 1e-4
# bf16 builds: no two packages round bf16 alike (7 mantissa bits, ~4e-3 a
# rounding, after sums taken in each one's own order), and at these tiny
# random widths JAX's own bf16 build lies 0.7-4.7 % (depth) and 8-25 %
# (input gradient) in relative L2 from its fp32 build. The port's bf16
# build is held to the same fp32 reference: its relative L2 error at most
# BF16_FACTOR times JAX's bf16 error on the same input (measured on the
# CPU: at most 1.43 x for the depth, 2.08 x for the gradient, at tiny)
BF16_FACTOR = 2.5

# name -> (JAX module, port module, config) at the tiny configs
TINY_V21 = dict(backbone=jresnet.TINY_RESNEXT, features=8, image_size=64)
MODELS = {
    "tiny": (jmd.DPTDepthModel, md.DPTDepthModel, jmd.TINY, md.TINY),
    "tiny_hybrid": (jmd.DPTDepthModel, md.DPTDepthModel, jmd.TINY_HYBRID, md.TINY_HYBRID),
    "tiny_v21": (jmd.MidasNet, md.MidasNet, jmd.MidasNetConfig(**TINY_V21),
                 md.MidasNetConfig(backbone=md.TINY_RESNEXT, features=8, image_size=64)),
    "tiny_v21_small": (
        jmd.MidasNetSmall, md.MidasNetSmall,
        jmd.MidasNetSmallConfig(backbone=jmd._tiny_lite_encoder(), features=8, image_size=64),
        md.MidasNetSmallConfig(backbone=md._tiny_lite_encoder(), features=8, image_size=64)),
}
PORT_MAPS = {
    md.DPTDepthModel: convert.dpt_state_dict_from_jax,
    md.MidasNet: convert.midas_net_state_dict_from_jax,
    md.MidasNetSmall: convert.midas_net_small_state_dict_from_jax,
}
JAX_CONVERTERS = {
    md.DPTDepthModel: jmd.convert_dpt,
    md.MidasNet: jmd.convert_midas_net,
    md.MidasNetSmall: jmd.convert_midas_net_small,
}


def _params(name, seed):
    jcls, _, jcfg, _ = MODELS[name]
    return random_params(jcls(jcfg).init, jnp.zeros((1, 3, 64, 64)), seed=seed)


def _port(name, params, dtype=torch.float32):
    _, cls, _, cfg = MODELS[name]
    module = cls(cfg, dtype=dtype)
    module.load_state_dict(PORT_MAPS[cls](params, cfg))
    return module.eval()


@functools.lru_cache(maxsize=None)
def _jax_run(name, optimize):
    """JAX's depth (N, H, W) and the gradient of a weighted sum of it in the
    normalized images, 64px, batch 2, with `dtype` bf16 or fp32: (params,
    images, weights, depth, gradient). Cached: the fp32 run is also the bf16
    case's reference."""
    jcls, _, jcfg, _ = MODELS[name]
    jmodule = jcls(jcfg, dtype=jnp.bfloat16 if optimize else jnp.float32)
    params = _params(name, seed=1)
    x = images(2, (2, 3, 64, 64)) * 2.0 - 1.0
    weights = np.random.default_rng(3).standard_normal((2, 64, 64)).astype(np.float32)

    def jax_value(im):
        depth = jmodule.apply({"params": params}, im)
        return jnp.sum(depth * weights), depth

    (_, depth), grad = jax.jit(jax.value_and_grad(jax_value, has_aux=True))(jnp.asarray(x))
    return params, x, weights, np.asarray(depth, np.float32), np.asarray(grad, np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("optimize", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_model_and_input_gradient_match_jax(name, optimize):
    """The depth and its input gradient against JAX's: fp32 to RTOL and
    GRAD_RTOL_L2; bf16 against JAX's fp32 run, to BF16_FACTOR times JAX's
    own bf16 error."""
    params, x, weights, want, want_grad = _jax_run(name, False)
    assert float(np.abs(want).max()) > 0
    port = _port(name, params, torch.bfloat16 if optimize else torch.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    got = port(t)
    (grad,) = torch.autograd.grad((got * torch.from_numpy(weights)).sum(), t)
    assert got.shape == (2, 64, 64) and got.dtype == torch.float32
    got = got.detach().numpy()
    if not optimize:
        close(got, want, RTOL)
        close_l2(grad.numpy(), want_grad, GRAD_RTOL_L2)
        return
    *_, jax_bf16, jax_bf16_grad = _jax_run(name, True)
    assert _rel_l2(got, want) <= BF16_FACTOR * _rel_l2(jax_bf16, want)
    assert _rel_l2(grad.numpy(), want_grad) <= BF16_FACTOR * _rel_l2(jax_bf16_grad, want_grad)


def test_pad_same_matches_lax_same():
    """`pad_same` + a valid conv is lax's "SAME" conv at every kernel and
    stride the models use, at even and odd sizes (where the pads of a
    stride differ), and -inf-padded it is flax's "SAME" max pool on
    negative maps, where zero padding would win."""
    rng = np.random.default_rng(4)
    for size in (10, 11):
        x = rng.standard_normal((1, 2, size, size + 1)).astype(np.float32)
        for kernel in (3, 5, 7):
            w = rng.standard_normal((3, 2, kernel, kernel)).astype(np.float32)
            for stride in (1, 2):
                want = jax.lax.conv_general_dilated(
                    jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                    dimension_numbers=("NCHW", "OIHW", "NCHW"))
                got = torch.nn.functional.conv2d(
                    pad_same(torch.from_numpy(x), kernel, stride), torch.from_numpy(w),
                    stride=stride)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        negative = -1.0 - np.abs(x)
        want = fnn.max_pool(jnp.asarray(negative.transpose(0, 2, 3, 1)), (3, 3), strides=(2, 2),
                            padding="SAME").transpose(0, 3, 1, 2)
        got = torch.nn.functional.max_pool2d(
            pad_same(torch.from_numpy(negative), 3, 2, value=float("-inf")), 3, stride=2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pad_same(torch.zeros(1, 1, 384, 384), 7, 2).shape[-2:] == (389, 389)


def test_hybrid_stem_matches_jax_at_unequal_pads():
    """The ResNetV2 stem at 40 x 56: the 7x7/2 StdConv pads 2 before and 3
    after, the max pool and the stride-2 3x3 StdConvs 0 and 1."""
    jstem = jmd.ResNetV2Stem(jmd.TINY_HYBRID.stem)
    x = images(5, (2, 3, 40, 56)) * 2.0 - 1.0
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    params = _params("tiny_hybrid", seed=6)
    want = jax.jit(lambda p, x: jstem.apply({"params": p}, x))(params["backbone"]["stem"], nhwc)
    port = _port("tiny_hybrid", params).pretrained.model.patch_embed.backbone
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape[-2:]) for g in got] == [(10, 14), (5, 7), (3, 4)]
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("name", ["tiny", "tiny_v21"])
def test_wrapper_resizes_normalizes_and_negates_like_jax(name):
    """`MidasDepth(name, optimize=False)` at 48 x 40 (resized to 64):
    (N, 1, 64, 64), <= 0, and JAX's `forward_fn` on the same weights; DPT's
    normalization (0.5) and v2.1's (ImageNet)."""
    params = _params(name, seed=7)
    jmodel = jmd.MidasDepth(name, optimize=False)
    x = images(8, (2, 3, 48, 40))
    want = jax.jit(jmodel.forward_fn)(params, jnp.asarray(x))
    model = models.MidasDepth(name, optimize=False, device="cpu")
    _, cls, _, cfg = MODELS[name]
    model.load_state_dict(PORT_MAPS[cls](params, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 1, 64, 64) and float(got.max()) <= 0.0
    close(got.numpy(), want)


def test_wrapper_names_configs_and_memo():
    """Every name JAX takes resolves to JAX's config; others raise; the
    wrapper and the loss share one memoized network; a generator seed is
    not memoized."""
    for name in md.CHECKPOINT_NAMES + md.TEST_NAMES:
        cls, cfg, mean, std = md._model(name)
        if cls is md.DPTDepthModel:
            assert repr(cfg) == repr(jmd.CONFIGS[name]) and mean == (0.5, 0.5, 0.5)
        else:
            np.testing.assert_array_equal(mean, jad.IMAGENET_MEAN)
    assert repr(md.MidasNetConfig()) == repr(jmd.MidasNetConfig())
    assert repr(md.MidasNetSmallConfig()) == repr(jmd.MidasNetSmallConfig())
    with pytest.raises(ValueError, match="not implemented"):
        models.MidasDepth("dpt_swin", device="cpu")
    model = models.MidasDepth("tiny", device="cpu")
    assert losses.MidasDepth("tiny", device="cpu").model is model
    assert model.module.pretrained.model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert model.module.scratch.refinenet1.out_conv.bias.dtype == torch.float32
    small = models.MidasDepth("tiny_v21_small", device="cpu")
    assert small.module.pretrained.layer1[0].weight.dtype == torch.float32  # fp32 trunk
    assert small.module.scratch.layer1_rn.weight.dtype == torch.bfloat16
    hybrid = models.MidasDepth("tiny_hybrid", device="cpu")
    stem = hybrid.module.pretrained.model.patch_embed.backbone
    assert stem.stem["conv"].weight.dtype == torch.float32  # standardized in fp32
    generator = torch.Generator().manual_seed(0)
    assert (models.MidasDepth("tiny", device="cpu", seed=generator)
            is not models.MidasDepth("tiny", device="cpu", seed=generator))


def test_depth_exports_resolve():
    """The depth wrappers and the loss resolve by name; the port no longer
    promises an `AestheticVisualAssessment` model, which the JAX package
    has only as a loss."""
    from perceptor_tpu_torch.models import adabins_depth

    assert models.MidasDepth is md.MidasDepth and losses.MidasDepth.__module__.endswith(
        "losses.midas_depth")
    assert models.AdaBinsDepth is adabins_depth.AdaBinsDepth
    with pytest.raises(AttributeError, match="has no attribute"):
        models.AestheticVisualAssessment


def test_align_depths_takes_numpys_median_of_an_even_count():
    """An even count per image, where `torch.median` (the lower middle value)
    would differ from `jnp.median` (the mean of the two)."""
    d = np.random.default_rng(9).standard_normal((2, 1, 4, 6)).astype(np.float32)
    got = align_depths(torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(jloss_lib.align_depths(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-6)
    flat = torch.from_numpy(d).reshape(2, -1)
    assert not torch.allclose(flat.median(dim=1).values, flat.quantile(0.5, dim=1))
    np.testing.assert_allclose(np.median(got.numpy().reshape(2, -1), axis=1), 0.0, atol=1e-6)
    np.testing.assert_allclose(align_depths(torch.from_numpy(3.7 * d - 1.2)).numpy(),
                               got.numpy(), atol=1e-5)


def test_loss_matches_jax(monkeypatch):
    """The loss to `add_images_` of one image on another, its gradient, and
    the same value to `add_depths_` of an affine map of that depth; zero on
    the target image itself; the JAX loss on the fp32 "tiny" model with the
    same weights."""
    params = _params("tiny", seed=10)
    jloss = jloss_lib.MidasDepth("tiny")
    jloss.model = jmd.MidasDepth("tiny", optimize=False)
    monkeypatch.setattr(jloss.model, "params", params)
    loss = losses.MidasDepth("tiny", optimize=False, device="cpu")
    loss.model.load_state_dict(convert.dpt_state_dict_from_jax(params, md.TINY))
    target, other = images(11, (1, 3, 64, 64)), images(12, (1, 3, 64, 64))
    jloss.add_images_(jnp.asarray(target))
    want, want_grad = jax.jit(jax.value_and_grad(jloss.forward))(jnp.asarray(other))
    loss.add_images_(torch.from_numpy(target))
    x = torch.from_numpy(other).requires_grad_(True)
    value = loss(x)
    (grad,) = torch.autograd.grad(value, x)
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=LOSS_RTOL)
    close_l2(grad.numpy(), want_grad)

    with torch.no_grad():
        depths = loss.model(torch.from_numpy(target))
        loss.add_depths_(5.0 * depths + 2.0)
        np.testing.assert_allclose(float(loss(torch.from_numpy(other))), float(want),
                                   rtol=LOSS_RTOL)
        loss.add_images_(torch.from_numpy(target))
        assert float(loss(torch.from_numpy(target))) < 1e-6
        with pytest.raises(ValueError, match="does not match"):
            loss.add_depths_(torch.zeros(1, 1, 32, 32))(torch.from_numpy(other))
    with pytest.raises(ValueError, match="no target"):
        losses.MidasDepth("tiny", optimize=False, device="cpu")(torch.from_numpy(other))


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_round_trips_through_jax_converters(name):
    """The port's state_dict through JAX's own `convert_dpt` /
    `convert_midas_net` / `convert_midas_net_small` gives the flax tree,
    which the port's map takes back to the same state_dict."""
    jcls, cls, jcfg, cfg = MODELS[name]
    sd = random_state_dict(cls(cfg), seed=13)
    params = JAX_CONVERTERS[cls](sd, jcfg)
    back = PORT_MAPS[cls](params, cfg)
    want_tree = jax.eval_shape(jcls(jcfg).init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 3, 64, 64)))["params"]
    assert_round_trip(sd, params, back, want_tree)


@pytest.mark.slow
def test_dpt_large_matches_jax_at_384():
    """dpt_large at its published widths and 384px, fp32, batch 1."""
    jmodule = jmd.DPTDepthModel(jmd.CONFIGS["dpt_large"])
    params = random_params(jmodule.init, jnp.zeros((1, 3, 384, 384)), seed=14)
    x = images(15, (1, 3, 384, 384)) * 2.0 - 1.0
    want = jax.jit(lambda p, x: jmodule.apply({"params": p}, x))(params, jnp.asarray(x))
    port = md.DPTDepthModel(md.CONFIGS["dpt_large"])
    port.load_state_dict(convert.dpt_state_dict_from_jax(params, md.CONFIGS["dpt_large"]))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    close(got.numpy(), want)
