"""The port's EfficientNet trunk and AdaBins (`models/adabins_depth.py`,
`convert.efficientnet_state_dict_from_jax` and
`convert.adabins_state_dict_from_jax`) against the JAX package on the CPU,
on the same weights (flax params re-drawn from a seeded numpy rng, biases
and BatchNorm statistics included) and the same inputs, JAX jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.models import adabins_depth as jad
from perceptor_tpu.ops.resize import resize as jresize
from perceptor_tpu_torch import convert, models
from perceptor_tpu_torch.core.init import init_random_
from perceptor_tpu_torch.models import adabins_depth as ad
from perceptor_tpu_torch.models.midas_depth import _tiny_lite_encoder

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides: max error over the max magnitude
RTOL = 1e-4
# input gradients, relative L2
GRAD_RTOL_L2 = 1e-3
# 64 and 96 px halve to even sizes down to the last strided stage, so
# every strided "SAME" pad there is unequal (0 before, 1 after for 3x3/2;
# 1 and 2 for 5x5/2)
SIZE = (64, 96)


def random_params(init, *inputs, seed=0):
    """Every leaf of `init`'s tree re-drawn: weights N(0, 1/fan_in), biases
    N(0, 0.1), norm scales near 1, BatchNorm means N(0, 0.5), variances in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "mean":
            out = 0.5 * rng.standard_normal(leaf.shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, leaf.shape)
        elif len(leaf.shape) >= 2:
            out = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(leaf.shape)
        return jnp.asarray(out.astype(np.float32))

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *inputs)["params"]
    return jax.tree_util.tree_map_with_path(fill, shapes)


def images(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


def close_l2(got, want, rtol=GRAD_RTOL_L2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want)


def random_state_dict(module, seed):
    """A port module's state_dict filled at random, BatchNorm statistics
    included, as numpy."""
    init_random_(module, torch.Generator().manual_seed(seed))
    generator = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buffer in module.named_buffers():
            if name.endswith("running_mean"):
                buffer.copy_(torch.randn(buffer.shape, generator=generator))
            elif name.endswith("running_var"):
                buffer.copy_(0.5 + torch.rand(buffer.shape, generator=generator))
    return {k: v.numpy() for k, v in module.state_dict().items()}


def assert_round_trip(sd, params, back, want_tree):
    """`params` (JAX's converter of the port's `sd`) has exactly the flax
    tree `want_tree`; `back` (the port's map of `params`) is `sd`."""
    paths = {p for p, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert paths == {p for p, _ in jax.tree_util.tree_leaves_with_path(want_tree)}
    assert set(back) == set(sd)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)


@pytest.mark.parametrize("cfg_name,dtype", [
    ("b5_tiny", "fp32"), ("lite_tiny", "fp32"), ("b5_tiny", "bf16"),
])
def test_efficientnet_walk_matches_jax(cfg_name, dtype):
    """Every entry of the Encoder walk; the bf16 `dtype` rounds the input
    only, so it is held to the fp32 tolerance too."""
    cfg = {"b5_tiny": ad.TINY_EFFICIENTNET, "lite_tiny": _tiny_lite_encoder()}[cfg_name]
    jdtype, tdtype = {"fp32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    module = jad.EfficientNetFeatures(cfg, dtype=jdtype)
    x = images(1, (2, 3, *SIZE)) * 4.0 - 2.0
    params = random_params(module.init, jnp.asarray(x))
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, jnp.asarray(x))
    port = ad.EfficientNetFeatures(cfg, dtype=tdtype)
    port.load_state_dict(convert.efficientnet_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 11 + cfg.include_head
    for g, w in zip(got, want):
        close(g.numpy(), w)


def _adabins_pair(seed=0):
    module = jad.UnetAdaptiveBins(jad.TINY_ADABINS)
    params = random_params(module.init, jnp.zeros((1, 3, *SIZE)), seed=seed)
    port = ad.UnetAdaptiveBins(ad.TINY_ADABINS)
    port.load_state_dict(convert.adabins_state_dict_from_jax(params, ad.TINY_ADABINS))
    return module, params, port.eval()


def test_decoder_and_mini_vit_match_jax():
    """DecoderBN on the trunk's five taps (its 1x1 conv2 pads 1, growing the
    map), then the mini-ViT on its output: bin widths and range-attention
    maps."""
    module, params, port = _adabins_pair(seed=2)
    cfg = jad.TINY_ADABINS
    x = jnp.asarray(images(3, (2, 3, *SIZE)))
    feats = jax.jit(lambda p, x: jad.EfficientNetFeatures(cfg.encoder).apply({"params": p}, x))(
        params["encoder"], x)
    nhwc = [feats[i].transpose(0, 2, 3, 1) for i in ad.DECODER_TAPS]
    decoder = jad.DecoderBN(cfg.decoder_features, cfg.decoder_out)
    want = jax.jit(lambda p, *b: decoder.apply({"params": p}, *b))(params["decoder"], *nhwc)
    bins = jax.jit(lambda p, u: jad.MiniViT(cfg).apply({"params": p}, u))(
        params["adaptive_bins_layer"], want)
    with torch.no_grad():
        got = port.decoder(*(torch.tensor(np.asarray(feats[i])) for i in ad.DECODER_TAPS))
        widths, maps = port.adaptive_bins_layer(got)
    close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    assert got.shape[-2:] == (SIZE[0] // 2, SIZE[1] // 2)
    close(widths.numpy(), bins[0])
    close(maps.numpy(), np.asarray(bins[1]).transpose(0, 3, 1, 2))
    np.testing.assert_allclose(widths.sum(1).numpy(), 1.0, rtol=1e-6)


def test_unet_adaptive_bins_matches_jax():
    module, params, port = _adabins_pair(seed=4)
    x = images(5, (2, 3, *SIZE)) * 2.0 - 1.0
    edges, depth = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got_edges, got_depth = port(torch.from_numpy(x))
    assert got_depth.shape == (2, 1, SIZE[0] // 2, SIZE[1] // 2)
    assert got_edges.shape == (2, ad.TINY_ADABINS.n_bins + 1)
    close(got_edges.numpy(), edges)
    close(got_depth.numpy(), depth)


def test_adabins_wrapper_matches_jax_with_its_flip_branch():
    """`AdaBinsDepth("nyu", tiny=True)` end to end (the normalized image and
    the mirrored UN-normalized one, averaged, clamped, upsampled) and its
    input gradient, against the JAX wrapper's `_predict` on the same
    weights; the flip branch alone is held too."""
    jwrapper = jad.AdaBinsDepth("nyu", tiny=True)
    params = random_params(jwrapper.module.init, jnp.zeros((1, 3, *SIZE)), seed=6)
    wrapper = models.AdaBinsDepth("nyu", tiny=True, device="cpu")
    wrapper.load_state_dict(convert.adabins_state_dict_from_jax(params, ad.TINY_ADABINS))
    x = images(7, (2, 3, *SIZE))
    weights = np.random.default_rng(8).standard_normal((2, 1, *SIZE)).astype(np.float32)

    def jax_value(im):
        depth = jwrapper._predict(params, im)
        return jnp.sum(depth * weights), depth

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_value, has_aux=True))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    got = wrapper(t)
    (grad,) = torch.autograd.grad((got * torch.from_numpy(weights)).sum(), t)
    assert got.shape == (2, 1, *SIZE)
    close(got.detach().numpy(), want)
    close_l2(grad.numpy(), want_grad)
    assert wrapper.min_depth <= float(got.detach().min()) <= float(got.detach().max()) <= 10.0

    flipped = jax.jit(lambda p, im: jwrapper.module.apply({"params": p}, im)[1])(
        params, jnp.asarray(x[..., ::-1].copy()))
    with torch.no_grad():
        got_flipped = wrapper.module(torch.from_numpy(x).flip(-1))[1]
    close(got_flipped.numpy(), flipped)


@pytest.mark.parametrize("shape", [(1, 3, 720, 720), (1, 3, 100, 120)], ids=["down", "up"])
def test_preresize_follows_the_area_rule(shape):
    """Above 500,000 px lanczos3 down, below 448^2 bicubic up, to JAX's
    out shape and values; 512^2 passes unchanged."""
    x = images(9, shape)
    got = ad.preresize(torch.from_numpy(x))
    h, w = shape[-2:]
    bound, method = ((ad.MAX_ADABINS_AREA, "lanczos3") if h * w > ad.MAX_ADABINS_AREA
                     else (ad.MIN_ADABINS_AREA, "bicubic"))
    scale = float(np.sqrt(bound) / np.sqrt(h * w))
    want = jresize(jnp.asarray(x), out_shape=(int(h * scale), int(w * scale)), resample=method)
    close(got.numpy(), want)
    same = torch.zeros(1, 3, 512, 512)
    assert ad.preresize(same) is same


def test_adabins_wrapper_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="unknown adabins checkpoint"):
        models.AdaBinsDepth("make3d", tiny=True, device="cpu")
    with pytest.raises(NotImplementedError, match="AdaBins_kitti"):
        models.AdaBinsDepth("kitti", device="cpu")
    kitti = models.AdaBinsDepth("kitti", tiny=True, device="cpu")
    assert (kitti.min_depth, kitti.max_depth) == (1e-3, 80.0)


@pytest.mark.parametrize("part", ["efficientnet", "adabins"])
def test_state_dict_round_trips_through_jax_converters(part):
    """The port's state_dict through JAX's own `convert_efficientnet` /
    `convert_adabins` gives the flax tree, which the port's map takes back
    to the same state_dict: the port's names are the upstream ones."""
    cfg = ad.TINY_ADABINS
    if part == "efficientnet":
        port = ad.EfficientNetFeatures(cfg.encoder)
        sd = {f"enc.{k}": v for k, v in random_state_dict(port, seed=10).items()}
        params = jad.convert_efficientnet(sd, "enc", cfg.encoder)
        back = convert.efficientnet_state_dict_from_jax(params, cfg.encoder, "enc.")
        want_tree = jax.eval_shape(jad.EfficientNetFeatures(cfg.encoder).init,
                                   jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"]
    else:
        port = ad.UnetAdaptiveBins(cfg)
        sd = random_state_dict(port, seed=11)
        params = jad.convert_adabins(sd, cfg)
        back = convert.adabins_state_dict_from_jax(params, cfg)
        want_tree = jax.eval_shape(jad.UnetAdaptiveBins(cfg).init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 3, 32, 32)))["params"]
    assert_round_trip(sd, params, back, want_tree)


def test_configs_match_jax():
    for name in ("B5_BLOCKS", "TINY_ADABINS", "EfficientNetConfig", "AdaBinsConfig"):
        mine, theirs = getattr(ad, name), getattr(jad, name)
        if isinstance(mine, type):
            mine, theirs = mine(), theirs()
        assert repr(mine) == repr(theirs), name
    assert ad.DATASETS == jad.DATASETS
    np.testing.assert_array_equal(ad.IMAGENET_MEAN, jad.IMAGENET_MEAN)
