"""The port's CNN trunks and perceptual losses (`models/vgg.py`,
`models/lpips.py`, `losses/lpips.py`, `losses/style_transfer.py`,
`models/resnet.py`, `models/resmem.py`, `losses/memorability.py` and their
converters in `convert.py`) against the JAX package, fp32 on the CPU, on
the same weights (flax params re-drawn from a seeded numpy rng, biases and
BatchNorm statistics included, carried across with the `*_from_jax`
converters) and the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu import losses as jlosses
from perceptor_tpu.losses import memorability as jmemorability
from perceptor_tpu.models import lpips as jlpips
from perceptor_tpu.models import resmem as jresmem
from perceptor_tpu.models import resnet as jresnet
from perceptor_tpu.models import vgg as jvgg
from perceptor_tpu_torch import convert, losses, models
from perceptor_tpu_torch.losses.memorability import _recenter
from perceptor_tpu_torch.losses.style_transfer import gram_matrix
from perceptor_tpu_torch.models.resmem import ResMemNet
from perceptor_tpu_torch.models.resnet import TINY_RESNEXT, ResNetFeatures
from perceptor_tpu_torch.models.vgg import VGG16_CFG, VGG19_CFG, VGGFeatures

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides through the trunks: max error over max magnitude
RTOL = 1e-4
# StyleTransfer's input gradient at 256px, relative L2: a max pool sends
# each window's gradient to its argmax, and among the millions of windows
# of VGG19 at 256px some hold two values within fp32 rounding of each
# other, which the two packages resolve differently; that moves single
# gradient entries by far more than RTOL of the max, but little of the norm
STYLE_GRAD_RTOL_L2 = 1e-3


def _random_params(init, *inputs, seed=0):
    """Every leaf of `init`'s tree re-drawn: weights N(0, 1/fan_in), biases
    N(0, 0.1), BatchNorm scales near 1, means N(0, 0.5), variances in
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


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("cfg,taps", [
    (VGG16_CFG, (4, 9, 16, 23, 30)), (VGG19_CFG, (4, 9, 16, 23, 30, 37)),
], ids=["vgg16", "vgg19"])
def test_vgg_features_taps_match_jax(cfg, taps):
    module = jvgg.VGGFeatures(cfg=cfg, taps=taps)
    x = _images(1, (2, 3, 64, 64))
    params = _random_params(module.init, jnp.asarray(x))
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, jnp.asarray(x))
    port = VGGFeatures(cfg, taps)
    port.load_state_dict(convert.vgg_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == len(taps)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_vgg19_wrapper_takes_torchvision_names_and_checks_sizes():
    vgg = models.VGG19(device="cpu")
    names = set(vgg.module.state_dict())
    assert "features.0.weight" in names and "features.34.bias" in names  # the 16th conv
    assert len(names) == 32 and not any(p.requires_grad for p in vgg.module.parameters())
    out = vgg(torch.rand(1, 3, 32, 32))
    assert out.shape == (1, 512, 1, 1)
    with pytest.raises(ValueError, match="divisible by 8"):
        vgg(torch.rand(1, 3, 36, 32))


def _lpips_pair(name, linear_layers=True, spatial=False):
    jmodel = jlpips.LPIPS(name, linear_layers=linear_layers, spatial=spatial)
    backbone = _random_params(jmodel.backbone.init, jnp.zeros((1, 3, 64, 64)))
    rng = np.random.default_rng(5)
    lins = [jnp.asarray(rng.uniform(0, 2.0 / c, (c, 1)).astype(np.float32))
            for c in jlpips.LPIPS_CHANNELS[name]]
    params = {"backbone": backbone, "lins": lins}
    loss = losses.LPIPS(name, linear_layers=linear_layers, spatial=spatial, device="cpu")
    loss.model.load_state_dict(convert.lpips_state_dict_from_jax(params, name))
    return jmodel, params, loss


@pytest.mark.parametrize("name,linear_layers,spatial", [
    ("squeeze", True, False), ("alex", True, False), ("vgg", True, False),
    ("alex", False, False), ("alex", True, True),
], ids=["squeeze", "alex", "vgg", "alex-no-heads", "alex-spatial"])
def test_lpips_matches_jax(name, linear_layers, spatial):
    """Distance and its gradient in `images_a`; `spatial` upsamples each
    tap's map (15, 7 and 3 px at 64) to the image, an odd ratio."""
    jmodel, params, loss = _lpips_pair(name, linear_layers, spatial)
    a, b = _images(2, (2, 3, 64, 64)), _images(3, (2, 3, 64, 64))
    # a different weight per image, so the gradient tells the images apart
    weights = np.array([1.0, 2.0], np.float32).reshape((2, 1, 1, 1) if spatial else (2, 1))

    def jax_value(x, y):
        distance = jmodel.distance_fn(params, x, y)
        return jnp.sum(distance * weights), distance

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_value, has_aux=True))(
        jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_(True)
    got = loss(x, torch.from_numpy(b))
    (grad,) = torch.autograd.grad((got * torch.from_numpy(weights)).sum(), x)
    assert got.shape == ((2, 1, 64, 64) if spatial else (2, 1))
    _close(got.detach().numpy(), want)
    _close(grad.numpy(), want_grad)
    with torch.no_grad():
        assert float(loss(x, x).abs().max()) < 1e-6


def test_spatial_upsampling_is_jax_linear_resize():
    """`interpolate_bilinear(align_corners=False)` is `jax.image.resize`'s
    "linear" when upsampling, edges included, at 7 -> 64 and 3 -> 64."""
    from perceptor_tpu_torch.ops.resize import interpolate_bilinear

    for side in (7, 3):
        x = _images(4, (2, 1, side, side))
        want = jax.image.resize(jnp.asarray(x), (2, 1, 64, 64), "linear")
        got = interpolate_bilinear(torch.from_numpy(x), (64, 64), align_corners=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_lpips_refuses_an_unknown_backbone():
    with pytest.raises(ValueError, match="unknown lpips backbone"):
        models.lpips.LPIPS("resnet", device="cpu")


def test_gram_matrix_matches_jax():
    from perceptor_tpu.losses.style_transfer import gram_matrix as jgram

    x = _images(6, (2, 5, 6, 7))
    np.testing.assert_allclose(gram_matrix(torch.from_numpy(x)).numpy(),
                               np.asarray(jgram(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_style_transfer_matches_jax(monkeypatch):
    """The loss to a style image given at construction and to an image
    given per call, and its gradient; both inputs resized to 256."""
    jloss = jlosses.StyleTransfer()
    params = _random_params(jloss.model.module.init, jnp.zeros((1, 3, 32, 32)), seed=7)
    monkeypatch.setattr(jloss.model, "params", params)
    style, content = _images(8, (1, 3, 64, 64)), _images(9, (1, 3, 80, 72))
    want, want_grad = jax.jit(jax.value_and_grad(jloss.forward))(
        jnp.asarray(content), jnp.asarray(style))
    vgg = models.VGG19(device="cpu")  # held: the memo keeps live instances only
    vgg.load_state_dict(convert.vgg_state_dict_from_jax(params, VGG19_CFG))
    loss = losses.StyleTransfer(style_images=torch.from_numpy(style), device="cpu")
    assert loss.model is vgg
    x = torch.from_numpy(content).requires_grad_(True)
    value = loss(x)
    (grad,) = torch.autograd.grad(value, x)
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=RTOL)
    want_grad = np.asarray(want_grad)
    assert np.linalg.norm(grad.numpy() - want_grad) <= STYLE_GRAD_RTOL_L2 * np.linalg.norm(want_grad)
    per_call = loss(torch.from_numpy(content), torch.from_numpy(style))
    np.testing.assert_allclose(float(per_call), float(want), rtol=RTOL)
    assert float(loss(torch.from_numpy(style))) < 1e-5
    with pytest.raises(ValueError, match="no style images"):
        losses.StyleTransfer(device="cpu")(x)


def test_resnet_features_match_jax_at_every_stage():
    module = jresnet.ResNetFeatures(jresnet.TINY_RESNEXT)
    x = _images(10, (2, 3, 64, 48))
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    params = _random_params(module.init, nhwc, seed=11)
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, nhwc)
    port = ResNetFeatures(TINY_RESNEXT)
    port.load_state_dict(convert.resnet_state_dict_from_jax(params))
    assert {"layer2.0.downsample.0.weight", "layer2.0.downsample.1.running_var",
            "layer1.0.conv2.weight", "bn1.running_mean"} <= set(port.state_dict())
    assert port.layer1[0].conv2.groups == 2
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == 4
    for g, w, channels in zip(got, want, TINY_RESNEXT.stage_channels):
        assert g.shape[1] == channels
        _close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def resmem_pair():
    """The tiny ResMemNet at 95px, where the last AlexNet pool is 2 x 2, so
    fc6's flatten order matters."""
    module = jresmem.ResMemNet(resnet_config=jresnet.TINY_RESNEXT, width_mult=8)
    params = _random_params(module.init, jnp.zeros((1, 3, 95, 95)), seed=12)
    return module, params


def test_resmem_net_matches_jax(resmem_pair):
    module, params = resmem_pair
    x = _images(13, (2, 3, 95, 95))

    def jax_scores(p, x):
        return module.apply({"params": p}, x)

    want = jax.jit(jax_scores)(params, jnp.asarray(x))
    want_grad = jax.jit(jax.grad(lambda p, x: jnp.sum(jax_scores(p, x) * jnp.array([1.0, 2.0])),
                                 argnums=1))(params, jnp.asarray(x))
    sd = convert.resmem_state_dict_from_jax(params)
    port = ResMemNet(TINY_RESNEXT, width_mult=8, spatial=2)
    port.load_state_dict(sd)
    assert {"features.10.weight", "fc6.weight", "fc7.bias", "resnet.layer4.0.conv3.weight",
            "head3.bias"} <= set(sd)
    t = torch.from_numpy(x).requires_grad_(True)
    got = port(t)
    (grad,) = torch.autograd.grad((got * torch.tensor([1.0, 2.0])).sum(), t)
    _close(got.detach().numpy(), want)
    _close(grad.numpy(), want_grad)
    # fc6 taken without the (H, W, C) -> (C, H, W) permutation disagrees
    kernel = np.asarray(params["alexnet"]["fc6"]["kernel"])
    naive = dict(sd, **{"fc6.weight": torch.from_numpy(kernel.T.copy())})
    port.load_state_dict(naive)
    with torch.no_grad():
        wrong = port(torch.from_numpy(x))
    want = np.asarray(want)
    assert float(np.abs(wrong.numpy() - want).max()) > 100 * RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 3, 70, 90), (1, 3, 100, 64)], ids=["wide", "tall"])
def test_recenter_matches_jax(shape):
    x = _images(14, shape)
    want = jmemorability._recenter(jnp.asarray(x), 68, 63)
    got = _recenter(torch.from_numpy(x), 68, 63)
    assert got.shape == (shape[0], 3, 63, 63)
    _close(got.numpy(), want)


def test_memorability_tiny_matches_jax():
    """`Memorability("tiny")` on non-square images: Resize(68) + 63 crop,
    the tiny ResMem, mean * 0.05; value and gradient."""
    jloss = jlosses.Memorability("tiny")
    params = _random_params(jloss.model.module.init, jnp.zeros((1, 3, 63, 63)), seed=15)
    x = _images(16, (2, 3, 70, 90))
    want, want_grad = jax.jit(jax.value_and_grad(lambda im: jloss.apply({"model": params}, im)))(
        jnp.asarray(x))
    loss = losses.Memorability("tiny", device="cpu")
    assert loss.short_side == 68 and loss.model.crop_size == 63
    loss.model.load_state_dict(convert.resmem_state_dict_from_jax(params))
    t = torch.from_numpy(x).requires_grad_(True)
    value = loss(t)
    (grad,) = torch.autograd.grad(value, t)
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=RTOL)
    _close(grad.numpy(), want_grad)


def test_resmem_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown ResMem variant"):
        models.ResMem("resmem-xl", device="cpu")


def test_published_trunks_build_with_jax_shapes():
    """ResMem at its published widths (ResNet-152 + AlexNet, 227px) and the
    LPIPS trunks: the port's modules (built on the meta device) have JAX's
    parameter shapes, leaf for leaf."""
    def jax_sizes(module, x):
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
        return sorted(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))

    def port_sizes(module):
        return sorted([p.numel() for p in module.parameters()]
                      + [b.numel() for b in module.buffers()])

    with torch.device("meta"):
        resmem = ResMemNet()
        trunks = {name: models.lpips.LPIPSNet(name) for name in ("alex", "squeeze", "vgg")}
    assert port_sizes(resmem) == jax_sizes(jresmem.ResMemNet(), jnp.zeros((1, 3, 227, 227)))
    for name, net in trunks.items():
        lins = list(jlpips.LPIPS_CHANNELS[name])
        jtrunk = {"alex": jlpips.AlexFeatures(), "squeeze": jlpips.SqueezeFeatures(),
                  "vgg": jvgg.VGGFeatures(cfg=VGG16_CFG, taps=(4, 9, 16, 23, 30))}[name]
        assert port_sizes(net) == sorted(jax_sizes(jtrunk, jnp.zeros((1, 3, 64, 64))) + lins), name


def test_wrappers_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for make in (lambda: losses.LPIPS("alex"), lambda: losses.StyleTransfer(),
                 lambda: losses.Memorability("tiny")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
