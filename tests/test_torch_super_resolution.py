"""The port's Real-ESRGAN slice (`models/super_resolution.py`,
`transforms/super_resolution.py`, `losses/super_resolution.py`) and its
converters against the JAX package at narrow widths, on the CPU.

Both packages hold the same weights: the JAX module's param tree re-drawn
from a seeded numpy rng, carried across with the `*_state_dict_from_jax`
converters, which the JAX package's own `convert_*` read back. The wrappers
of both packages are built unmemoized (`__wrapped__`), so no other test
module's instance is touched. fp32 outputs and input gradients are held to
RTOL of the reference's largest magnitude, bf16 to BF16_RTOL relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu import losses as jlosses
from perceptor_tpu.models import super_resolution as jsr
from perceptor_tpu_torch import convert, losses, models, transforms
from perceptor_tpu_torch.models import super_resolution as sr
from test_torch_rudalle import close, fill_params, np_tree, rel_l2

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

RTOL = 1e-4
BF16_RTOL = 3e-2


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _probe_grad(jfn, fn, x):
    """The input gradients of sum(f(x) * probe) in both packages, probe a
    seeded normal of the output's shape; also returns both outputs."""
    want = jfn(jnp.asarray(x))
    probe = np.random.default_rng(99).standard_normal(want.shape).astype(np.float32)
    want_grad = jax.jit(jax.grad(lambda im: jnp.sum(jfn(im) * probe)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = fn(xt)
    (got * torch.from_numpy(probe)).sum().backward()
    assert float(xt.grad.abs().max()) > 0
    return got.detach(), want, xt.grad, want_grad


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 12)).astype(np.float32)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    for scale in (2, 4):
        down = sr.pixel_unshuffle(torch.from_numpy(x), scale)
        close(down, np.asarray(jsr.pixel_unshuffle(nhwc, scale)).transpose(0, 3, 1, 2), 0)
        up = sr.pixel_shuffle(down, scale)
        close(up, np.asarray(jsr.pixel_shuffle(
            jnp.asarray(down.numpy().transpose(0, 2, 3, 1)), scale)).transpose(0, 3, 1, 2), 0)
        close(up, x, 0)


def _port(cls, config, sd):
    module = cls(config)
    module.load_state_dict(sd)
    return module.eval().requires_grad_(False)


@pytest.mark.parametrize("scale", [1, 2, 4, 8])
def test_rrdbnet_matches_jax(scale):
    jmodule = jsr.RRDBNet(scale=scale, num_feat=8, num_block=2, num_grow_ch=4)
    x = _images(scale, (1, 3, 16, 16))
    params = fill_params(jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], scale)
    sd = convert.rrdbnet_state_dict_from_jax(np_tree(params))
    port = _port(sr.RRDBNet, sr.RRDBConfig(scale=scale, num_feat=8, num_block=2, num_grow_ch=4),
                 sd)
    # basicsr's names: the JAX package's own converter reads them back
    back = jsr.convert_rrdbnet({"params_ema": {k: v.numpy() for k, v in sd.items()}})
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, np_tree(params))
    got, want, grad, want_grad = _probe_grad(
        jax.jit(lambda im: jmodule.apply({"params": params}, im)), port, x)
    assert got.shape == (1, 3, 16 * scale, 16 * scale)
    close(got, want, RTOL)
    close(grad, want_grad, RTOL)


def test_srvgg_matches_jax():
    jmodule = jsr.SRVGGNetCompact(upscale=4, num_feat=8, num_conv=3)
    x = _images(1, (2, 3, 12, 10))
    params = fill_params(jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    sd = convert.srvgg_state_dict_from_jax(np_tree(params), num_conv=3)
    port = _port(sr.SRVGGNetCompact, sr.SRVGGConfig(upscale=4, num_feat=8, num_conv=3), sd)
    back = jsr.convert_srvgg({k: v.numpy() for k, v in sd.items()})
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, np_tree(params))
    got, want, grad, want_grad = _probe_grad(
        jax.jit(lambda im: jmodule.apply({"params": params}, im)), port, x)
    close(got, want, RTOL)
    close(grad, want_grad, RTOL)


def test_unet_discriminator_matches_jax():
    jmodule = jsr.UNetDiscriminatorSN(num_feat=8)
    x = _images(3, (2, 3, 24, 16))
    params = fill_params(jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    sd = convert.unet_discriminator_state_dict_from_jax(np_tree(params))
    port = _port(sr.UNetDiscriminatorSN, 8, sd)
    got, want, grad, want_grad = _probe_grad(
        jax.jit(lambda im: jmodule.apply({"params": params}, im)), port, x)
    assert got.shape == (2, 1, 24, 16)
    close(got, want, RTOL)
    close(grad, want_grad, RTOL)


def test_spectral_norm_fold_matches_jax():
    """A basicsr discriminator state_dict with spectral-normed conv1..8
    (`weight_orig`, `weight_u`, `weight_v`) under "params": the port's fold
    gives the weights JAX's `convert_unet_discriminator` gives."""
    nf = 8
    shapes = {0: (nf, 3, 3, 3), 1: (2 * nf, nf, 4, 4), 2: (4 * nf, 2 * nf, 4, 4),
              3: (8 * nf, 4 * nf, 4, 4), 4: (4 * nf, 8 * nf, 3, 3), 5: (2 * nf, 4 * nf, 3, 3),
              6: (nf, 2 * nf, 3, 3), 7: (nf, nf, 3, 3), 8: (nf, nf, 3, 3), 9: (1, nf, 3, 3)}
    rng = np.random.default_rng(5)
    basicsr = {}
    for i, shape in shapes.items():
        w = rng.standard_normal(shape).astype(np.float32)
        if i in (0, 9):
            basicsr[f"conv{i}.weight"] = w
            basicsr[f"conv{i}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)
        else:
            basicsr[f"conv{i}.weight_orig"] = w
            basicsr[f"conv{i}.weight_u"] = rng.standard_normal(shape[0]).astype(np.float32)
            basicsr[f"conv{i}.weight_v"] = rng.standard_normal(
                int(np.prod(shape[1:]))).astype(np.float32)
    got = sr.convert_unet_discriminator({"params": {k: torch.from_numpy(v)
                                                    for k, v in basicsr.items()}})
    want = convert.unet_discriminator_state_dict_from_jax(
        jsr.convert_unet_discriminator({"params": basicsr}))
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], RTOL)
    _port(sr.UNetDiscriminatorSN, nf, got)


def _wrappers(half=False):
    """Unmemoized "tiny" wrappers of both packages with the same re-drawn
    weights."""
    jmodel = jsr.SuperResolution.__wrapped__("tiny", half=half)
    jmodel.params = fill_params(jmodel.params, 6)
    model = models.SuperResolution.__wrapped__("tiny", half=half, device="cpu")
    model.load_state_dict({"params": convert.rrdbnet_state_dict_from_jax(np_tree(jmodel.params))})
    return jmodel, model


@pytest.mark.parametrize("tile_size,tile_pad", [(0, 0), (16, 4)], ids=["whole", "tiled"])
def test_enhance_matches_jax(tile_size, tile_pad):
    """`enhance` on a 37 x 45 frame (no multiple of the tile), whole and
    tiled, against JAX's `_enhance_fn`, and its input gradient."""
    jmodel, model = _wrappers()
    x = _images(7, (1, 3, 37, 45))
    got, want, grad, want_grad = _probe_grad(
        jax.jit(lambda im: jmodel._enhance_fn(jmodel.params, im, tile_size, tile_pad, 10)),
        lambda im: model.enhance(im, tile_size=tile_size, tile_pad=tile_pad), x)
    assert got.shape == (1, 3, 74, 90)
    close(got, want, RTOL)
    close(grad, want_grad, RTOL)


def test_half_upsample_transform_and_loss_match_jax():
    """bf16 `upsample` against JAX's bf16 build; the transform's encode /
    decode; the self-consistency loss and its gradient (fp32)."""
    jmodel, model = _wrappers(half=True)
    x = _images(8, (1, 3, 16, 16))
    assert rel_l2(model.upsample(torch.from_numpy(x)), jmodel.upsample(jnp.asarray(x))) <= BF16_RTOL

    jmodel, model = _wrappers()
    transform = transforms.SuperResolution("tiny", half=False, device="cpu")
    transform.model = model
    up = transform.encode(torch.from_numpy(x))
    assert up.shape == (1, 3, 32, 32) and transform.decode(up).shape == (1, 3, 16, 16)

    jloss = jlosses.SuperResolution("tiny", half=False)
    jloss.transform.model = jmodel
    loss = losses.SuperResolution("tiny", half=False, device="cpu")
    loss.transform.model = model
    images = _images(9, (2, 3, 32, 32))
    want, want_grad = jax.jit(jax.value_and_grad(jloss.forward))(jnp.asarray(images))
    xt = torch.from_numpy(images).requires_grad_(True)
    value = loss(xt)
    value.backward()
    close(value.detach(), want, RTOL)
    close(xt.grad, want_grad, RTOL)


def test_discriminator_loss_matches_jax():
    jloss = jlosses.SuperResolutionDiscriminator()
    jloss.params = fill_params(jloss.params, 10)
    loss = losses.SuperResolutionDiscriminator(device="cpu")
    loss.module.load_state_dict(convert.unet_discriminator_state_dict_from_jax(
        np_tree(jloss.params)))
    images = _images(11, (1, 3, 32, 32))
    want, want_grad = jax.jit(jax.value_and_grad(jloss.forward))(jnp.asarray(images))
    xt = torch.from_numpy(images).requires_grad_(True)
    value = loss(xt)
    value.backward()
    close(value.detach(), want, RTOL)
    close(xt.grad, want_grad, RTOL)
