"""The port's drawers against the JAX package's, fp32 on the CPU: the init
arrays (numpy on both sides: equal), `Raw`, and the JPEG codec and drawer
with gradients to the coefficients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu import drawers as jdrawers
from perceptor_tpu.drawers import inits as jinits
from perceptor_tpu.drawers.jpeg import codec as jcodec
from perceptor_tpu_torch import drawers
from perceptor_tpu_torch.drawers import inits
from perceptor_tpu_torch.drawers.jpeg import (
    compress_jpeg, decompress_jpeg, diff_round, quality_to_factor,
)

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# 8x8 DCT, quantization tables up to 121 and the colour matrices, in fp32
JPEG_ATOL = 1e-4


@pytest.mark.parametrize("shape", [(1, 3, 32, 48), (2, 1, 300, 260)], ids=["small", "over_256"])
def test_fractal_init_equals_the_jax_packages(shape):
    ours, theirs = inits.fractal(shape, seed=3), jinits.fractal(shape, seed=3)
    assert ours.dtype == np.float32 and ours.shape == shape
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours, inits.fractal(shape, seed=4))


def test_gradient_init_equals_the_jax_packages():
    shape = (2, 3, 24, 40)
    np.testing.assert_array_equal(inits.gradient(shape, seed=5), jinits.gradient(shape, seed=5))
    with pytest.raises(ValueError, match="3 channel"):
        inits.gradient((1, 1, 8, 8), seed=0)


def test_raw_drawer():
    drawer = drawers.Raw.random_fractal_image((1, 3, 32, 32), seed=0, device="cpu")
    jdrawer = jdrawers.Raw.random_fractal_image((1, 3, 32, 32), seed=0)
    assert isinstance(drawer, torch.nn.Module) and isinstance(drawer, drawers.DrawingInterface)
    assert [name for name, _ in drawer.named_parameters()] == ["pixels"]
    assert drawer.pixels.requires_grad and drawer.shape == (1, 3, 32, 32)
    np.testing.assert_array_equal(drawer.synthesize().detach().numpy(), np.asarray(jdrawer.params))
    assert drawer.params is drawer.pixels and drawer() is drawer.pixels
    other = torch.zeros(1, 3, 32, 32)
    assert drawer.synthesize(other) is other
    gradient = drawers.Raw.random_gradient_image((1, 3, 16, 16), seed=1, device="cpu")
    np.testing.assert_array_equal(
        gradient.pixels.detach().numpy(),
        np.asarray(jdrawers.Raw.random_gradient_image((1, 3, 16, 16), seed=1).params))
    # the init array is copied: the drawer does not alias the caller's tensor
    source = torch.rand(1, 3, 8, 8)
    assert drawers.Raw(source, device="cpu").pixels.data_ptr() != source.data_ptr()


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_raw_encode_matches_jax(mode):
    images = np.random.default_rng(0).uniform(size=(1, 3, 48, 40)).astype(np.float32)
    drawer = drawers.Raw(np.zeros((1, 3, 32, 32), np.float32), device="cpu")
    jdrawer = jdrawers.Raw(jnp.zeros((1, 3, 32, 32)))
    got = drawer.encode(torch.from_numpy(images), mode=mode)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdrawer.encode(jnp.asarray(images), mode=mode)), atol=1e-5)


def test_replace_copies_in_place():
    drawer = drawers.Raw(np.zeros((1, 3, 8, 8), np.float32), device="cpu")
    parameter = drawer.pixels
    new = torch.rand(1, 3, 8, 8)
    assert drawer.replace_(new) is drawer
    assert drawer.pixels is parameter and torch.equal(drawer.pixels, new)
    assert drawer.pixels.data_ptr() != new.data_ptr() and drawer.pixels.requires_grad
    with pytest.raises(ValueError, match="expected 1 parameter"):
        drawer.replace_((new, new))


def test_a_drawer_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drawers.Raw(np.zeros((1, 3, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drawers.JPEG(np.zeros((1, 3, 16, 16), np.float32))


@pytest.mark.parametrize("factor", [1.0, 0.25])
def test_jpeg_codec_matches_jax(factor):
    images = inits.fractal((2, 3, 32, 48), seed=6)
    got = compress_jpeg(torch.from_numpy(images), factor)
    want = jcodec.compress_jpeg(jnp.asarray(images), factor)
    assert [tuple(t.shape) for t in got] == [(2, 24, 8, 8), (2, 6, 8, 8), (2, 6, 8, 8)]
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=JPEG_ATOL)
    # decode the JAX side's coefficients on both sides: rounding cannot differ
    coefficients = [np.array(t) for t in want]
    back = decompress_jpeg(*(torch.from_numpy(c) for c in coefficients), 32, 48, factor)
    j_back = jcodec.decompress_jpeg(*(jnp.asarray(c) for c in coefficients), 32, 48, factor)
    assert back.shape == (2, 3, 32, 48)
    np.testing.assert_allclose(back.numpy(), np.asarray(j_back), atol=JPEG_ATOL)


def test_jpeg_gradients_reach_the_coefficients_as_in_jax():
    images = inits.fractal((1, 3, 16, 16), seed=7)
    coefficients = [np.array(t) for t in jcodec.compress_jpeg(jnp.asarray(images))]
    probe = np.random.default_rng(8).standard_normal((1, 3, 16, 16)).astype(np.float32)
    leaves = [torch.from_numpy(c).requires_grad_(True) for c in coefficients]
    out = decompress_jpeg(*leaves, 16, 16)
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), leaves)
    j_grads = jax.grad(
        lambda ycbcr: (jcodec.decompress_jpeg(*ycbcr, 16, 16) * probe).sum()
    )(tuple(jnp.asarray(c) for c in coefficients))
    for ours, theirs in zip(grads, j_grads):
        assert float(np.abs(np.asarray(theirs)).max()) > 0
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=JPEG_ATOL)
    # and through the encoder's pseudo-differentiable rounding to the pixels
    x = torch.from_numpy(images).requires_grad_(True)
    (grad,) = torch.autograd.grad(sum(t.sum() for t in compress_jpeg(x)), x)
    want = jax.grad(lambda im: sum(t.sum() for t in jcodec.compress_jpeg(im)))(jnp.asarray(images))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), atol=JPEG_ATOL)


def test_diff_round_and_quality_to_factor():
    x = np.array([-1.5, -0.4, 0.0, 0.5, 1.3, 2.5], np.float32)
    np.testing.assert_allclose(diff_round(torch.from_numpy(x)).numpy(),
                               np.asarray(jcodec.diff_round(jnp.asarray(x))), atol=1e-7)
    for quality in (10, 49, 50, 75, 100):
        assert quality_to_factor(quality) == jcodec.quality_to_factor(quality)


def test_jpeg_drawer_matches_jax():
    images = inits.fractal((1, 3, 32, 32), seed=9)
    drawer = drawers.JPEG(images, device="cpu")
    jdrawer = jdrawers.JPEG(jnp.asarray(images))
    names = [name for name, _ in drawer.named_parameters()]
    assert names == ["coefficients.0", "coefficients.1", "coefficients.2"]
    assert all(p.requires_grad for p in drawer.parameters())
    for ours, theirs in zip(drawer.params, jdrawer.params):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=JPEG_ATOL)
    np.testing.assert_allclose(
        drawer.synthesize().detach().numpy(), np.asarray(jdrawer.synthesize()), atol=2 * JPEG_ATOL)
    assert not [name for name, _ in drawer.named_buffers() if name in drawer.state_dict()]
    # encode resizes other sizes first
    larger = np.random.default_rng(10).uniform(size=(1, 3, 48, 48)).astype(np.float32)
    for ours, theirs in zip(drawer.encode(torch.from_numpy(larger)),
                            jdrawer.encode(jnp.asarray(larger))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-3)
    drawer.synthesize().sum().backward()
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0 for p in drawer.parameters())
    # replace_ takes the (y, cb, cr) triple
    zeros = tuple(torch.zeros_like(p) for p in drawer.parameters())
    drawer.replace_(zeros)
    np.testing.assert_allclose(drawer.synthesize().detach().numpy(), 128.0 / 255.0, atol=1e-6)


def test_a_drawer_that_is_not_ported_says_so():
    from perceptor_tpu_torch.drawers.rudalle import BruteRuDalle

    from perceptor_tpu_torch.drawers.stylegan_xl import StyleGANXL

    # every drawer of the JAX package is ported: the last one resolves, and
    # a name that is no drawer raises as any missing attribute does
    assert drawers.BruteRuDalle is BruteRuDalle and drawers.StyleGANXL is StyleGANXL
    with pytest.raises(AttributeError, match="has no attribute 'NoSuchDrawer'"):
        drawers.NoSuchDrawer
