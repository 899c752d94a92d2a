"""The port's transforms against the JAX package's, fp32 on the CPU, on the
same numpy inputs: `crop_and_resize` on given boxes (a JAX key cannot be
replayed by a `torch.Generator`, so the random boxes are tested for their
distribution and determinism), `dynamic_threshold`, `ClampWithGrad` and
`Resize`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu import transforms as jtransforms
from perceptor_tpu_torch import transforms

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# two fp32 contractions over at most 40 source pixels
ATOL = 1e-5
BOXES = np.array(
    [[0.0, 0.0, 1.0, 1.0], [0.1, 0.2, 0.6, 0.7], [0.5, 0.25, 1.0, 0.75], [0.3, 0.3, 0.4, 0.4]],
    np.float32,
)


def _images(seed, shape=(2, 3, 40, 32)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("out_size", [8, 24, 48], ids=["minify", "mixed", "magnify"])
def test_crop_and_resize_matches_jax(out_size):
    images = _images(0)
    got = transforms.crop_and_resize(torch.from_numpy(images), torch.from_numpy(BOXES), out_size)
    want = jtransforms.crop_and_resize(jnp.asarray(images), jnp.asarray(BOXES), out_size)
    assert got.shape == (len(BOXES) * 2, 3, out_size, out_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_crop_and_resize_image_gradient_matches_jax():
    images = _images(1)
    probe = np.random.default_rng(2).standard_normal((len(BOXES) * 2, 3, 16, 16)).astype(np.float32)
    x = torch.from_numpy(images).requires_grad_(True)
    out = transforms.crop_and_resize(x, BOXES, 16)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), x)
    want = jax.grad(
        lambda im: (jtransforms.crop_and_resize(im, jnp.asarray(BOXES), 16) * probe).sum()
    )(jnp.asarray(images))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), atol=ATOL)


def test_crop_and_resize_identity_constant_order_and_dtype():
    images = torch.from_numpy(_images(3, (2, 3, 16, 16)))
    full = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
    assert torch.equal(transforms.crop_and_resize(images, full, 16), images)
    constant = torch.full((1, 3, 40, 32), 0.37)
    out = transforms.crop_and_resize(constant, BOXES, 24)
    np.testing.assert_allclose(out.numpy(), 0.37, atol=1e-6)
    # cut-major: cut 0 over the whole batch, then cut 1
    two = transforms.crop_and_resize(images, torch.from_numpy(BOXES[:2]), 8)
    for cut in range(2):
        for item in range(2):
            alone = transforms.crop_and_resize(images[item:item + 1], BOXES[cut:cut + 1], 8)
            assert torch.allclose(two[cut * 2 + item], alone[0], atol=1e-6)
    half = transforms.crop_and_resize(images.to(torch.bfloat16), BOXES, 8)
    assert half.dtype == torch.bfloat16
    for bad in (np.zeros((4,), np.float32), np.zeros((2, 3), np.float32)):
        with pytest.raises(ValueError, match=r"boxes must be \(n, 4\)"):
            transforms.crop_and_resize(images, bad, 8)


@pytest.mark.parametrize("cut_pow", [1.0, 0.5, 2.0])
def test_random_cutout_boxes_distribution(cut_pow):
    h, w, cut = 96, 64, 24
    gen = torch.Generator().manual_seed(0)
    boxes = transforms.random_cutout_boxes(gen, (h, w), 4000, cut_size=cut, cut_pow=cut_pow)
    assert boxes.shape == (4000, 4)
    y0, x0, y1, x1 = boxes.unbind(1)
    assert float(boxes.min()) >= 0.0 and float(boxes.max()) <= 1.0 + 1e-6
    sides_y, sides_x = (y1 - y0) * h, (x1 - x0) * w
    np.testing.assert_allclose(sides_y.numpy(), sides_x.numpy(), atol=1e-3)  # squares
    assert float(sides_y.min()) >= cut - 1e-3 and float(sides_y.max()) <= min(h, w) + 1e-3
    # side = u**cut_pow scaled into [cut, S]: E[u**p] = 1 / (1 + p)
    mean_u = float(((sides_y - cut) / (min(h, w) - cut)).mean())
    np.testing.assert_allclose(mean_u, 1.0 / (1.0 + cut_pow), atol=0.03)
    # placed uniformly in the room left: the mean offset is half of it
    room = (h - sides_y).clamp(min=1e-6)
    np.testing.assert_allclose(float((y0 * h / room).mean()), 0.5, atol=0.03)
    # an image smaller than cut_size: every box is the whole short side
    small = transforms.random_cutout_boxes(gen, (16, 20), 8, cut_size=24)
    np.testing.assert_allclose(((small[:, 2] - small[:, 0]) * 16).numpy(), 16.0, atol=1e-4)


def test_random_cutouts_are_seeded_and_differentiable():
    images = torch.from_numpy(_images(4, (1, 3, 48, 48))).requires_grad_(True)

    def run(seed):
        return transforms.random_cutouts(images, torch.Generator().manual_seed(seed), 5,
                                         cut_size=16, cut_pow=0.5)

    first = run(0)
    assert first.shape == (5, 3, 16, 16)
    assert torch.equal(first, run(0)) and not torch.equal(first, run(1))
    gen = torch.Generator().manual_seed(0)
    boxes = transforms.random_cutout_boxes(gen, (48, 48), 5, cut_size=16, cut_pow=0.5)
    assert torch.equal(first, transforms.crop_and_resize(images, boxes, 16))
    (grad,) = torch.autograd.grad(first.sum(), images)
    assert float(grad.abs().sum()) > 0


@pytest.mark.parametrize("quantile", [0.95, 0.5])
def test_dynamic_threshold_matches_jax_at_batch_2(quantile):
    # the second item has a wide range, so its threshold is above the floor
    images = _images(5, (2, 3, 16, 16))
    images[1] = images[1] * 3.0 - 1.0
    probe = np.random.default_rng(6).standard_normal(images.shape).astype(np.float32)
    x = torch.from_numpy(images).requires_grad_(True)
    got = transforms.dynamic_threshold(x, quantile)
    want, j_grad = jax.value_and_grad(
        lambda im: (jtransforms.dynamic_threshold(im, quantile) * probe).sum()
    )(jnp.asarray(images))
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jtransforms.dynamic_threshold(jnp.asarray(images), quantile)),
        atol=1e-6)
    (grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), x)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-6)
    transform = transforms.DynamicThreshold(quantile)
    assert torch.equal(transform(x), got) and transform.decode(x) is x


def test_clamp_with_grad_transform_matches_jax():
    values = np.linspace(-0.5, 1.5, 24, dtype=np.float32).reshape(1, 1, 4, 6)
    probe = np.random.default_rng(7).standard_normal(values.shape).astype(np.float32)
    x = torch.from_numpy(values).requires_grad_(True)
    transform, jtransform = transforms.ClampWithGrad(0.1, 0.9), jtransforms.ClampWithGrad(0.1, 0.9)
    got = transform(x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jtransform(jnp.asarray(values))))
    (grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), x)
    want = jax.grad(lambda v: (jtransform(v) * probe).sum())(jnp.asarray(values))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want))
    assert transform.decode(x) is x


def test_resize_transform_matches_jax():
    images = _images(8)
    for kwargs in ({"out_shape": (20, 16)}, {"scale_factors": 0.5},
                   {"out_shape": (60, 48), "resample": "bilinear"}):
        got = transforms.Resize(**kwargs)(torch.from_numpy(images))
        want = jtransforms.Resize(**kwargs)(jnp.asarray(images))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    transform, jtransform = transforms.Resize(out_shape=(20, 16)), jtransforms.Resize(out_shape=(20, 16))
    back = transform.decode(transform(torch.from_numpy(images)), (40, 32))
    want = jtransform.decode(jtransform(jnp.asarray(images)), (40, 32))
    np.testing.assert_allclose(back.numpy(), np.asarray(want), atol=ATOL)


def test_transforms_exports():
    assert transforms.resize is not None and transforms.clamp_with_grad is not None
    assert issubclass(transforms.Resize, transforms.TransformInterface)
    with pytest.raises(NotImplementedError):
        transforms.TransformInterface()(1)
    assert issubclass(transforms.SuperResolution, transforms.TransformInterface)
    with pytest.raises(AttributeError, match="has no attribute"):
        transforms.NoSuchTransform
