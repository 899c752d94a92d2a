"""The port's losses against the JAX package's at a tiny width, fp32 on the
CPU: the prompt-bank loss (its `add_*_` methods, value, image gradient), `losses.CLIP`
and `losses.OpenCLIP`, `Smoothness`, `Resize` and `SphericalDistance`. The
two tiny CLIP wrappers hold the same weights (the JAX wrapper's random init
carried across with `convert.clip_state_dict_from_jax`)."""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu import losses as jlosses
from perceptor_tpu.losses.prompt_bank import PromptBankLoss as JPromptBankLoss
from perceptor_tpu.models.clip.configs import CLIPConfig as JCLIPConfig
from perceptor_tpu.models.open_clip import OpenCLIP as JOpenCLIP
from perceptor_tpu_torch import convert, losses, models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss
from perceptor_tpu_torch.models.clip.configs import CLIPConfig

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

VALUE_ATOL = 1e-5
# max |gradient error| over max |gradient|
GRAD_RTOL = 1e-4

TINY = dict(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=2,
    vision_heads=2, context_length=12, vocab_size=64, text_width=20, text_layers=2,
    text_heads=2, quick_gelu=True,
)
CFG = CLIPConfig(**TINY)
PROMPTS = ["ab", "c d"]


class _TinyTokenizer:
    """Letters to ids 1..26, <sot> 62, <eot> 63: inside the tiny vocabulary
    on both sides (the port raises on larger ids where JAX clamps)."""

    sot_token, eot_token = 62, 63

    def encode(self, text):
        return [ord(ch) - ord("a") + 1 for ch in text if ch.isalpha()]


@pytest.fixture(scope="module")
def wrappers():
    jmodel = JOpenCLIP("ViT-B-32", "torch-port-losses", precision="fp32",
                       config=JCLIPConfig(**TINY), tokenizer=_TinyTokenizer())
    model = models.OpenCLIP("ViT-B-32", "torch-port-losses", precision="fp32", config=CFG,
                            tokenizer=_TinyTokenizer(), device="cpu")
    model.load_state_dict(convert.clip_state_dict_from_jax(
        jax.tree.map(np.asarray, jmodel.params), JCLIPConfig(**TINY)))
    return jmodel, model


def _images(seed, n=2, size=40):
    return np.random.default_rng(seed).uniform(size=(n, 3, size, size)).astype(np.float32)


BANK_CASES = {
    "matrix_default_weights": ((2, 16), None, [1, 1]),
    "vector_becomes_one_row": ((16,), None, [1]),
    "scalar_weight_broadcasts": ((3, 16), 2.0, [2, 2, 2]),
    "list_weights": ((3, 16), [1.0, 2.0, 3.0], [1, 2, 3]),
}


@pytest.mark.parametrize("case", list(BANK_CASES))
def test_prompt_bank_add_encodings(case):
    shape, weights, want_weights = BANK_CASES[case]
    encodings = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = PromptBankLoss(None).add_encodings_(encodings, weights)
    want = JPromptBankLoss(None).add_encodings_(encodings, weights)
    assert got.encodings.shape == (len(want_weights), 16)
    np.testing.assert_allclose(got.encodings.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.encodings.numpy(), np.asarray(want.encodings), atol=1e-6)
    np.testing.assert_array_equal(got.bank_weights.numpy(), want_weights)
    np.testing.assert_array_equal(np.asarray(want.bank_weights), want_weights)


def test_prompt_bank_concatenates_and_keeps_unit_encodings_bitwise():
    loss = PromptBankLoss(None)
    loss.add_encodings_(np.ones((1, 16), np.float32), weights=2.0)
    loss.add_encodings_(np.ones((3, 16), np.float32), [1.0, 2.0, 3.0])
    assert loss.encodings.shape == (4, 16)
    np.testing.assert_array_equal(loss.bank_weights.numpy(), [2, 1, 2, 3])
    unit = np.random.default_rng(2).normal(size=(1, 512))
    unit = torch.from_numpy((unit / np.linalg.norm(unit)).astype(np.float32))
    assert torch.equal(PromptBankLoss(None).add_encodings_(unit).encodings, unit)


def test_prompt_bank_forward_and_image_gradient_match_jax(wrappers):
    jmodel, model = wrappers
    bank = np.random.default_rng(1).normal(size=(3, 16)).astype(np.float32)
    weights = [1.0, 0.5, -0.25]
    jloss = JPromptBankLoss(jmodel, multiplier=2.0).add_encodings_(bank, weights)
    loss = PromptBankLoss(model, multiplier=2.0).add_encodings_(bank, weights)
    images = _images(3)
    x = torch.from_numpy(images).requires_grad_(True)
    value = loss(x)
    assert value.shape == ()
    j_value, j_grad = jax.value_and_grad(lambda im: jloss(im))(jnp.asarray(images))
    np.testing.assert_allclose(float(value.detach()), float(j_value), atol=VALUE_ATOL)
    (grad,) = torch.autograd.grad(value, x)
    j_grad = np.asarray(j_grad)
    assert np.abs(j_grad).max() > 0
    assert np.abs(grad.numpy() - j_grad).max() <= GRAD_RTOL * np.abs(j_grad).max()


def test_prompt_bank_add_texts_and_images_match_jax(wrappers):
    jmodel, model = wrappers
    reference = _images(4, n=1)
    jloss = JPromptBankLoss(jmodel).add_texts_(PROMPTS, [1.0, 2.0]).add_images_(
        jnp.asarray(reference))
    loss = PromptBankLoss(model).add_texts_(PROMPTS, [1.0, 2.0]).add_images_(
        torch.from_numpy(reference))
    assert loss.encodings.shape == (3, 16) and not loss.encodings.requires_grad
    np.testing.assert_allclose(loss.encodings.numpy(), np.asarray(jloss.encodings), atol=1e-5)
    np.testing.assert_array_equal(loss.bank_weights.numpy(), [1, 2, 1])
    images = _images(5)
    np.testing.assert_allclose(
        float(loss(torch.from_numpy(images))), float(jloss(jnp.asarray(images))),
        atol=VALUE_ATOL)
    np.testing.assert_allclose(
        loss.image_encodings(torch.from_numpy(images)).numpy(),
        np.asarray(jloss.image_encodings(jnp.asarray(images))), atol=1e-5)


def test_empty_bank_raises_and_mul_scales(wrappers):
    _, model = wrappers
    loss = PromptBankLoss(model)
    with pytest.raises(ValueError, match="empty prompt bank"):
        loss(torch.from_numpy(_images(6)))
    loss.add_encodings_(np.random.default_rng(7).normal(size=(16,)).astype(np.float32))
    images = torch.from_numpy(_images(6))
    base = float(loss(images))
    assert loss.mul_(3.0) is loss and loss.multiplier == 3.0
    np.testing.assert_allclose(float(loss(images)), 3.0 * base, rtol=1e-6)


def test_towers_get_no_gradient(wrappers):
    _, model = wrappers
    loss = PromptBankLoss(model).add_texts_(PROMPTS)
    x = torch.from_numpy(_images(8)).requires_grad_(True)
    loss(x).backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    assert all(p.grad is None for p in model.module.parameters())


def test_clip_loss_multiplier_and_text_off():
    assert losses.CLIP("ViT-B-32", config=CFG, device="cpu").multiplier == 1.0
    for name in ("ViT-L-14", "ViT-L-14-336"):
        assert losses.CLIP(name, config=CFG, device="cpu").multiplier == 0.01
    loss = losses.CLIP("ViT-B-32", config=CFG, device="cpu")
    assert loss.name == "ViT-B-32" and loss.model.weights == "openai"
    assert loss.model is models.CLIP("ViT-B-32", config=CFG, device="cpu")
    loss.add_text_off_(0.5)
    path = os.path.join(os.path.dirname(losses.__file__), "vectors", "textoff.json")
    with open(path) as f:
        vector = np.asarray(json.load(f)["ViT-B-32"], np.float64)
    assert loss.encodings.shape == (1, vector.shape[-1])
    np.testing.assert_allclose(
        loss.encodings.numpy()[0], vector.reshape(-1) / np.linalg.norm(vector), atol=1e-6)
    np.testing.assert_array_equal(loss.bank_weights.numpy(), [0.5])
    jloss = jlosses.CLIP("ViT-B-32", config=JCLIPConfig(**TINY)).add_text_off_(0.5)
    np.testing.assert_allclose(loss.encodings.numpy(), np.asarray(jloss.encodings), atol=1e-6)
    with pytest.raises(ValueError, match="no textoff"):
        losses.CLIP("ViT-H-14", config=CFG, device="cpu").add_text_off_()


def test_textoff_vectors_are_the_jax_packages():
    theirs = os.path.join(os.path.dirname(jlosses.__file__), "vectors", "textoff.json")
    ours = os.path.join(os.path.dirname(losses.__file__), "vectors", "textoff.json")
    assert filecmp.cmp(theirs, ours, shallow=False)


def test_open_clip_loss_keeps_the_weights_name():
    loss = losses.OpenCLIP("ViT-B-32", "some-weights", config=CFG, device="cpu")
    loss.add_encodings_(np.ones((1, 16), np.float32))
    assert loss.weights_name == "some-weights" and loss.architecture == "ViT-B-32"
    assert isinstance(loss.bank_weights, torch.Tensor) and loss.multiplier == 1.0
    assert isinstance(loss, losses.PromptBankLoss) and isinstance(loss, losses.LossInterface)


def test_smoothness_matches_jax_and_known_value():
    ramp = np.broadcast_to(np.linspace(0, 1, 8, dtype=np.float32), (1, 3, 8, 8)).copy()
    np.testing.assert_allclose(float(losses.Smoothness()(torch.from_numpy(ramp))),
                               (1 / 7) ** 2, rtol=1e-5)
    images = _images(9)
    x = torch.from_numpy(images).requires_grad_(True)
    value = losses.Smoothness()(x)
    j_value, j_grad = jax.value_and_grad(jlosses.Smoothness())(jnp.asarray(images))
    np.testing.assert_allclose(float(value.detach()), float(j_value), rtol=1e-6)
    (grad,) = torch.autograd.grad(value, x)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-8)


def test_resize_loss_matches_jax():
    a, b = _images(10), _images(11, size=24)
    got = losses.Resize(size=(16, 16))(torch.from_numpy(a), torch.from_numpy(b))
    want = jlosses.Resize(size=(16, 16))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got = losses.Resize()(torch.from_numpy(a), torch.from_numpy(b), size=(8, 12))
    want = jlosses.Resize()(jnp.asarray(a), jnp.asarray(b), size=(8, 12))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    same = torch.full((1, 3, 16, 16), 0.3)
    assert float(losses.Resize(size=(8, 8))(same, same)) == 0.0


def test_spherical_distance_loss_matches_jax(wrappers):
    jmodel, model = wrappers
    a, b = _images(12), _images(13, n=3)
    got = losses.SphericalDistance(model)(torch.from_numpy(a), torch.from_numpy(b))
    want = jlosses.SphericalDistance(jmodel)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), atol=VALUE_ATOL)


def test_a_loss_that_is_not_ported_says_so():
    # every loss of the JAX package is ported: the last three resolve, and
    # an unknown name is an AttributeError
    from perceptor_tpu_torch.losses.owlvit import OWLViT
    from perceptor_tpu_torch.losses.super_resolution import (
        SuperResolution,
        SuperResolutionDiscriminator,
    )

    assert (losses.OWLViT, losses.SuperResolution, losses.SuperResolutionDiscriminator) == (
        OWLViT, SuperResolution, SuperResolutionDiscriminator)
    with pytest.raises(AttributeError, match="has no attribute"):
        losses.NoSuchLoss
