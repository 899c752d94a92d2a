"""The port's guided-optimization loop against the JAX package's, fp32 on
the CPU at a tiny width: `make_guidance_step`, `optimize` and
`run_on_device` over a Raw drawer, a tiny CLIP prompt-bank loss and
`Smoothness`, on the same weights, the same init image and the same
optimizer rule; `guided_sample` on the tiny Stable Diffusion with a
prompt-bank loss and a cutout augment on fixed boxes; and
`utils/gradients`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perceptor_tpu import drawers as jdrawers
from perceptor_tpu import engine as jengine
from perceptor_tpu import losses as jlosses
from perceptor_tpu import transforms as jtransforms
from perceptor_tpu import utils as jutils
from perceptor_tpu.losses.prompt_bank import PromptBankLoss as JPromptBankLoss
from perceptor_tpu.models.clip.configs import CLIPConfig as JCLIPConfig
from perceptor_tpu.models.clip.tokenizer import SimpleTokenizer as JSimpleTokenizer
from perceptor_tpu.models.open_clip import OpenCLIP as JOpenCLIP
from perceptor_tpu.models.stable_diffusion import StableDiffusion as JStableDiffusion
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu_torch import convert, drawers, engine, losses, models, transforms, utils
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

STEPS = 8
# SGD: the same arithmetic on both sides, fp32 through CLIP and back
SGD_ATOL = 1e-5
# Adam's first steps are ~lr * sign(g): a pixel whose gradient is near zero
# can take another direction on the other side, so only the history is held,
# and looser
ADAM_HISTORY_RTOL = 1e-3
# the SGD steps must move the image far beyond SGD_ATOL, or parity would not
# show that the gradient is right
MIN_MOVE = 1e-2
SGD_LR = 200.0
WEIGHTS = (1.0, 0.5)

TINY = dict(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=2,
    vision_heads=2, context_length=12, vocab_size=64, text_width=20, text_layers=2,
    text_heads=2, quick_gelu=True,
)
SHAPE = (1, 3, 40, 40)


@pytest.fixture(scope="module")
def clip_losses():
    """(JAX loss, port loss): one bank of three random encodings."""
    jmodel = JOpenCLIP("ViT-B-32", "torch-port-optimize", precision="fp32",
                       config=JCLIPConfig(**TINY))
    model = models.OpenCLIP("ViT-B-32", "torch-port-optimize", precision="fp32",
                            config=CLIPConfig(**TINY), device="cpu")
    model.load_state_dict(convert.clip_state_dict_from_jax(
        jax.tree.map(np.asarray, jmodel.params), JCLIPConfig(**TINY)))
    bank = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    return (JPromptBankLoss(jmodel).add_encodings_(bank, [1.0, 0.5, 2.0]),
            losses.PromptBankLoss(model).add_encodings_(bank, [1.0, 0.5, 2.0]))


def _drawers(seed=0):
    return (jdrawers.Raw.random_fractal_image(SHAPE, seed=seed),
            drawers.Raw.random_fractal_image(SHAPE, seed=seed, device="cpu"))


def test_sgd_optimize_matches_jax(clip_losses):
    jloss, loss = clip_losses
    jdrawer, drawer = _drawers()
    start = drawer.pixels.detach().clone()
    _, j_history = jengine.optimize(
        jdrawer, [jloss, jlosses.Smoothness()], n_steps=STEPS, optimizer=optax.sgd(SGD_LR),
        loss_weights=WEIGHTS)
    out, history = engine.optimize(
        drawer, [loss, losses.Smoothness()], n_steps=STEPS,
        optimizer=lambda params: torch.optim.SGD(params, lr=SGD_LR), loss_weights=WEIGHTS)
    assert out is drawer and len(history) == STEPS and all(isinstance(h, float) for h in history)
    np.testing.assert_allclose(history, j_history, atol=SGD_ATOL)
    np.testing.assert_allclose(drawer.pixels.detach().numpy(), np.asarray(jdrawer.params),
                               atol=SGD_ATOL)
    assert history[-1] < history[0]
    assert float((drawer.pixels.detach() - start).abs().max()) >= MIN_MOVE
    # only the drawer was trained
    assert all(p.grad is None for p in loss.model.module.parameters())


def test_adam_optimize_matches_jax(clip_losses):
    jloss, loss = clip_losses
    jdrawer, drawer = _drawers(seed=1)
    _, j_history = jengine.optimize(jdrawer, [jloss, jlosses.Smoothness()], n_steps=STEPS)
    _, history = engine.optimize(drawer, [loss, losses.Smoothness()], n_steps=STEPS)
    np.testing.assert_allclose(history, j_history, rtol=ADAM_HISTORY_RTOL)
    assert history[-1] < history[0]
    # the default is Adam at lr 0.05: the first step moves every pixel ~0.05
    _, fresh = _drawers(seed=1)
    moved = (drawer.pixels.detach() - fresh.pixels.detach()).abs()
    assert 0.04 <= float(moved.max()) <= STEPS * 0.05 + 1e-3


def test_guidance_step_reports_each_loss_and_takes_an_optimizer(clip_losses):
    _, loss = clip_losses
    _, drawer = _drawers(seed=2)
    optimizer = torch.optim.SGD(drawer.parameters(), lr=0.0)
    step = engine.make_guidance_step(drawer, [loss, losses.Smoothness()], optimizer, WEIGHTS)
    aux = step()
    images = drawer.synthesize().detach()
    want = [float(loss(images)), float(losses.Smoothness()(images))]
    np.testing.assert_allclose(aux["losses"].numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(float(aux["loss"]), want[0] + 0.5 * want[1], rtol=1e-6)
    assert not aux["loss"].requires_grad
    # lr 0: a second step sees the same image
    np.testing.assert_allclose(float(step()["loss"]), float(aux["loss"]), rtol=1e-7)


class _PenalizedRaw(drawers.Raw):
    """A drawer with a penalty on its own parameters, as the JAX package's
    DeepImagePrior has one."""

    def loss(self, params=None):
        params = self.pixels if params is None else params
        return params.abs().mean()


def test_drawer_param_penalty_joins_the_objective():
    drawer = _PenalizedRaw(np.full(SHAPE, 0.5, np.float32), device="cpu")

    def image_loss(images):
        return images.square().mean()

    step = engine.make_guidance_step(
        drawer, [image_loss], lambda params: torch.optim.SGD(params, lr=0.0))
    expected = image_loss(drawer.synthesize()) + drawer.loss()
    np.testing.assert_allclose(float(step()["loss"]), float(expected.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(expected.detach()), 0.25 + 0.5, rtol=1e-6)
    # and in run_on_device, where the penalty's gradient moves the parameters
    params, history = engine.run_on_device(
        drawer, [lambda images: images.sum() * 0.0], drawer.params, n_steps=2)
    np.testing.assert_allclose(float(history[0]), 0.5, rtol=1e-6)
    assert float(params.max()) < 0.5


def test_callback_sees_every_step(clip_losses):
    _, loss = clip_losses
    _, drawer = _drawers(seed=3)
    seen = []
    _, history = engine.optimize(
        drawer, [loss], n_steps=3,
        callback=lambda i, params, aux: seen.append((i, params is drawer.pixels, float(aux["loss"]))))
    assert [i for i, _, _ in seen] == [0, 1, 2] and all(same for _, same, _ in seen)
    np.testing.assert_allclose([value for _, _, value in seen], history, rtol=1e-7)
    assert engine.optimize(drawer, [loss], n_steps=0)[1] == []


def test_run_on_device_matches_optimize_and_jax(clip_losses):
    jloss, loss = clip_losses
    jdrawer, drawer = _drawers(seed=4)
    start = drawer.pixels.detach().clone()
    params, history = engine.run_on_device(
        drawer, [loss, losses.Smoothness()], drawer.params, STEPS, loss_weights=WEIGHTS)
    assert isinstance(history, torch.Tensor) and history.shape == (STEPS,)
    assert not history.requires_grad and not params.requires_grad
    # the drawer's own parameters are left as they were
    assert torch.equal(drawer.pixels.detach(), start)
    j_params, j_history = jengine.run_on_device(
        jdrawer, [jloss, jlosses.Smoothness()], jdrawer.params, STEPS, loss_weights=WEIGHTS)
    np.testing.assert_allclose(history.numpy(), np.asarray(j_history), rtol=ADAM_HISTORY_RTOL)
    _, looped = engine.optimize(drawer, [loss, losses.Smoothness()], STEPS, loss_weights=WEIGHTS)
    np.testing.assert_allclose(history.numpy(), looped, atol=1e-6)
    np.testing.assert_allclose(params.numpy(), drawer.pixels.detach().numpy(), atol=1e-6)
    with pytest.raises(TypeError, match="factory"):
        engine.run_on_device(drawer, [loss], drawer.params, 1,
                             optimizer=torch.optim.SGD(drawer.parameters(), lr=0.1))


def test_run_on_device_takes_a_parameter_tuple_and_a_plain_callable():
    image = drawers.inits.fractal((1, 3, 32, 32), seed=5)
    drawer = drawers.JPEG(image, device="cpu")
    target = torch.full((1, 3, 32, 32), 0.5)

    def distance(images):
        return (images - target).square().mean()

    factory = lambda params: torch.optim.SGD(params, lr=50.0)  # noqa: E731
    params, history = engine.run_on_device(drawer, [distance], drawer.params, 4, factory)
    assert isinstance(params, tuple) and len(params) == 3
    assert float(history[-1]) < float(history[0])
    _, looped = engine.optimize(drawer, [distance], 4, factory)
    np.testing.assert_allclose(history.numpy(), looped, atol=1e-6)
    # a plain params -> images callable in place of a drawer
    pixels = torch.from_numpy(image)
    final, plain = engine.run_on_device(lambda p: p * 1.0, [distance], pixels, 3, factory)
    assert final.shape == pixels.shape and float(plain[-1]) < float(plain[0])


@pytest.fixture(scope="module")
def tiny_sd():
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        name, shape = str(getattr(path[-1], "key", path[-1])), np.shape(leaf)
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(out.astype(np.float32))

    jsd = JStableDiffusion("tiny", fp16=False, tokenizer=JSimpleTokenizer(merges=[]))
    jsd.params = jax.tree_util.tree_map_with_path(fill, jsd.params)
    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    sd.load_state_dicts(convert.stable_diffusion_state_dicts_from_jax(
        jsd.params, jsd_config.TINY_UNET, jsd_config.TINY_VAE, jsd_config.TINY_TEXT))
    return jsd, sd


def test_guided_sample_with_prompt_bank_loss_and_cutouts_matches_jax(tiny_sd, clip_losses):
    """The tolerance of tests/test_torch_engine.py: relative L2 1e-4 over
    the final latents and the per-step losses."""
    jsd, sd = tiny_sd
    jloss, loss = clip_losses
    cfg = jsd_config.TINY_TEXT
    rng = np.random.default_rng(50)
    latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    cond = rng.standard_normal((1, cfg.context_length, cfg.width)).astype(np.float32)
    pairs = sd.schedule_indices(3, from_index=700)
    boxes = np.array([[0.0, 0.0, 1.0, 1.0], [0.1, 0.2, 0.8, 0.9], [0.4, 0.0, 1.0, 0.6]], np.float32)
    kwargs = dict(guidance_scale=2000.0, clamp_value=1.0)
    j_latents, j_history = jengine.guided_sample(
        jsd, [jloss], jnp.asarray(latents), pairs, conditioning=jnp.asarray(cond),
        image_augment=lambda key, im: jtransforms.crop_and_resize(im, jnp.asarray(boxes), 32),
        **kwargs)
    t_latents, t_history = engine.guided_sample(
        sd, [loss], torch.from_numpy(latents), pairs, conditioning=torch.from_numpy(cond),
        image_augment=lambda gen, im: transforms.crop_and_resize(im, boxes, 32), **kwargs)

    def rel_l2(got, want):
        return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))

    assert rel_l2(t_latents.numpy(), j_latents) <= 1e-4
    assert rel_l2(t_history.numpy(), j_history) <= 1e-4
    unguided, _ = engine.guided_sample(
        sd, [loss], torch.from_numpy(latents), pairs, conditioning=torch.from_numpy(cond),
        guidance_scale=0.0, clamp_value=1.0)
    assert rel_l2(unguided.numpy(), t_latents.numpy()) >= 1e-2
    # random cutouts from a generator, as a user passes them
    out, history = engine.guided_sample(
        sd, [loss], torch.from_numpy(latents), pairs, conditioning=torch.from_numpy(cond),
        generator=torch.Generator().manual_seed(0),
        image_augment=lambda gen, im: transforms.random_cutouts(im, gen, 4, cut_size=32))
    assert torch.isfinite(out).all() and torch.isfinite(history).all()


GRADIENTS = [np.random.default_rng(60 + i).standard_normal((2, 3, 4)).astype(np.float32)
             for i in range(3)]
for _g in GRADIENTS:
    _g[np.abs(_g) < 0.4] = 0.0


@pytest.mark.parametrize("mode", ["sum", "nonzero_mean", "nonzero_scale_sum"])
def test_combine_gradients_matches_jax(mode):
    got = utils.combine_gradients([torch.from_numpy(g) for g in GRADIENTS], mode)
    want = jutils.combine_gradients([jnp.asarray(g) for g in GRADIENTS], mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_nonzero_helpers_match_jax():
    stacked = np.stack(GRADIENTS)
    np.testing.assert_allclose(
        utils.nonzero_mean(torch.from_numpy(stacked), axis=1).numpy(),
        np.asarray(jutils.nonzero_mean(jnp.asarray(stacked), axis=1)), rtol=1e-5, atol=1e-6)
    for axis in (None, 0, 2):
        np.testing.assert_allclose(
            utils.nonzero_scale(torch.from_numpy(stacked), axis=axis).numpy(),
            np.asarray(jutils.nonzero_scale(jnp.asarray(stacked), axis=axis)),
            rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown combine mode"):
        utils.combine_gradients([torch.zeros(2)], "median")
