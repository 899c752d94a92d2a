"""The port's deep image prior (`ops/deform_conv.py`,
`models/deep_image_prior.py`, `drawers/deep_image_prior.py` and
`convert.deep_image_prior_state_dict_from_jax`) against the JAX package on
the CPU, at narrow widths and 16px.

Both packages hold the same weights: the JAX `SkipNet`'s param tree, every
leaf re-drawn from a seeded numpy rng (BatchNorm scales near 1), carried
across with the converter. Inputs come from numpy with a seed. The JAX
`DeepImagePrior` wrapper is memoized: the tests build it unmemoized
(`__wrapped__`) or replace a drawer's own param dict, never a shared
instance's params.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perceptor_tpu import drawers as jdrawers
from perceptor_tpu import engine as jengine
from perceptor_tpu.losses.prompt_bank import PromptBankLoss as JPromptBankLoss
from perceptor_tpu.models import deep_image_prior as jdip
from perceptor_tpu.models.clip.configs import CLIPConfig as JCLIPConfig
from perceptor_tpu.models.open_clip import OpenCLIP as JOpenCLIP
from perceptor_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from perceptor_tpu_torch import convert, drawers, engine, losses, models
from perceptor_tpu_torch.core.dtypes import cast_matmul_params_bf16
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.deep_image_prior import SkipNet, offset_param_labels
from perceptor_tpu_torch.ops import deform_conv2d

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides: max error over max magnitude
RTOL = 1e-4
# the port's bf16 net against JAX's fp32 run, relative L2: within this factor
# of JAX's own bf16 error on the same input
BF16_FACTOR = 2.5
# SGD through the whole drawer and CLIP, 3 steps: relative L2 of the final
# images and of the loss history
SGD_RTOL = 1e-4
SGD_LR = 5.0
# the drawer's final images after 3 SGD steps: relative L2 of their change
# from the start against JAX's (see the test for why not SGD_RTOL)
KINK_RTOL = 5e-2
SIZE = 16
# narrow SkipNet widths; 2 + 8 = 10 decoder channels demote the 4 offset
# groups to 2
NARROW = dict(channels_down=8, channels_up=8, channels_skip=2)
LATENT_CHANNELS = 8
TINY_CLIP = dict(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=2,
    vision_heads=2, context_length=12, vocab_size=64, text_width=20, text_layers=2,
    text_heads=2, quick_gelu=True,
)


def fill_params(params, seed):
    """Every leaf re-drawn: weights N(0, 1 / fan_in), biases N(0, 0.1),
    BatchNorm scales near 1."""
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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


def _rel_l2(got, want):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (batch, channels, H, W, out, kernel, offset groups, stride, padding, dilation)
DEFORM_CASES = {
    "3x3_pad1_groups2": (2, 8, 9, 11, 6, 3, 2, 1, 1, 1),
    "stride2": (1, 4, 10, 10, 5, 3, 1, 2, 0, 1),
    "dilation2_groups3": (1, 6, 12, 12, 4, 3, 3, 1, 2, 2),
    "1x1_groups4": (1, 8, 7, 7, 3, 1, 4, 1, 0, 1),
}


@pytest.mark.parametrize("case", list(DEFORM_CASES), ids=list(DEFORM_CASES))
def test_deform_conv2d_and_its_gradients_match_jax(case):
    """Offsets of a few pixels, many samples outside the input; gradients
    to the input, offsets, weight and bias against `jax.grad`."""
    b, c, h, w, o, k, g, s, p, d = DEFORM_CASES[case]
    ho, wo = (h + 2 * p - (d * (k - 1) + 1)) // s + 1, (w + 2 * p - (d * (k - 1) + 1)) // s + 1
    rng = np.random.default_rng(sum(map(ord, case)))
    inputs = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((b, c, h, w), (b, 2 * g * k * k, ho, wo), (o, c, k, k), (o,))]
    inputs[1] *= 2.0
    probe = rng.standard_normal((b, o, ho, wo)).astype(np.float32)

    def jax_fn(*args):
        return j_deform_conv2d(*args, stride=s, padding=p, dilation=d)

    want = jax_fn(*map(jnp.asarray, inputs))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * probe), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, inputs))
    tensors = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    got = deform_conv2d(*tensors, stride=s, padding=p, dilation=d)
    grads = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), tensors)
    _close(got.detach().numpy(), want)
    for grad, want_grad in zip(grads, want_grads):
        _close(grad.numpy(), want_grad)


def test_deform_conv2d_computes_in_fp32_and_zero_offsets_are_a_conv():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 8, 12, 12)).astype(np.float32))
    weight = torch.from_numpy(rng.standard_normal((5, 8, 3, 3)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    offsets = torch.zeros((1, 2 * 4 * 9, 12, 12))
    got = deform_conv2d(x, offsets, weight, bias, padding=1)
    _close(got.numpy(), torch.nn.functional.conv2d(x, weight, bias, padding=1).numpy())
    xb, ob = x.bfloat16(), (2 * torch.from_numpy(
        rng.standard_normal((1, 2 * 2 * 9, 12, 12)).astype(np.float32))).bfloat16()
    got = deform_conv2d(xb, ob, weight.bfloat16(), bias, padding=1)
    want = j_deform_conv2d(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                           jnp.asarray(ob.float().numpy(), jnp.bfloat16),
                           jnp.asarray(weight.bfloat16().float().numpy(), jnp.bfloat16),
                           jnp.asarray(bias.numpy()), padding=1)
    assert got.dtype == torch.bfloat16
    # the same fp32 sums of the same bf16 inputs, rounded once
    _close(got.float().numpy(), np.asarray(want, np.float32), rtol=8e-3)
    with pytest.raises(ValueError, match="offset groups"):
        deform_conv2d(torch.zeros(1, 6, 5, 5), torch.zeros(1, 72, 5, 5), torch.zeros(2, 6, 3, 3),
                      padding=1)


# (offset type, scales): the deformable nets take one level, so that JAX
# compiles 3 deformable convs and not 6
SKIPNETS = {"none": 2, "1x1": 1, "full": 1}


@functools.lru_cache(maxsize=None)
def skipnet_case(offset_type):
    """(JAX SkipNet, its re-drawn params, latents, probe, JAX's fp32 output
    and weight gradients of sum(output * probe), JAX's bf16 output)."""
    jnet = jdip.SkipNet(offset_type=offset_type, n_scales=SKIPNETS[offset_type], **NARROW)
    shape = (1, LATENT_CHANNELS, SIZE, SIZE)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros(shape))["params"]
    params = fill_params(params, seed=list(SKIPNETS).index(offset_type) + 1)
    rng = np.random.default_rng(4)
    latents = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    probe = rng.standard_normal((1, 3, SIZE, SIZE)).astype(np.float32)

    def objective(params):
        out = jnet.apply({"params": params}, jnp.asarray(latents))
        return jnp.sum(out * probe), out

    (_, out), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
    bf16 = jax.jit(lambda p: jnet.clone(dtype=jnp.bfloat16).apply({"params": p}, latents))(params)
    return jnet, params, latents, probe, out, grads, bf16


def port_skipnet(offset_type, params):
    net = SkipNet(LATENT_CHANNELS, n_scales=SKIPNETS[offset_type], offset_type=offset_type,
                  **NARROW)
    net.load_state_dict(convert.deep_image_prior_state_dict_from_jax(_np_tree(params)))
    return net


@pytest.mark.parametrize("offset_type", list(SKIPNETS))
def test_skipnet_fp32_and_weight_gradients_match_jax(offset_type):
    """The net's output and the gradient of sum(output * probe) with respect
    to every weight, fp32. The LeakyReLU kinks make this gradient jump where
    a pre-activation crosses zero, so a point where one lies within rounding
    of zero cannot be compared (JAX's own gradient there moves by 1 % under
    a 1e-6 change of the latents); these latents and weights have none."""
    _, params, latents, probe, want, want_grads, _ = skipnet_case(offset_type)
    net = port_skipnet(offset_type, params)
    out = net(torch.from_numpy(latents))
    (out * torch.from_numpy(probe)).sum().backward()
    _close(out.detach().numpy(), want)
    want_grads = convert.deep_image_prior_state_dict_from_jax(_np_tree(want_grads))
    names = [name for name, _ in net.named_parameters()]
    assert sorted(names) == sorted(want_grads)
    got = np.concatenate([p.grad.numpy().ravel() for _, p in net.named_parameters()])
    _close(got, np.concatenate([want_grads[n].numpy().ravel() for n in names]))


@pytest.mark.parametrize("offset_type", list(SKIPNETS))
def test_skipnet_bf16_within_jax_bf16_error(offset_type):
    """bf16 convs (the deformable offsets rounded to bf16 before the fp32
    sampler), fp32 norms and head: the port's output against JAX's fp32 run
    within BF16_FACTOR of JAX's own bf16 build's error."""
    _, params, latents, _, want, _, jax_bf16 = skipnet_case(offset_type)
    net = cast_matmul_params_bf16(port_skipnet(offset_type, params))
    with torch.no_grad():
        got = net(torch.from_numpy(latents))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    if offset_type != "none":
        assert net.down_0_conv1.offset_conv.weight.dtype == torch.bfloat16
        assert net.up_0_conv1.offset_conv.out_channels == 2 * 2 * 9  # groups demoted to 2
    assert _rel_l2(got.numpy(), want) <= BF16_FACTOR * _rel_l2(jax_bf16, want)


def test_offset_labels_and_the_two_adam_groups_match_jax():
    """`offset_param_labels` names the same leaves as JAX's, and the
    model's `optimizer` (Adam, offsets at lr / 10) takes the same two steps
    as the JAX wrapper's `optimizer`, an `optax.multi_transform`; the
    published widths with deformable convs, on the JAX wrapper's own
    seeded weights."""
    jmodel = jdip.DeepImagePrior.__wrapped__((LATENT_CHANNELS, SIZE, SIZE), offset_type="full",
                                             fp16=False)
    params = jmodel.params
    model = models.DeepImagePrior((LATENT_CHANNELS, SIZE, SIZE), offset_type="full", fp16=False,
                                  device="cpu")
    model.module.load_state_dict(convert.deep_image_prior_state_dict_from_jax(_np_tree(params)))
    labels = jax.tree_util.tree_map(
        lambda label, leaf: np.full(np.shape(leaf), label == "offset", np.float32),
        jdip.offset_param_labels(params), params)
    want = {name: "offset" if bool(t.all()) else "main" for name, t in
            convert.deep_image_prior_state_dict_from_jax(labels).items()}
    assert offset_param_labels(model.module.named_parameters()) == want
    assert model.offset_param_labels() == want and 0 < sum(
        v == "offset" for v in want.values()) < len(want)

    jopt = jmodel.optimizer(0.01)
    state, jparams = jopt.init(params), params
    tparams = list(model.module.parameters())
    opt = model.optimizer(0.01)(tparams)
    assert [group["lr"] for group in opt.param_groups] == [0.01, 0.01 * 0.1]
    names = [name for name, _ in model.module.named_parameters()]
    for seed in (1, 2):
        grads = fill_params(params, seed=seed)
        updates, state = jopt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = convert.deep_image_prior_state_dict_from_jax(_np_tree(grads))
        for name, p in zip(names, tparams):
            p.grad = tgrads[name]
        opt.step()
    want = convert.deep_image_prior_state_dict_from_jax(_np_tree(jparams))
    for name, p in zip(names, tparams):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_latent_factories_match_jax():
    jmodel = jdip.DeepImagePrior.__wrapped__((LATENT_CHANNELS, SIZE, SIZE), fp16=False)
    model = models.DeepImagePrior((LATENT_CHANNELS, SIZE, SIZE), fp16=False, device="cpu")
    for kwargs in ({}, {"size": 2, "n_channels": 12, "log2_space": True}):
        np.testing.assert_allclose(model.fourier_latents(**kwargs).numpy(),
                                   np.asarray(jmodel.fourier_latents(**kwargs)), atol=1e-6)
    generator = torch.Generator().manual_seed(0)
    latents = model.random_latents(generator, size=2)
    assert latents.shape == (2, LATENT_CHANNELS, SIZE, SIZE) and 0.05 < float(latents.std()) < 0.2
    images = torch.rand((1, 3, SIZE, SIZE), generator=generator)
    noisy = model.noisy_image_latents(images, generator)
    assert noisy.shape == (1, LATENT_CHANNELS, SIZE, SIZE) and torch.isfinite(noisy).all()
    with pytest.raises(ValueError, match="offset_type"):
        models.DeepImagePrior((LATENT_CHANNELS, SIZE, SIZE), offset_type="2x2", device="cpu")


def drawer_pair(seed=0):
    """(JAX drawer, port drawer): the published 192-channel net at 32px on
    the same re-drawn weights, latents and a nonzero residual."""
    jdrawer = jdrawers.DeepImagePrior((SIZE, SIZE), n_feature_channels=LATENT_CHANNELS,
                                      seed=seed, fp16=False)
    residual = (0.05 * np.random.default_rng(9).standard_normal((1, 3, SIZE, SIZE))).astype(
        np.float32)
    jdrawer.params = {"network": fill_params(jdrawer.params["network"], seed=7),
                      "images": jnp.asarray(residual)}
    drawer = drawers.DeepImagePrior((SIZE, SIZE), n_feature_channels=LATENT_CHANNELS, seed=seed,
                                    fp16=False, device="cpu")
    drawer.model.module.load_state_dict(
        convert.deep_image_prior_state_dict_from_jax(_np_tree(jdrawer.params["network"])))
    with torch.no_grad():
        drawer.latents.copy_(torch.from_numpy(np.asarray(jdrawer.latents)))
        drawer.images.copy_(torch.from_numpy(residual))
    return jdrawer, drawer


def test_drawer_synthesize_and_loss_match_jax():
    jdrawer, drawer = drawer_pair()
    names = [name for name, _ in drawer.named_parameters()]
    assert names[-1] == "images" and all(n.startswith("model.module.") for n in names[:-1])
    assert [name for name, _ in drawer.named_buffers()] == ["latents",
                                                            "model.module.decorrelation"]
    with torch.no_grad():
        _close(drawer.synthesize().numpy(), jdrawer.synthesize())
        _close(drawer.loss().numpy(), jdrawer.loss())
        doubled = tuple(2 * p for p in drawer.parameters())
        jdoubled = jax.tree_util.tree_map(lambda p: 2 * p, jdrawer.params)
        _close(drawer.synthesize(doubled).numpy(), jdrawer.synthesize(jdoubled))
        _close(drawer.loss(doubled).numpy(), jdrawer.loss(jdoubled))


@pytest.fixture(scope="module")
def clip_losses():
    """(JAX loss, port loss): a tiny OpenCLIP tower at 32px and a bank of
    two random encodings."""
    jmodel = JOpenCLIP("ViT-B-32", "torch-port-dip", precision="fp32",
                       config=JCLIPConfig(**TINY_CLIP))
    loss = losses.OpenCLIP("ViT-B-32", "torch-port-dip", precision="fp32",
                           config=CLIPConfig(**TINY_CLIP), device="cpu")
    loss.model.load_state_dict(convert.clip_state_dict_from_jax(
        _np_tree(jmodel.params), JCLIPConfig(**TINY_CLIP)))
    bank = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    return (JPromptBankLoss(jmodel).add_encodings_(bank, [1.0, 0.5]),
            loss.add_encodings_(bank, [1.0, 0.5]))


def test_run_on_device_over_the_drawer_matches_jax(clip_losses):
    """3 SGD steps of `run_on_device` over the DIP drawer (the published
    192-channel net at 16px) under the tiny OpenCLIP loss at 32px (the loss
    resizes), the residual penalty included, against the JAX engine: the
    loss history within SGD_RTOL, and the final images' change from the
    start within KINK_RTOL of JAX's. The looser second bound is the net's:
    its gradient jumps at each LeakyReLU kink, so a pre-activation that the
    two packages round to opposite sides of zero moves a weight gradient by
    up to a percent (`test_skipnet_fp32_and_weight_gradients_match_jax`
    holds the gradient itself at RTOL where no pre-activation is that
    close). SGD, not Adam: Adam's first steps are ~lr * sign(g), which turns
    a near-zero gradient's rounding into a full step either way (Adam's
    update rule is held above, step for step)."""
    jloss, loss = clip_losses
    jdrawer, drawer = drawer_pair()
    jfinal, j_history = jengine.run_on_device(jdrawer, [jloss], jdrawer.params, n_steps=3,
                                              optimizer=optax.sgd(SGD_LR))
    final, history = engine.run_on_device(
        drawer, [loss], drawer.params, 3,
        optimizer=lambda params: torch.optim.SGD(params, lr=SGD_LR))
    assert _rel_l2(history.numpy(), j_history) <= SGD_RTOL
    with torch.no_grad():
        moved, start = drawer.synthesize(final) - drawer.synthesize(), drawer.synthesize()
    j_moved = np.asarray(jdrawer.synthesize(jfinal)) - start.numpy()
    assert _rel_l2(moved.numpy(), j_moved) <= KINK_RTOL
    assert float(moved.norm() / start.norm()) >= 1e-3  # the steps moved the image
