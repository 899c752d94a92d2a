"""The port's ADM family (`ADMUNet`, `GuidedDiffusion`) against the JAX
package at TINY size, fp32 on the CPU. The two models share weights: the JAX
tiny model's param tree, every leaf re-drawn with distinct values from a
seeded numpy rng, carried across with `convert.adm_state_dict_from_jax`.
JAX PRNG draws cannot be replayed by a `torch.Generator`, so stochastic
branches run with one fixed noise tensor fed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceptor_tpu.predictions.base as jbase
from perceptor_tpu.engine import guided_sample as j_guided_sample
from perceptor_tpu.models.guided_diffusion import ADMUNet as JADMUNet
from perceptor_tpu.models.guided_diffusion import GuidedDiffusion as JGuidedDiffusion
from perceptor_tpu.models.guided_diffusion import config as jadm_config
from perceptor_tpu.models.guided_diffusion import convert as jadm_convert
from perceptor_tpu_torch import convert, models
from perceptor_tpu_torch.engine import guided_sample
from perceptor_tpu_torch.models.guided_diffusion import ADMUNet, GuidedDiffusion
from perceptor_tpu_torch.models.guided_diffusion import config as adm_config
from perceptor_tpu_torch.models.guided_diffusion import unet as adm_unet
from perceptor_tpu_torch.models.guided_diffusion.unet import AttentionBlock
from perceptor_tpu_torch.ops import attention as tattn
from perceptor_tpu_torch.predictions import base as tbase

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides through the whole UNet: summation order only
UNET_ATOL = 1e-4
# max |gradient error| over max |gradient|
GRAD_RTOL = 1e-4
# relative L2 over the sampler's final images (k + 1 UNet evaluations)
LOOP_RTOL = 1e-4

# the second published layout at tiny width: plain norm add, conv resampling,
# a fixed head count (the "pixelart" options)
TINY_PLAIN = dict(
    image_size=32, model_channels=16, channel_mult=(1, 2), num_res_blocks=1, attention_ds=(2,),
    num_heads=2,
)
CONFIGS = {
    "tiny": (jadm_config.TINY, adm_config.TINY),
    "tiny_plain": (jadm_config.ADMConfig(**TINY_PLAIN), adm_config.ADMConfig(**TINY_PLAIN)),
}


def fill_params(params, seed):
    """Every leaf re-drawn: distinct values in every tensor, biases and norm
    affines included."""
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


def _np(x):
    return np.asarray(x)


def _rel_l2(got, want):
    want = _np(want)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


def _modules(name, seed=1):
    jcfg, cfg = CONFIGS[name]
    jmodule = JADMUNet(jcfg, dtype=jnp.float32)
    params = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)), jnp.zeros((1,)))
    params = fill_params(params["params"], seed)
    module = ADMUNet(cfg)
    module.load_state_dict(convert.adm_state_dict_from_jax(jax.tree_util.tree_map(_np, params), cfg))
    return jmodule, params, module.eval()


@pytest.fixture(scope="module")
def wrappers():
    jgd = JGuidedDiffusion("tiny", fp16=False)
    jgd.params = fill_params(jgd.params, seed=2)
    gd = GuidedDiffusion("tiny", fp16=False, device="cpu")
    gd.load_state_dict(convert.adm_state_dict_from_jax(
        jax.tree_util.tree_map(_np, jgd.params), adm_config.TINY))
    return jgd, gd


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unet_forward_and_input_gradient_match_jax(name):
    jmodule, params, module = _modules(name)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    ts = np.array([800.0, 12.0], np.float32)
    probe = rng.standard_normal((2, 6, 32, 32)).astype(np.float32)

    def j_out(x):
        return jmodule.apply({"params": params}, x, jnp.asarray(ts))

    want = j_out(jnp.asarray(xs))
    want_grad = jax.grad(lambda x: (j_out(x) * probe).sum())(jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_(True)
    got = module(x, torch.from_numpy(ts))
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), x)
    assert got.shape == (2, 6, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=UNET_ATOL)
    assert np.abs(got_grad.numpy() - _np(want_grad)).max() <= GRAD_RTOL * np.abs(want_grad).max()
    # a scalar timestep broadcasts
    np.testing.assert_allclose(
        module(torch.from_numpy(xs), torch.tensor(800.0))[0].detach().numpy(), _np(want)[0],
        atol=UNET_ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_round_trips_through_the_jax_converter_exactly(name):
    _, cfg = CONFIGS[name]
    module = ADMUNet(cfg)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    state = module.state_dict()
    back = convert.adm_state_dict_from_jax(jadm_convert.from_torch(state), cfg)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_qkv_is_head_interleaved_and_feeds_strided_views(monkeypatch):
    """The views handed to `attention` are (N, H, S, d) with unit head_dim
    stride, head q|k|v blocks side by side in the projection's output."""
    block = AttentionBlock(16, 2)
    seen = {}

    def record(q, k, v, **kwargs):
        seen.update(q=q, k=k, v=v)
        return tattn.dot_product_attention(q, k, v, scale=kwargs["scale"])

    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn((1, 16, 4, 4), generator=gen)
    monkeypatch.setattr(adm_unet, "attention", record)
    block(x)
    q, k, v = seen["q"], seen["k"], seen["v"]
    assert q.shape == (1, 2, 16, 8) and q.stride() == (16 * 48, 24, 48, 1)
    tokens = block.norm(x).reshape(1, 16, 16).transpose(1, 2)
    full = block.qkv(tokens)  # (1, S, 48): [h0 q|k|v, h1 q|k|v]
    assert torch.equal(k[0, 1], full[0, :, 24 + 8:24 + 16])
    assert torch.equal(v[0, 0], full[0, :, 16:24])


@pytest.mark.parametrize("channels,heads", [(16, 2), (24, 2)])
def test_attention_block_forced_flash_route_matches_the_plain_route(channels, heads):
    """head_dim 8, and 12 (zero-padded to 16 by the flash wrapper): forward
    and input gradient through the flash wrappers' plain versions."""
    gen = torch.Generator().manual_seed(6)
    block = AttentionBlock(channels, heads)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.randn((2, channels, 8, 8), generator=gen)
    probe = torch.randn(x.shape, generator=gen)
    results = {}
    for use_flash in (False, True):
        block.use_flash = use_flash
        xin = x.clone().requires_grad_(True)
        out = block(xin)
        (grad,) = torch.autograd.grad((out * probe).sum(), xin)
        results[use_flash] = (out.detach(), grad)
    np.testing.assert_allclose(results[True][0].numpy(), results[False][0].numpy(), atol=2e-5)
    np.testing.assert_allclose(results[True][1].numpy(), results[False][1].numpy(), atol=1e-4)


def test_schedule_tables_and_indices_match_jax(wrappers):
    jgd, gd = wrappers
    np.testing.assert_array_equal(gd.schedule_alphas.numpy(), _np(jgd.schedule_alphas))
    np.testing.assert_array_equal(gd.schedule_sigmas.numpy(), _np(jgd.schedule_sigmas))
    for kwargs in ({"n_steps": 20}, {"n_steps": 7, "from_index": 600, "rho": 3.0}):
        np.testing.assert_array_equal(gd.schedule_indices(**kwargs), jgd.schedule_indices(**kwargs))
    np.testing.assert_array_equal(gd.alphas([10, 500]).numpy(), _np(jgd.alphas(np.array([10, 500]))))
    np.testing.assert_array_equal(gd.sigmas(7).numpy(), _np(jgd.sigmas(7)))


def test_predictions_and_diffuse_images_match_jax(wrappers):
    jgd, gd = wrappers
    rng = np.random.default_rng(7)
    images = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
    noise = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    idx = np.array([700, 90])
    want = jgd.diffuse_images(jnp.asarray(images), jnp.asarray(idx), noise=jnp.asarray(noise))
    got = gd.diffuse_images(torch.from_numpy(images), torch.from_numpy(idx),
                            noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    jp = jgd.predictions(want, jnp.asarray(idx))
    with torch.no_grad():
        tp = gd.predictions(got, torch.from_numpy(idx))
    assert tp.predicted_noise.shape == (2, 3, 32, 32)  # the learned-sigma heads are dropped
    np.testing.assert_allclose(tp.predicted_noise.numpy(), _np(jp.predicted_noise), atol=UNET_ATOL)
    np.testing.assert_allclose(tp.denoised_images.numpy(), _np(jp.denoised_images), atol=1e-3)
    # one index serves the whole batch
    with torch.no_grad():
        one = gd.predictions(got, 700)
    np.testing.assert_allclose(
        one.predicted_noise.numpy(), _np(jgd.predictions(want, 700).predicted_noise), atol=UNET_ATOL)
    with pytest.raises(ValueError, match="unconditional"):
        gd.predictions(got, idx, conditioning=torch.zeros(1, 4))
    with pytest.raises(ValueError, match="generator"):
        gd.diffuse_images(got, idx)
    with pytest.raises(ValueError, match="divisible by 8"):
        gd.random_diffused((1, 3, 30, 32), torch.Generator().manual_seed(0))


def _fixed_noise(monkeypatch, shape, seed):
    """The same noise tensor for every draw on both sides."""
    noise = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(jbase.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tbase, "randn_like", lambda reference, generator: torch.from_numpy(noise))


@pytest.mark.parametrize("case", ["ddim", "dpm++", "ddim_eta", "img2img_eta"])
def test_sample_loop_matches_jax_program(wrappers, case, monkeypatch):
    """The eager loop against JAX's compiled `lax.scan` sampler from the same
    start; `eta > 0` with one fixed noise tensor on both sides."""
    jgd, gd = wrappers
    rng = np.random.default_rng(8)
    method = "dpm++" if case == "dpm++" else "ddim"
    eta = 0.5 if case.endswith("eta") else 0.0
    if case == "img2img_eta":
        pairs = gd.schedule_indices(4, from_index=600, rho=3.0)
        init = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
        start_noise = torch.from_numpy(rng.standard_normal(init.shape).astype(np.float32))
        start = gd.diffuse_images(torch.from_numpy(init), int(pairs[0, 0]), noise=start_noise).numpy()
    else:
        pairs = gd.schedule_indices(4, rho=3.0)
        start = (rng.standard_normal((2, 3, 32, 32)).astype(np.float32) + 1) / 2
    if eta:
        _fixed_noise(monkeypatch, start.shape, seed=9)
    run = jgd._build_sample_run(eta > 0, method)
    want = run(jgd.params, jnp.asarray(start), jnp.asarray(pairs), jax.random.PRNGKey(0),
               jnp.float32(eta))
    got = gd.sample_loop(torch.from_numpy(start), pairs, eta=eta,
                         generator=torch.Generator().manual_seed(0), method=method)
    assert got.shape == start.shape and torch.isfinite(got).all()
    assert _rel_l2(got.numpy(), want) <= LOOP_RTOL


def test_sample_end_to_end_is_finite_and_seeded_repeatable(wrappers):
    _, gd = wrappers
    first = gd.sample(n_images=2, n_steps=3, eta=0.3, generator=torch.Generator().manual_seed(1))
    again = gd.sample(n_images=2, n_steps=3, eta=0.3, generator=torch.Generator().manual_seed(1))
    other = gd.sample(n_images=2, n_steps=3, eta=0.3, generator=torch.Generator().manual_seed(2))
    assert first.shape == (2, 3, 32, 32) and torch.isfinite(first).all()
    assert torch.equal(first, again) and not torch.equal(first, other)
    # the default generator is seeded 0; img2img starts from the given images
    assert torch.equal(gd.sample(n_steps=2), gd.sample(n_steps=2))
    img2img = gd.sample(n_steps=3, from_index=300, init_images=first[:1].numpy(), method="dpm++")
    assert img2img.shape == (1, 3, 32, 32) and torch.isfinite(img2img).all()
    with pytest.raises(ValueError, match="unknown sampling method"):
        gd.sample(method="heun")
    with pytest.raises(ValueError, match="deterministic"):
        gd.sample(method="dpm++", eta=0.5)


@pytest.mark.parametrize("options", [{}, {"correction": True, "threshold": "static"}],
                         ids=["plain", "correction_static"])
def test_guided_sample_on_adm_matches_jax(wrappers, options):
    """`engine.guided_sample` over the pixel-space eps predictions: the loss
    gradient with respect to the diffused images, through the UNet."""
    jgd, gd = wrappers
    rng = np.random.default_rng(10)
    start = rng.uniform(size=(1, 3, 32, 32)).astype(np.float32)
    target = rng.uniform(size=(1, 3, 32, 32)).astype(np.float32)
    pairs = gd.schedule_indices(3, from_index=700)
    kwargs = dict(guidance_scale=40.0, clamp_value=1.0, loss_weights=(1.0, 0.5), **options)

    def objectives(target):
        return [lambda images: ((images - target) ** 2).sum(), lambda images: images.mean()]

    j_images, j_history = j_guided_sample(jgd, objectives(jnp.asarray(target)), jnp.asarray(start),
                                          pairs, **kwargs)
    t_images, t_history = guided_sample(gd, objectives(torch.from_numpy(target)),
                                        torch.from_numpy(start), pairs, **kwargs)
    assert _rel_l2(t_images.numpy(), j_images) <= LOOP_RTOL
    assert _rel_l2(t_history.numpy(), j_history) <= LOOP_RTOL
    unguided, _ = guided_sample(gd, objectives(torch.from_numpy(target)), torch.from_numpy(start),
                                pairs, **{**kwargs, "guidance_scale": 0.0})
    assert _rel_l2(unguided.numpy(), t_images.numpy()) >= 1e-2


def test_what_is_not_ported_says_so_and_cuda_is_the_default():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ADMUNet(dataclasses.replace(adm_config.TINY, spatial_transformer=True, context_dim=8))
    with pytest.raises(ValueError, match="Unknown model name"):
        GuidedDiffusion("huge", device="cpu")
    assert models.GuidedDiffusion is GuidedDiffusion
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GuidedDiffusion("tiny")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["standard", "pixelart"])
def test_full_width_construction_on_the_meta_device(name):
    """The published configs build and their attention sites have the
    expected head dims; no weight is materialized."""
    cfg = adm_config.MODEL_CONFIGS[name]
    with torch.device("meta"):
        module = ADMUNet(cfg)
    count = sum(p.numel() for p in module.parameters())
    blocks = [m for m in module.modules() if isinstance(m, AttentionBlock)]
    if name == "standard":
        assert {m.qkv.weight.shape[1] // m.n_heads for m in blocks} == {64}
        assert count > 5e8
    else:
        assert {m.n_heads for m in blocks} == {1}
    assert len(blocks) > 0 and count > 1e8
