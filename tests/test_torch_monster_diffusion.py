"""The port's MonsterDiffusion family (`ops/upfirdn.py`, the EDM schedule
and predictions, `MonsterUNet`, the `MonsterDiffusion` samplers) against the
JAX package at TINY size, fp32 on the CPU. The models share weights: the
JAX tiny model's param tree, every leaf re-drawn from a seeded numpy rng,
carried across with `convert.monster_state_dict_from_jax`. JAX PRNG draws
cannot be replayed by a `torch.Generator`, so the stochastic churn runs with
one fixed noise tensor fed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceptor_tpu.predictions.base as jbase
from perceptor_tpu.models.monster_diffusion import MonsterDiffusion as JMonsterDiffusion
from perceptor_tpu.models.monster_diffusion import convert as jm_convert
from perceptor_tpu.models.monster_diffusion import net as jm_net
from perceptor_tpu.ops import upfirdn as jupfirdn
from perceptor_tpu.predictions import EDMPredictions as JEDMPredictions
from perceptor_tpu.schedules import edm as jedm
from perceptor_tpu_torch import convert, models
from perceptor_tpu_torch.models.monster_diffusion import MonsterDiffusion, net
from perceptor_tpu_torch.ops import flash_attention_kernel as tfa
from perceptor_tpu_torch.ops import upfirdn
from perceptor_tpu_torch.predictions import EDMPredictions
from perceptor_tpu_torch.predictions import base as tbase
from perceptor_tpu_torch.schedules import edm

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# FIR ops: a few fp32 products summed, both sides
FIR_ATOL = 1e-5
# fp32 on both sides through the whole net: max error over max magnitude
NET_RTOL = 1e-4
ALGEBRA_ATOL = 1e-5
# relative L2 over a sampler's final images
LOOP_RTOL = 1e-4


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def models_pair():
    # positional arguments key a memoized JAX instance of this module's own
    jmd = JMonsterDiffusion("tiny", False)
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        shape = np.shape(leaf)
        if str(getattr(path[-1], "key", path[-1])) == "weight":  # Fourier features
            out = rng.standard_normal(shape)
        elif len(shape) >= 2:
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(out.astype(np.float32))

    jmd.params = jax.tree_util.tree_map_with_path(fill, jmd.params)
    md = MonsterDiffusion("tiny", fp16=False, device="cpu")
    md.load_state_dict(convert.monster_state_dict_from_jax(jmd.params, md.config))
    return jmd, md


# -- ops/upfirdn.py ------------------------------------------------------------


UPFIRDN_CASES = {
    "filter_2d": dict(kernel=(4, 3), padding=(1, 2, 2, 1)),
    "up2_2d": dict(kernel=(4, 4), up=2, padding=(2, 1, 2, 1), gain=4.0),
    "down2_separable_flip": dict(kernel=(5,), down=2, padding=(2, 2, 2, 2), flip_filter=True),
    "up3_down2_crop": dict(kernel=(3, 4), up=(3, 2), down=(2, 1), padding=(3, -1, -2, 1)),
    "separable_up2_crop": dict(kernel=(4,), up=2, padding=(-1, 2, 0, -2), gain=1.7),
}


@pytest.mark.parametrize("case", list(UPFIRDN_CASES))
def test_upfirdn2d_and_its_gradient_match_jax(case):
    options = dict(UPFIRDN_CASES[case])
    rng = np.random.default_rng(1)
    kernel = rng.standard_normal(options.pop("kernel")).astype(np.float32)
    x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32)
    want = jupfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(kernel), **options)
    probe = rng.standard_normal(want.shape).astype(np.float32)
    want_grad = jax.grad(lambda v: jnp.sum(
        jupfirdn.upfirdn2d(v, jnp.asarray(kernel), **options) * probe))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = upfirdn.upfirdn2d(xt, torch.from_numpy(kernel), **options)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), xt)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=FIR_ATOL)
    np.testing.assert_allclose(got_grad.numpy(), _np(want_grad), atol=FIR_ATOL)


@pytest.mark.parametrize("name", ["fir_downsample_2x", "fir_upsample_2x", "filter2d",
                                  "upsample2d", "downsample2d"])
def test_fir_resamplers_and_their_gradients_match_jax(name):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 12, 10)).astype(np.float32)
    # the StyleGAN resamplers take normalized taps (`setup_filter`'s)
    args = () if name.startswith("fir_") else ([0.125, 0.375, 0.375, 0.125],)
    j_fn, t_fn = getattr(jupfirdn, name), getattr(upfirdn, name)
    want = j_fn(jnp.asarray(x), *args)
    probe = rng.standard_normal(want.shape).astype(np.float32)
    want_grad = jax.grad(lambda v: jnp.sum(j_fn(v, *args) * probe))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = t_fn(xt, *args)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), xt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=FIR_ATOL)
    np.testing.assert_allclose(got_grad.numpy(), _np(want_grad), atol=FIR_ATOL)
    np.testing.assert_allclose(upfirdn.setup_filter([1, 3, 3, 1], gain=2.0).numpy(),
                               _np(jupfirdn.setup_filter([1, 3, 3, 1], gain=2.0)), atol=0)


# -- EDM schedule and predictions ------------------------------------------------


def test_edm_schedule_and_preconditioning_match_jax():
    for n in (2, 10, 50):
        np.testing.assert_array_equal(edm.edm_schedule_ts(n), jedm.edm_schedule_ts(n))
    sigmas = np.array([0.01, 0.3, 1.0, 12.5, 80.0], np.float32)
    for got, want in zip(edm.edm_preconditioning(torch.from_numpy(sigmas)),
                         jedm.edm_preconditioning(jnp.asarray(sigmas))):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6)


def _edm_pair(seed=3):
    rng = np.random.default_rng(seed)
    denoised = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    diffused = rng.uniform(-2, 3, (2, 3, 8, 8)).astype(np.float32)
    ts = np.array([12.0, 0.4], np.float32)
    jp = JEDMPredictions(denoised_xs=jnp.asarray(denoised), diffused_images=jnp.asarray(diffused),
                         ts=jnp.asarray(ts))
    tp = EDMPredictions(denoised_xs=torch.from_numpy(denoised),
                        diffused_images=torch.from_numpy(diffused), ts=torch.from_numpy(ts))
    return rng, jp, tp


def test_edm_prediction_methods_match_jax(monkeypatch):
    rng, jp, tp = _edm_pair()
    to = np.array([8.0, 0.2], np.float32)
    previous = rng.uniform(-1, 2, (2, 3, 8, 8)).astype(np.float32)
    previous_ts = np.array([15.0, 0.5], np.float32)
    previous_eps = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    prev_x0 = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    prev_h = np.full((2, 1, 1, 1), 0.3, np.float32)
    grad = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    monkeypatch.setattr(jbase.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tbase, "randn_like", lambda reference, generator: torch.from_numpy(noise))
    t = torch.from_numpy
    pairs = {
        "eps": (jp.eps, tp.eps),
        "denoised_images": (jp.denoised_images, tp.denoised_images),
        "step": (jp.step(to), tp.step(t(to))),
        "heun_correction": (jp.heun_correction(jnp.asarray(previous), previous_ts,
                                               jnp.asarray(previous_eps)),
                            tp.heun_correction(t(previous), t(previous_ts), t(previous_eps))),
        "inject_noise": (jp.inject_noise(np.array([14.0, 0.5], np.float32),
                                         jax.random.PRNGKey(0)),
                         tp.inject_noise(t(np.array([14.0, 0.5], np.float32)), None)),
        "dpm++ first": (jp.dpm_solver_pp_step(to, jnp.asarray(prev_x0), jnp.asarray(prev_h),
                                              True)[0],
                        tp.dpm_solver_pp_step(t(to), t(prev_x0), t(prev_h), True)[0]),
        "dpm++ second": (jp.dpm_solver_pp_step(to, jnp.asarray(prev_x0), jnp.asarray(prev_h),
                                               False)[0],
                         tp.dpm_solver_pp_step(t(to), t(prev_x0), t(prev_h), False)[0]),
        "guided": (jp.guided(jnp.asarray(grad), 0.5, clamp_value=0.1).denoised_xs,
                   tp.guided(t(grad), 0.5, clamp_value=0.1).denoised_xs),
        "forced_predicted_noise": (jp.forced_predicted_noise(jnp.asarray(grad)).denoised_xs,
                                   tp.forced_predicted_noise(t(grad)).denoised_xs),
        "static_threshold": (jp.static_threshold().eps, tp.static_threshold().eps),
        "correction": (jp.correction(jp.replace(denoised_xs=jnp.asarray(prev_x0))).denoised_xs,
                       tp.correction(tp.replace(denoised_xs=t(prev_x0))).denoised_xs),
    }
    for name, (want, got) in pairs.items():
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ALGEBRA_ATOL, rtol=1e-5,
                                   err_msg=name)
    assert tp.detached().diffused_images is not tp.diffused_images


# -- the net and the preconditioned wrapper ----------------------------------------


def test_state_dict_round_trips_through_jax_from_torch(models_pair):
    """The port's state_dict (fixed FIR buffers included) is a stream the
    JAX converter reads back to the same tree."""
    jmd, md = models_pair
    back = jm_convert.from_torch({k: v.numpy() for k, v in md.module.state_dict().items()},
                                 jm_net.TINY)
    want = dict(jax.tree_util.tree_leaves_with_path(jmd.params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(_np(got[path]), _np(leaf), err_msg=str(path))
    assert torch.equal(md.module.u_net.d_blocks[1][1].kernel, upfirdn.fir_taps("linear"))
    # the published config: the same parameter shapes as JAX's tree
    with torch.device("meta"):
        full = net.MonsterUNet(net.MODEL_CONFIGS["all"])
    shapes = jax.eval_shape(jm_net.MonsterUNet(jm_net.MODEL_CONFIGS["all"]).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 3, 48, 48)), jnp.zeros((1,)),
                            jnp.zeros((1, 9)))
    assert sum(p.numel() for p in full.parameters()) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_net_and_predictions_match_jax(models_pair):
    jmd, md = models_pair
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(2, 3, 16, 16)).astype(np.float32)
    ts = np.array([20.0, 0.05], np.float32)
    aug = rng.standard_normal((2, 9)).astype(np.float32)
    want = jmd.denoised_(jnp.asarray(images), jnp.asarray(ts), jnp.asarray(aug))
    tfa.reset_launches()
    with torch.no_grad():
        got = md.denoised_(torch.from_numpy(images), torch.from_numpy(ts), torch.from_numpy(aug))
        predictions = md.predictions(torch.from_numpy(images), 3.0)
    assert not any(tfa.LAUNCHES.values())
    scale = float(np.abs(_np(want)).max())
    assert float(np.abs(got.numpy() - _np(want)).max()) <= NET_RTOL * scale
    j_pred = jmd.predictions(jnp.asarray(images), 3.0)
    np.testing.assert_allclose(predictions.denoised_xs.numpy(), _np(j_pred.denoised_xs),
                               atol=NET_RTOL * float(np.abs(_np(j_pred.denoised_xs)).max()))
    assert predictions.ts.shape == (2,) and md.forward == md.predictions
    # the inner net with no mapping condition, directly
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    want = jax.jit(jm_net.MonsterUNet(jm_net.TINY).apply)(
        {"params": jmd.params}, jnp.asarray(x), jnp.asarray([0.3, -1.0]))
    with torch.no_grad():
        got = md.module(torch.from_numpy(x), torch.tensor([0.3, -1.0]))
    assert float(np.abs(got.numpy() - _np(want)).max()) <= NET_RTOL * float(np.abs(_np(want)).max())


def test_churn_and_diffusion_utilities_match_jax(models_pair, monkeypatch):
    jmd, md = models_pair
    ts = np.array([0.01, 0.05, 3.0, 50.0, 79.0], np.float32)
    np.testing.assert_allclose(md.gamma(ts, 10).numpy(), _np(jmd.gamma(ts, 10)), rtol=1e-7)
    np.testing.assert_allclose(md.reversed_ts(ts, 4).numpy(), _np(jmd.reversed_ts(ts, 4)),
                               rtol=1e-7)
    np.testing.assert_array_equal(md.schedule_ts(7), jmd.schedule_ts(7))
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(2, 3, 16, 16)).astype(np.float32)
    noise = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    monkeypatch.setattr(jbase.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tbase, "randn_like", lambda reference, generator: torch.from_numpy(noise))
    from_ts, reversed_ts = np.array([5.0, 0.1], np.float32), np.array([6.0, 0.12], np.float32)
    np.testing.assert_allclose(
        md.inject_noise(torch.from_numpy(images), from_ts, reversed_ts).numpy(),
        _np(jmd.inject_noise(jnp.asarray(images), from_ts, reversed_ts, jax.random.PRNGKey(0))),
        atol=ALGEBRA_ATOL)
    np.testing.assert_allclose(
        md.diffuse(torch.from_numpy(images), from_ts, noise=torch.from_numpy(noise)).numpy(),
        _np(jmd.diffuse(jnp.asarray(images), from_ts, noise=jnp.asarray(noise))),
        atol=ALGEBRA_ATOL)
    ts = md.training_ts(4000, torch.Generator().manual_seed(0))
    assert bool((ts > 0).all()) and abs(float(ts.log().mean()) + 1.2) < 0.1
    with pytest.raises(ValueError, match="stochastic"):
        md.diffuse(torch.from_numpy(images), from_ts)


# -- samplers --------------------------------------------------------------------


def test_elucidated_step_matches_jax_with_replayed_noise(models_pair, monkeypatch):
    """n_evaluations 6: two churned Heun pairs and the final churned denoise,
    every churn drawing the one fixed noise tensor on both sides."""
    jmd, md = models_pair
    rng = np.random.default_rng(6)
    start = rng.uniform(-20, 20, (2, 3, 16, 16)).astype(np.float32)
    noise = rng.standard_normal(start.shape).astype(np.float32)
    monkeypatch.setattr(jbase.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tbase, "randn_like", lambda reference, generator: torch.from_numpy(noise))
    want = jmd.sample(2, n_evaluations=6, diffused_images=jnp.asarray(start))
    got = md.sample(2, n_evaluations=6, diffused_images=torch.from_numpy(start))
    assert got.shape == (2, 3, 16, 16) and float(got.min()) >= 0 and float(got.max()) <= 1
    assert _rel_l2(got, want) <= LOOP_RTOL
    assert md.elucidated_sample == md.sample


@pytest.mark.parametrize("sampler", ["dpm_solver_sample", "linear_multistep_sample"])
def test_deterministic_samplers_match_jax(models_pair, sampler):
    jmd, md = models_pair
    start = np.random.default_rng(7).uniform(-20, 20, (2, 3, 16, 16)).astype(np.float32)
    want = getattr(jmd, sampler)(2, n_evaluations=5, diffused_images=jnp.asarray(start))
    got = getattr(md, sampler)(2, n_evaluations=5, diffused_images=torch.from_numpy(start))
    assert got.shape == (2, 3, 16, 16) and torch.isfinite(got).all()
    assert _rel_l2(got, want) <= LOOP_RTOL


def test_linear_multistep_coefficients_and_default_start(models_pair):
    _, md = models_pair
    sigmas = edm.edm_sigmas(8)
    for order, from_index in ((1, 0), (2, 1), (3, 4), (4, 6)):
        for k in range(order):
            assert md.linear_multistep_coeff(order, sigmas, from_index, k) == (
                JMonsterDiffusion.linear_multistep_coeff(order, sigmas, from_index, k))
    with pytest.raises(ValueError, match="too high"):
        md.linear_multistep_coeff(3, sigmas, 1, 0)
    # without a start the noise comes from a generator seeded 0
    images = md.dpm_solver_sample(1, n_evaluations=3)
    assert torch.equal(images, md.dpm_solver_sample(
        1, n_evaluations=3, generator=torch.Generator().manual_seed(0)))


def test_monster_diffusion_is_exported_and_needs_cuda():
    assert models.MonsterDiffusion is MonsterDiffusion
    with pytest.raises(ValueError, match="Unknown model name"):
        MonsterDiffusion("huge", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MonsterDiffusion("all")
