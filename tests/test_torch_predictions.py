"""The port's schedules and prediction classes against the JAX package, fp32
on the CPU, on inputs from a seeded numpy rng: the linear-beta and cosine
schedules, the continuous Karras schedule, every method of
`IndexedEpsPredictions` and `VelocityPredictions` (the stochastic ones with
the noise replayed into JAX's formula), and the repairs to
`quantile_threshold` and `utils.cache`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceptor_tpu.predictions.base as jbase
from perceptor_tpu import predictions as jpred
from perceptor_tpu import schedules as jsched
from perceptor_tpu_torch import predictions as tpred
from perceptor_tpu_torch import schedules as tsched
from perceptor_tpu_torch.predictions.base import quantile_threshold
from perceptor_tpu_torch.transforms import dynamic_threshold
from perceptor_tpu_torch.utils import cache

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# single prediction methods and schedule functions: fp32 rounding only
ATOL = 1e-5
SHAPE = (2, 3, 8, 8)


def _np(x):
    return np.asarray(x)


def test_linear_schedule_matches_jax():
    for kwargs in ({}, {"n_timesteps": 250}):
        for got, want in zip(tsched.linear_alphas_sigmas(**kwargs), jsched.linear_alphas_sigmas(**kwargs)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_steps,from_ts,to_ts,rho", [(50, 1.0, 1e-2, 7.0), (7, 0.6, 0.05, 3.0)])
def test_velocity_schedule_ts_matches_jax(n_steps, from_ts, to_ts, rho):
    got = tsched.velocity_schedule_ts(n_steps, from_ts, to_ts, rho)
    want = jsched.velocity_schedule_ts(n_steps, from_ts, to_ts, rho)
    assert got.shape == (n_steps, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] > got[:, 1]).all() and (got[1:, 0] == got[:-1, 1]).all()


def test_cosine_schedule_functions_match_jax():
    t = np.linspace(0.01, 0.99, 23).astype(np.float32)
    alpha, sigma = np.cos(t * np.pi / 2), np.sin(t * np.pi / 2)
    log_snr = np.linspace(-9, 9, 23).astype(np.float32)
    cases = {
        "t_to_alpha_sigma": (t,), "alpha_sigma_to_t": (alpha, sigma), "sigma_to_t": (sigma,),
        "log_snr_to_alpha_sigma": (log_snr,), "alpha_sigma_to_log_snr": (alpha, sigma),
        "get_ddpm_schedule": (t,), "get_spliced_ddpm_cosine_schedule": (t,), "get_log_schedule": (t,),
    }
    for name, args in cases.items():
        want = getattr(jsched, name)(*(jnp.asarray(a) for a in args))
        for inputs in (args, tuple(torch.from_numpy(a) for a in args)):  # numpy and tensors
            got = getattr(tsched, name)(*inputs)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_allclose(g.numpy(), _np(w), atol=ATOL, rtol=1e-5, err_msg=name)
    # python floats are taken as fp32, and the functions are differentiable
    assert tsched.t_to_alpha_sigma(0.5)[0].dtype == torch.float32
    leaf = torch.tensor(0.3, requires_grad=True)
    tsched.t_to_alpha_sigma(leaf)[1].backward()
    np.testing.assert_allclose(float(leaf.grad), np.pi / 2 * np.cos(0.3 * np.pi / 2), rtol=1e-6)


def _pair(kind, seed=0):
    """The same predictions record on both sides."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=SHAPE).astype(np.float32)
    output = rng.standard_normal(SHAPE).astype(np.float32)
    if kind == "velocity":
        ts = np.array([0.8, 0.3], np.float32)
        jp = jpred.VelocityPredictions(from_diffused_images=jnp.asarray(images),
                                       from_ts=jnp.asarray(ts), velocities=jnp.asarray(output))
        tp = tpred.VelocityPredictions(from_diffused_images=torch.from_numpy(images),
                                       from_ts=torch.from_numpy(ts),
                                       velocities=torch.from_numpy(output))
        to, back = np.array([0.7, 0.2], np.float32), np.array([0.9, 0.5], np.float32)
    else:
        alphas, sigmas = tsched.linear_alphas_sigmas()
        idx = np.array([800, 300])
        jp = jpred.IndexedEpsPredictions(
            from_diffused_images=jnp.asarray(images), from_indices=jnp.asarray(idx),
            predicted_noise=jnp.asarray(output), schedule_alphas=jnp.asarray(alphas),
            schedule_sigmas=jnp.asarray(sigmas))
        tp = tpred.IndexedEpsPredictions(
            from_diffused_images=torch.from_numpy(images), from_indices=torch.from_numpy(idx),
            predicted_noise=torch.from_numpy(output), schedule_alphas=torch.from_numpy(alphas),
            schedule_sigmas=torch.from_numpy(sigmas))
        to, back = np.array([780, 250]), np.array([900, 420])
    return rng, jp, tp, to, back


@pytest.mark.parametrize("kind", ["indexed", "velocity"])
def test_every_deterministic_method_matches_jax(kind):
    rng, jp, tp, to, back = _pair(kind)
    other = rng.standard_normal(SHAPE).astype(np.float32)
    grad = rng.standard_normal(SHAPE).astype(np.float32)
    images = rng.uniform(size=SHAPE).astype(np.float32)
    prev_x0 = rng.standard_normal(SHAPE).astype(np.float32)
    prev_h = np.full((2, 1, 1, 1), 0.3, np.float32)
    j_other, t_other = jp._replace_output(jnp.asarray(other)), tp._replace_output(
        torch.from_numpy(other))
    t_to, t_back = torch.from_numpy(to), torch.from_numpy(back)

    def out(p):
        return p._output

    pairs = {
        "from_xs": (jp.from_xs, tp.from_xs),
        "from_alphas": (jp.from_alphas, tp.from_alphas),
        "from_sigmas": (jp.from_sigmas, tp.from_sigmas),
        "alphas": (jp.alphas(to), tp.alphas(t_to)),
        "sigmas scalar": (jp.sigmas(to[0]), tp.sigmas(to[0].item())),
        "denoised_xs": (jp.denoised_xs, tp.denoised_xs),
        "predicted_noise": (jp.predicted_noise, tp.predicted_noise),
        "denoised_images": (jp.denoised_images, tp.denoised_images),
        "step": (jp.step(to), tp.step(t_to)),
        "reverse_step": (jp.reverse_step(back), tp.reverse_step(t_back)),
        "correction": (out(j_other.correction(jp)), out(t_other.correction(tp))),
        "guided": (out(jp.guided(jnp.asarray(grad), 0.7, clamp_value=0.5)),
                   out(tp.guided(torch.from_numpy(grad), 0.7, clamp_value=0.5))),
        "classifier_free_guidance": (out(jp.classifier_free_guidance(j_other, 3.0)),
                                     out(tp.classifier_free_guidance(t_other, 3.0))),
        "dynamic_threshold": (out(jp.dynamic_threshold(0.9)), out(tp.dynamic_threshold(0.9))),
        "static_threshold": (out(jp.static_threshold()), out(tp.static_threshold())),
        "forced_denoised_xs": (out(jp.forced_denoised_xs(jnp.asarray(other))),
                               out(tp.forced_denoised_xs(torch.from_numpy(other)))),
        "forced_predicted_noise": (out(jp.forced_predicted_noise(jnp.asarray(other))),
                                   out(tp.forced_predicted_noise(torch.from_numpy(other)))),
        "forced_denoised_images": (out(jp.forced_denoised_images(jnp.asarray(images))),
                                   out(tp.forced_denoised_images(torch.from_numpy(images)))),
        "dpm++ first": (jp.dpm_solver_pp_step(to, jnp.asarray(prev_x0), jnp.asarray(prev_h), True)[0],
                        tp.dpm_solver_pp_step(t_to, torch.from_numpy(prev_x0),
                                              torch.from_numpy(prev_h), True)[0]),
        "dpm++ second": (jp.dpm_solver_pp_step(to, jnp.asarray(prev_x0), jnp.asarray(prev_h), False)[0],
                         tp.dpm_solver_pp_step(t_to, torch.from_numpy(prev_x0),
                                               torch.from_numpy(prev_h), False)[0]),
        "wasserstein_distance": (jp.wasserstein_distance(), tp.wasserstein_distance()),
        "wasserstein_square_distance": (jp.wasserstein_square_distance(),
                                        tp.wasserstein_square_distance()),
    }
    for name, (want, got) in pairs.items():
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=1e-5, err_msg=name)
    assert tp.dynamic_threshold(None) is tp
    # velocity's reverse_step hands back x-space, the eps class image space
    lo = float(tp.reverse_step(t_back).min())
    assert (lo < -0.5) if kind == "velocity" else (lo > -2.0)
    with pytest.raises(ValueError, match="1D"):
        tp.alphas(torch.zeros((2, 2)))


@pytest.mark.parametrize("kind", ["indexed", "velocity"])
def test_stochastic_methods_match_jax_formula_with_replayed_noise(kind, monkeypatch):
    _, jp, tp, to, back = _pair(kind, seed=1)
    t_to, t_back = torch.from_numpy(to), torch.from_numpy(back)
    key = jax.random.PRNGKey(0)

    def replay(seed):
        noise = torch.randn(SHAPE, generator=torch.Generator().manual_seed(seed))
        monkeypatch.setattr(jbase.jax.random, "normal",
                            lambda key, shape, dtype=None: jnp.asarray(noise.numpy()))
        return torch.Generator().manual_seed(seed)

    cases = {
        "step eta=0.5": (lambda: jp.step(to, eta=0.5, key=key),
                         lambda g: tp.step(t_to, eta=0.5, generator=g)),
        "resample_noise": (lambda: jp.resample_noise(to, key), lambda g: tp.resample_noise(t_to, g)),
        "resample": (lambda: jp.resample(to, key), lambda g: tp.resample(t_to, g)),
        "noisy_reverse_step": (lambda: jp.noisy_reverse_step(back, key),
                               lambda g: tp.noisy_reverse_step(t_back, g)),
    }
    for i, (name, (j_fn, t_fn)) in enumerate(cases.items()):
        generator = replay(40 + i)
        np.testing.assert_allclose(t_fn(generator).numpy(), _np(j_fn()), atol=ATOL, rtol=1e-5,
                                   err_msg=name)
    with pytest.raises(ValueError, match="generator"):
        tp.noisy_reverse_step(t_back)


@pytest.mark.parametrize("kind", ["indexed", "velocity", "latent"])
def test_detached_cuts_the_graph_and_replaces_the_input(kind):
    """The one method `engine.guided_sample` rebuilds its predictions with,
    whatever the class calls its diffused input."""
    if kind == "latent":
        alphas, sigmas = tsched.scaled_linear_alphas_sigmas()
        tp = tpred.LatentIndexedEpsPredictions(
            from_diffused_latents=torch.zeros(SHAPE), from_indices=torch.tensor([5, 6]),
            predicted_noise=torch.ones(SHAPE), schedule_alphas=torch.from_numpy(alphas),
            schedule_sigmas=torch.from_numpy(sigmas))
    else:
        tp = _pair(kind)[2]
    leaf = torch.full(SHAPE, 0.25, requires_grad=True)
    live = tp._replace_output(tp._output * leaf).replace(**{tp._FROM_FIELD: leaf * 2})
    assert live._output.requires_grad and live.from_xs.requires_grad
    cut = live.detached()
    assert not cut._output.requires_grad and not cut.from_xs.requires_grad
    assert torch.equal(cut._output, live._output.detach())
    assert torch.equal(cut.from_xs, live.from_xs.detach())
    new_input = torch.full(SHAPE, 0.75)
    replaced = live.detached(new_input)
    assert getattr(replaced, tp._FROM_FIELD) is new_input and type(replaced) is type(tp)
    assert torch.equal(replaced._output, cut._output)


def test_quantile_threshold_takes_bf16():
    """`torch.quantile` refuses bf16: the threshold is computed in fp32 and
    comes back (N, 1, 1, 1) fp32, equal to the fp32 input's."""
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32) * 3)
    low = xs.to(torch.bfloat16)
    got = quantile_threshold(low, 0.9, 1.0)
    assert got.shape == (2, 1, 1, 1) and got.dtype == torch.float32
    assert torch.equal(got, quantile_threshold(low.float(), 0.9, 1.0))
    np.testing.assert_allclose(got.numpy(), quantile_threshold(xs, 0.9, 1.0).numpy(), rtol=2e-2)
    images = (low + 1) / 2
    out = dynamic_threshold(images, 0.9)
    assert out.shape == images.shape and torch.isfinite(out.float()).all()


def test_cache_leaves_a_call_with_a_generator_unmemoized():
    """A generator's text is its address and its stream moves on: two calls
    that pass one are two instances; calls on plain arguments share one."""
    built = []

    @cache
    class Wrapper:
        def __init__(self, name, seed=0):
            built.append((name, seed))
            self.draw = torch.randn((), generator=seed).item() if isinstance(
                seed, torch.Generator) else None

    assert Wrapper("a") is Wrapper("a") and Wrapper("a", seed=1) is not Wrapper("a")
    gen = torch.Generator().manual_seed(0)
    first, second = Wrapper("a", seed=gen), Wrapper("a", seed=gen)
    assert first is not second and first.draw != second.draw
    assert Wrapper("a", gen) is not Wrapper("a", gen)
    assert len(built) == 6
