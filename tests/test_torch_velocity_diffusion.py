"""The port's v-diffusion family (`VDiffusionUNet`, the PNDM samplers,
`VelocityDiffusion`, the diffusion-prior loss and the `BruteDiffusion`
drawer) against the JAX package at TINY size, fp32 on the CPU. The models
share weights: the JAX tiny model's param tree, every leaf re-drawn with
distinct values from a seeded numpy rng, carried across with
`convert.vnet_state_dict_from_jax`. JAX PRNG draws cannot be replayed by a
`torch.Generator`, so stochastic branches run with the noise given, or with
one fixed noise tensor fed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceptor_tpu.predictions.base as jbase
from perceptor_tpu import drawers as jdrawers
from perceptor_tpu.engine import guided_sample as j_guided_sample
from perceptor_tpu.losses.velocity_diffusion import VelocityDiffusion as JVelocityLoss
from perceptor_tpu.models.velocity_diffusion import VDiffusionUNet as JVDiffusionUNet
from perceptor_tpu.models.velocity_diffusion import VelocityDiffusion as JVelocityDiffusion
from perceptor_tpu.models.velocity_diffusion import configs as jconfigs
from perceptor_tpu.models.velocity_diffusion import convert as jv_convert
from perceptor_tpu.models.velocity_diffusion import pndm as jpndm
from perceptor_tpu_torch import convert, drawers, engine, losses, models
from perceptor_tpu_torch.models.velocity_diffusion import VDiffusionUNet, VelocityDiffusion, configs
from perceptor_tpu_torch.models.velocity_diffusion import pndm
from perceptor_tpu_torch.predictions import base as tbase

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides through the whole UNet: summation order only
UNET_ATOL = 1e-4
# max |gradient error| over max |gradient|
GRAD_RTOL = 1e-4
# relative L2 over a sampler's final images
LOOP_RTOL = 1e-4
ALGEBRA_ATOL = 1e-5

# wikiart's options at tiny width: no attention norm, [skip, main] concat,
# nearest upsampling, the log-SNR timestep input, a narrower Fourier std
WIKIART_STYLE = dict(attn_norm=False, skip_first=True, upsample_method="nearest",
                     timestep_input="log_snr", fourier_std=0.2, head_div=16)
CONFIGS = {
    "tiny": (jconfigs.TINY, configs.TINY),
    "tiny_conditioned": (jconfigs.TINY_CONDITIONED, configs.TINY_CONDITIONED),
    "tiny_wikiart": (dataclasses.replace(jconfigs.TINY, **WIKIART_STYLE),
                     dataclasses.replace(configs.TINY, **WIKIART_STYLE)),
}


def fill_params(params, seed):
    """Every leaf re-drawn: distinct values in every tensor."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(leaf)
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "weight":  # FourierFeatures
            out = rng.standard_normal(shape)
        elif len(shape) >= 2:
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(out.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, params)


def _np(x):
    return np.asarray(x)


def _numpy_tree(params):
    return jax.tree_util.tree_map(_np, params)


def _rel_l2(got, want):
    want = _np(want)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


def _clip_dim(cfg):
    return cfg.mapping.clip_dim if cfg.mapping is not None else None


def _modules(name, seed=1):
    jcfg, cfg = CONFIGS[name]
    jmodule = JVDiffusionUNet(jcfg, dtype=jnp.float32)
    extra = () if jcfg.mapping is None else (jnp.zeros((1, jcfg.mapping.clip_dim)),)
    params = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)), jnp.zeros((1,)), *extra)
    params = fill_params(params["params"], seed)
    module = VDiffusionUNet(cfg)
    module.load_state_dict(convert.vnet_state_dict_from_jax(_numpy_tree(params), cfg))
    return jmodule, params, module.eval()


@pytest.fixture(scope="module")
def wrappers():
    out = {}
    for name in ("tiny", "tiny_conditioned"):
        jvd = JVelocityDiffusion(name, fp16=False)
        jvd.params = fill_params(jvd.params, seed=2)
        vd = VelocityDiffusion(name, fp16=False, device="cpu")
        vd.load_state_dict(convert.vnet_state_dict_from_jax(_numpy_tree(jvd.params), vd.config))
        out[name] = (jvd, vd)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unet_forward_and_input_gradient_match_jax(name):
    jmodule, params, module = _modules(name)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    ts = np.array([0.9, 0.15], np.float32)
    probe = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    dim = _clip_dim(module.config)
    embed = None if dim is None else rng.standard_normal((2, dim)).astype(np.float32)
    j_extra = () if embed is None else (jnp.asarray(embed),)
    t_extra = () if embed is None else (torch.from_numpy(embed),)

    def j_out(x):
        return jmodule.apply({"params": params}, x, jnp.asarray(ts), *j_extra)

    want = j_out(jnp.asarray(xs))
    want_grad = jax.grad(lambda x: (j_out(x) * probe).sum())(jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_(True)
    got = module(x, torch.from_numpy(ts), *t_extra)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), x)
    assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=UNET_ATOL)
    assert np.abs(got_grad.numpy() - _np(want_grad)).max() <= GRAD_RTOL * np.abs(want_grad).max()
    if dim is not None:
        with pytest.raises(ValueError, match="conditioned"):
            module(x, torch.from_numpy(ts))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_walks_through_the_jax_stream_converter_exactly(name):
    """The JAX converter consumes keys in order, by suffix: a module that
    registered its parameters in another order would be mis-assigned without
    an error. Distinct random values in every tensor; both directions."""
    jcfg, cfg = CONFIGS[name]
    module = VDiffusionUNet(cfg)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    state = module.state_dict()
    tree = jv_convert.from_torch(state, jcfg)
    back = convert.vnet_state_dict_from_jax(tree, cfg)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    # and the tree the walk gives is the one the JAX module's forward reads
    _, params, _ = _modules(name, seed=5)
    again = jv_convert.from_torch(_state_in_module_order(cfg, _numpy_tree(params)), jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(again)
    flat_b = jax.tree_util.tree_leaves_with_path(_numpy_tree(params))
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))


def _state_in_module_order(cfg, params):
    module = VDiffusionUNet(cfg)
    module.load_state_dict(convert.vnet_state_dict_from_jax(params, cfg))
    return module.state_dict()


def test_no_published_config_has_a_flash_site():
    """Attention only at <= 16 x 16 tokens: S <= 256, below the flash route."""
    for name in ("yfcc_2", "yfcc_1", "cc12m_1_cfg", "wikiart"):
        cfg = configs.MODEL_CONFIGS[name]
        jcfg = jconfigs.MODEL_CONFIGS[name]  # the port's copy says what JAX's says
        assert all(getattr(cfg, f.name) == getattr(jcfg, f.name)
                   for f in dataclasses.fields(cfg) if f.name != "mapping")
        assert (cfg.mapping is None) == (jcfg.mapping is None)
        for level in cfg.attn_levels:
            side = cfg.image_size[0] // 2**level
            assert side * side <= 256


def _eps_fns():
    """One synthetic noise model on both sides."""
    def j_eps(xs, ts):
        return jnp.tanh(xs) * jnp.cos(ts)[:, None, None, None] + 0.1 * jnp.sin(3 * xs)

    def t_eps(xs, ts):
        return torch.tanh(xs) * torch.cos(ts)[:, None, None, None] + 0.1 * torch.sin(3 * xs)

    return j_eps, t_eps


def test_pndm_steps_and_samplers_match_jax():
    j_eps, t_eps = _eps_fns()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    old = [rng.standard_normal(x.shape).astype(np.float32) for _ in range(3)]
    t_1, t_2 = np.array([0.8, 0.6], np.float32), np.array([0.7, 0.45], np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jt, tt = (jnp.asarray(t_1), jnp.asarray(t_2)), (torch.from_numpy(t_1), torch.from_numpy(t_2))
    pairs = {
        "transfer": (jpndm.transfer(jx, jnp.asarray(old[0]), *jt),
                     pndm.transfer(tx, torch.from_numpy(old[0]), *tt)),
        "prk_step": (jpndm.prk_step(j_eps, jx, *jt), pndm.prk_step(t_eps, tx, *tt)),
        "plms_step": (jpndm.plms_step(j_eps, jx, [jnp.asarray(e) for e in old], *jt),
                      pndm.plms_step(t_eps, tx, [torch.from_numpy(e) for e in old], *tt)),
    }
    ts = np.array([0.9, 0.8, 0.65, 0.5, 0.3, 0.1, 0.0], np.float32)
    for n in (3, 7):  # warm-up only, and warm-up plus multistep
        pairs[f"plms_sample {n}"] = (jpndm.plms_sample(j_eps, jx, ts[:n]),
                                     pndm.plms_sample(t_eps, tx, ts[:n]))
    pairs["prk_sample"] = (jpndm.prk_sample(j_eps, jx, ts), pndm.prk_sample(t_eps, tx, ts))
    pairs["ddim_reverse_sample"] = ((jpndm.ddim_reverse_sample(j_eps, jx, ts[::-1][1:]),),
                                    (pndm.ddim_reverse_sample(t_eps, tx, ts[::-1][1:].copy()),))
    for name, (want, got) in pairs.items():
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), _np(w), atol=ALGEBRA_ATOL, rtol=1e-5, err_msg=name)


def test_schedule_and_diffusion_utilities_match_jax(wrappers, monkeypatch):
    jvd, vd = wrappers["tiny"]
    for kwargs in ({"n_steps": 12}, {"n_steps": 5, "from_ts": 0.7, "to_ts": 0.05, "rho": 3.0}):
        got = vd.schedule_ts(**kwargs)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jvd.schedule_ts(**kwargs))
    sig = np.array([0.1, 0.5, 0.99], np.float32)
    np.testing.assert_allclose(vd.sigmas_to_ts(sig).numpy(), _np(jvd.sigmas_to_ts(sig)), atol=1e-6)
    ts = np.array([0.3, 0.8], np.float32)
    np.testing.assert_allclose(vd.alphas(ts).numpy(), _np(jvd.alphas(ts)), atol=1e-6)
    np.testing.assert_allclose(vd.sigmas(0.4).numpy(), _np(jvd.sigmas(0.4)), atol=1e-6)
    assert vd.shape == jvd.shape == (3, 32, 32) and not vd.conditioned

    rng = np.random.default_rng(7)
    images = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    want = jvd.diffuse(jnp.asarray(images), ts, noise=jnp.asarray(noise))
    got = vd.diffuse(torch.from_numpy(images), ts, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    monkeypatch.setattr(jbase.jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(noise))
    reversed_ts = np.array([0.5, 0.9], np.float32)
    want = jvd.inject_noise(want, ts, reversed_ts, jax.random.PRNGKey(0))
    np.testing.assert_allclose(
        vd.inject_noise(got, ts, reversed_ts, None, noise=torch.from_numpy(noise)).numpy(),
        _np(want), atol=1e-5)
    # from a generator: seeded, of the right statistics
    a = vd.inject_noise(got, ts, reversed_ts, torch.Generator().manual_seed(3))
    b = vd.inject_noise(got, ts, reversed_ts, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="generator"):
        vd.diffuse(got, ts)
    with pytest.raises(ValueError, match="generator"):
        vd.inject_noise(got, ts, reversed_ts, None)


@pytest.mark.parametrize("name", ["tiny", "tiny_conditioned"])
def test_predictions_match_jax(wrappers, name):
    jvd, vd = wrappers[name]
    rng = np.random.default_rng(8)
    diffused = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
    ts = np.array([0.9, 0.2], np.float32)
    dim = _clip_dim(vd.config)
    shapes = [None] if dim is None else [(2, dim), (1, 2, dim)]  # (N, D) and stacked (1, N, D)
    for shape in shapes:
        cond = None if shape is None else rng.standard_normal(shape).astype(np.float32)
        jp = jvd.predictions(jnp.asarray(diffused), ts, None if cond is None else jnp.asarray(cond))
        with torch.no_grad():
            tp = vd.predictions(torch.from_numpy(diffused), ts,
                                None if cond is None else torch.from_numpy(cond))
        np.testing.assert_allclose(tp.velocities.numpy(), _np(jp.velocities), atol=UNET_ATOL)
        np.testing.assert_allclose(tp.denoised_images.numpy(), _np(jp.denoised_images),
                                   atol=UNET_ATOL)
    # a scalar t serves the whole batch
    with torch.no_grad():
        got = vd.velocities(torch.from_numpy(diffused), 0.5,
                            None if cond is None else torch.from_numpy(cond))
    want = jvd.velocities(jnp.asarray(diffused), 0.5, None if cond is None else jnp.asarray(cond))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=UNET_ATOL)


def _fixed_noise(monkeypatch, shape, seed):
    """The same noise tensor for every draw on both sides."""
    noise = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(jbase.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tbase, "randn_like", lambda reference, generator: torch.from_numpy(noise))


SAMPLE_CASES = {
    "ddim": ("tiny", dict(method="ddim")),
    "ddim_correction": ("tiny", dict(method="ddim", correction=True)),
    "ddim_eta_churn_correction": ("tiny", dict(method="ddim", eta=0.4, churn=0.05, correction=True)),
    "plms": ("tiny", dict(method="plms")),
    "prk": ("tiny", dict(method="prk")),
    "dpm++": ("tiny", dict(method="dpm++")),
    "conditioned_ddim": ("tiny_conditioned", dict(method="ddim", conditioned=True)),
    "conditioned_plms_stacked": ("tiny_conditioned", dict(method="plms", conditioned="stacked")),
    "conditioned_dpm++_zero_embedding": ("tiny_conditioned", dict(method="dpm++")),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_loop_matches_jax_programs(wrappers, case, monkeypatch):
    """Each eager sampler against JAX's compiled program from the same start."""
    name, options = SAMPLE_CASES[case]
    options = dict(options)
    jvd, vd = wrappers[name]
    method = options.pop("method")
    conditioned = options.pop("conditioned", False)
    eta, churn = options.get("eta", 0.0), options.get("churn", 0.0)
    correction = options.get("correction", False)
    rng = np.random.default_rng(9)
    n = 2
    start = (rng.standard_normal((n, 3, 32, 32)).astype(np.float32) + 1) / 2
    pairs = vd.schedule_ts(5)
    cond = None
    if vd.conditioned:
        dim = _clip_dim(vd.config)
        cond = rng.standard_normal((n, dim)).astype(np.float32) if conditioned else None
    j_cond = jnp.zeros((n, dim)) if vd.conditioned and cond is None else (
        None if cond is None else jnp.asarray(cond))
    if eta or churn:
        _fixed_noise(monkeypatch, start.shape, seed=10)
    if method == "ddim":
        run = jvd._build_sample_run(eta > 0, churn > 0, correction)
        want = run(jvd.params, jnp.asarray(start), jnp.asarray(pairs), j_cond,
                   jax.random.PRNGKey(0), jnp.float32(eta), jnp.float32(churn))
    elif method == "dpm++":
        want = jvd._build_dpm_run()(jvd.params, jnp.asarray(start), jnp.asarray(pairs), j_cond)
    else:
        want = jvd._build_pndm_run(method)(jvd.params, jnp.asarray(start), jnp.asarray(pairs), j_cond)
    t_cond = None if cond is None else torch.from_numpy(cond[None] if conditioned == "stacked" else cond)
    got = vd.sample_loop(torch.from_numpy(start), pairs, t_cond, eta=eta, churn=churn,
                         correction=correction, generator=torch.Generator().manual_seed(0),
                         method=method)
    assert got.shape == start.shape and torch.isfinite(got).all()
    assert _rel_l2(got.numpy(), want) <= LOOP_RTOL


def test_sample_end_to_end_is_finite_and_seeded_repeatable(wrappers):
    _, vd = wrappers["tiny_conditioned"]
    cond = torch.randn((1, 1, 8), generator=torch.Generator().manual_seed(0))

    def run(seed, **kwargs):
        return vd.sample(n_images=2, n_steps=3, conditioning=cond,
                         generator=torch.Generator().manual_seed(seed), **kwargs)

    first = run(1, eta=0.3, churn=0.003)
    assert first.shape == (2, 3, 32, 32) and torch.isfinite(first).all()
    assert torch.equal(first, run(1, eta=0.3, churn=0.003))
    assert not torch.equal(first, run(2, eta=0.3, churn=0.003))
    # one embedding served both images; the default generator is seeded 0
    assert torch.equal(vd.sample(n_steps=2), vd.sample(n_steps=2))
    with pytest.raises(ValueError, match="unknown sampling method"):
        vd.sample(method="heun")
    for method in ("plms", "prk", "dpm++"):
        with pytest.raises(ValueError, match="deterministic"):
            vd.sample(method=method, correction=True)


def test_reverse_sample_matches_jax_and_inverts_ddim(wrappers):
    jvd, vd = wrappers["tiny"]
    images = np.random.default_rng(11).uniform(size=(2, 3, 32, 32)).astype(np.float32)
    want = jvd.reverse_sample(jnp.asarray(images), n_steps=6, to_ts=0.8)
    got = vd.reverse_sample(images, n_steps=6, to_ts=0.8)
    assert got.shape == images.shape
    assert _rel_l2(got.numpy(), want) <= LOOP_RTOL
    jvc, vc = wrappers["tiny_conditioned"]
    cond = np.random.default_rng(12).standard_normal((1, 2, 8)).astype(np.float32)
    want = jvc.reverse_sample(jnp.asarray(images), n_steps=4, conditioning=jnp.asarray(cond))
    got = vc.reverse_sample(images, n_steps=4, conditioning=torch.from_numpy(cond))
    assert _rel_l2(got.numpy(), want) <= LOOP_RTOL


def test_conditioning_is_the_mean_of_clip_encodings(wrappers, monkeypatch):
    _, vd = wrappers["tiny_conditioned"]
    calls = []

    class StubCLIP:
        def encode_texts(self, texts):
            return torch.full((len(texts), 8), 1.0)

        def encode_images(self, images):
            return torch.full((images.shape[0], 8), 3.0)

    def stub(name, **kwargs):
        calls.append((name, kwargs))
        return StubCLIP()

    monkeypatch.setattr(models, "CLIP", stub)
    out = vd.conditioning(texts=["a", "b"], images=torch.zeros(2, 3, 8, 8),
                          encodings=np.full((2, 8), 5.0, np.float32))
    assert out.shape == (1, 2, 8) and torch.allclose(out, torch.full((1, 2, 8), 3.0))
    assert calls == [("ViT-B-16", {"device": vd.device, "seed": vd.seed})]
    with pytest.raises(ValueError, match="at least one"):
        vd.conditioning()
    with pytest.raises(ValueError, match="takes no conditioning"):
        wrappers["tiny"][1].conditioning(texts=["a"])


def test_velocity_loss_matches_jax(wrappers, monkeypatch):
    jvd, vd = wrappers["tiny"]
    rng = np.random.default_rng(13)
    shape = (2, 3, 32, 32)
    noise, images, other, target = (rng.standard_normal(shape).astype(np.float32),
                                    *(rng.uniform(size=shape).astype(np.float32) for _ in range(3)))
    jloss = JVelocityLoss(jvd, jnp.asarray(noise), from_ts=0.6, resample_ts=0.35)
    tloss = losses.VelocityDiffusion(vd, noise, from_ts=0.6, resample_ts=0.35)
    want = jloss.diffuse_denoise(jnp.asarray(images))
    with torch.no_grad():
        got = tloss.diffuse_denoise(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=UNET_ATOL)
    # forward: value and gradient; the target carries none
    frozen = torch.from_numpy(target * 1.4 - 0.2).requires_grad_(True)
    x = torch.from_numpy(other * 1.4 - 0.2).requires_grad_(True)
    value = tloss(x, frozen)
    value.backward()
    j_value, j_grad = jax.value_and_grad(jloss.forward)(jnp.asarray(other * 1.4 - 0.2),
                                                        jnp.asarray(target * 1.4 - 0.2))
    np.testing.assert_allclose(float(value.detach()), float(j_value), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), _np(j_grad), atol=1e-8)
    assert frozen.grad is None
    # guided resampling with one fixed fresh-noise tensor on both sides
    _fixed_noise(monkeypatch, shape, seed=14)
    goal = rng.uniform(size=shape).astype(np.float32)
    j_value, j_images = jloss.guided_resample_(
        jnp.asarray(images), lambda im: ((im - jnp.asarray(goal)) ** 2).mean(),
        jax.random.PRNGKey(0), guidance_scale=2.0, clamp_value=1.0)
    t_value, t_images = tloss.guided_resample_(
        torch.from_numpy(images), lambda im: ((im - torch.from_numpy(goal)) ** 2).mean(),
        torch.Generator().manual_seed(0), guidance_scale=2.0, clamp_value=1.0)
    np.testing.assert_allclose(float(t_value), float(j_value), rtol=1e-5)
    np.testing.assert_allclose(t_images.numpy(), _np(j_images), atol=UNET_ATOL)
    np.testing.assert_allclose(tloss.noise.numpy(), _np(jloss.noise), atol=2e-4)
    assert not np.allclose(tloss.noise.numpy(), noise, atol=1e-2)  # the noise moved
    jloss.compensate_noise_(jnp.asarray(images), jnp.asarray(other))
    assert tloss.compensate_noise_(torch.from_numpy(images), torch.from_numpy(other)) is tloss
    np.testing.assert_allclose(tloss.noise.numpy(), _np(jloss.noise), atol=2e-4)
    assert losses.VelocityDiffusion is type(tloss)


def test_brute_diffusion_drawer_matches_jax(wrappers):
    jvd, vd = wrappers["tiny"]
    rng = np.random.default_rng(15)
    images = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    jdrawer = jdrawers.BruteDiffusion.from_image(jvd, jnp.asarray(images), 0.4, noise=jnp.asarray(noise))
    drawer = drawers.BruteDiffusion.from_image(vd, images, 0.4, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(drawer.params.detach().numpy(), _np(jdrawer.params), atol=1e-6)
    np.testing.assert_allclose(drawer.x.detach().numpy(), _np(jdrawer.x), atol=2e-6)
    np.testing.assert_allclose(drawer.synthesize().detach().numpy(), _np(jdrawer.synthesize()),
                               atol=UNET_ATOL)
    np.testing.assert_allclose(drawer.noise().detach().numpy(), _np(jdrawer.noise()), atol=UNET_ATOL)
    # only the diffused image is a parameter; the model stays frozen
    assert [tuple(p.shape) for p in drawer.parameters()] == [(2, 3, 32, 32)]
    target = torch.from_numpy(rng.uniform(size=images.shape).astype(np.float32))
    _, history = engine.optimize(drawer, [lambda im: ((im - target) ** 2).mean()], n_steps=4)
    assert history[-1] < history[0]
    other = drawers.BruteDiffusion(vd, np.zeros_like(images), 0.4)
    params = torch.from_numpy(images)
    np.testing.assert_allclose(
        other.synthesize(params).detach().numpy(),
        _np(jdrawer.synthesize(jnp.asarray(images))), atol=UNET_ATOL)


@pytest.mark.parametrize("name", ["tiny", "tiny_conditioned"])
def test_guided_sample_on_velocity_matches_jax(wrappers, name):
    """`engine.guided_sample` over float (from_t, to_t) pairs and the
    v-parameterized predictions."""
    jvd, vd = wrappers[name]
    rng = np.random.default_rng(16)
    start = rng.uniform(size=(1, 3, 32, 32)).astype(np.float32)
    target = rng.uniform(size=(1, 3, 32, 32)).astype(np.float32)
    cond = None if not vd.conditioned else rng.standard_normal((1, 8)).astype(np.float32)
    pairs = vd.schedule_ts(3, from_ts=0.8)
    kwargs = dict(guidance_scale=5.0, clamp_value=1.0, correction=True, threshold="static")

    j_images, j_history = j_guided_sample(
        jvd, [lambda im: ((im - jnp.asarray(target)) ** 2).sum()], jnp.asarray(start), pairs,
        conditioning=None if cond is None else jnp.asarray(cond), **kwargs)
    t_images, t_history = engine.guided_sample(
        vd, [lambda im: ((im - torch.from_numpy(target)) ** 2).sum()], torch.from_numpy(start),
        pairs, conditioning=None if cond is None else torch.from_numpy(cond), **kwargs)
    assert _rel_l2(t_images.numpy(), j_images) <= LOOP_RTOL
    assert _rel_l2(t_history.numpy(), j_history) <= LOOP_RTOL
    unguided, _ = engine.guided_sample(
        vd, [lambda im: ((im - torch.from_numpy(target)) ** 2).sum()], torch.from_numpy(start),
        pairs, conditioning=None if cond is None else torch.from_numpy(cond),
        **{**kwargs, "guidance_scale": 0.0})
    assert _rel_l2(unguided.numpy(), t_images.numpy()) >= 1e-2


def test_wrapper_names_and_device_default():
    with pytest.raises(ValueError, match="unknown velocity diffusion model"):
        VelocityDiffusion("yfcc_3", device="cpu")
    assert models.VelocityDiffusion is VelocityDiffusion
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VelocityDiffusion("tiny")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["yfcc_2", "yfcc_1", "cc12m_1_cfg", "wikiart"])
def test_full_width_construction_on_the_meta_device(name):
    """The published configs build (no weight is materialized) and their
    state_dicts walk through the JAX stream converter's key order."""
    cfg = configs.MODEL_CONFIGS[name]
    with torch.device("meta"):
        module = VDiffusionUNet(cfg)
    assert sum(p.numel() for p in module.parameters()) > 1e8
    keys = list(module.state_dict())
    assert keys[0] == ("mapping_timestep_embed.weight" if cfg.mapping else "timestep_embed.weight")
    assert keys[-1].startswith("blocks.up_0_")
