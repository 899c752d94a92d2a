"""The port's StyleGAN-XL slice against the JAX package on the CPU: the
toolbox ops (`ops/bias_act`, `filtered_lrelu`, `conv2d_resample`,
`grid_sample`, `fma`, `gradfix`), the generator (`models/stylegan_xl.py`) at
the JAX `TINY` config, its drawer and the key maps both ways.

The same numpy-seeded inputs go through the JAX function and its port. Both
generators hold JAX's seed-0 draw (`init_params`), carried across with
`convert.stylegan_xl_state_dict_from_jax`. fp32 runs are held to absolute
tolerances at O(1) magnitudes; bf16 runs to BF16_FACTOR times JAX's own
bf16 error against its fp32 run on the same input (no two packages round
bf16 alike).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu import drawers as jdrawers
from perceptor_tpu.models import stylegan_xl as jsg
from perceptor_tpu.ops.bias_act import ACTIVATIONS as JAX_ACTIVATIONS
from perceptor_tpu.ops.bias_act import bias_act as jbias_act
from perceptor_tpu.ops.conv2d_resample import conv2d_resample as jconv2d_resample
from perceptor_tpu.ops.filtered_lrelu import filtered_lrelu as jfiltered_lrelu
from perceptor_tpu.ops.grid_sample import flow_warp as jflow_warp
from perceptor_tpu.ops.grid_sample import grid_sample as jgrid_sample
from perceptor_tpu.ops.upfirdn import setup_filter as jsetup_filter
from perceptor_tpu_torch import convert, drawers, models, ops
from perceptor_tpu_torch.models import stylegan_xl as sg
from perceptor_tpu_torch.ops.bias_act import ACTIVATIONS
from perceptor_tpu_torch.ops.gradfix import no_weight_gradients
from perceptor_tpu_torch.ops.upfirdn import setup_filter

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

BF16_FACTOR = 2.5
# an unconditional tiny generator, as ffhq256 is at full size
TINY_UNCOND = dataclasses.replace(sg.TINY, c_dim=0)
JAX_TINY_UNCOND = dataclasses.replace(jsg.TINY, c_dim=0)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _torch_grads(fn, *arrays):
    """fn's value and the gradients of sum(value * probe) to each input."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    probe = torch.tensor(_rand(99, tuple(out.shape)))
    (out * probe).sum().backward()
    return out.detach().numpy(), [leaf.grad.numpy() for leaf in leaves], probe.numpy()


def _jax_grads(fn, probe, *arrays):
    """fn's value and its gradients, as `_torch_grads`, in one jitted call."""
    def run(*args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(jnp.asarray(probe))

    out, grads = jax.jit(run)(*(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_close(got, want, atol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# -- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("act,variant", list(itertools.product(
    sorted(JAX_ACTIVATIONS), ["plain", "bias_gain_clamp"])))
def test_bias_act_matches_jax(act, variant):
    """Each activation, bare and with bias, alpha, gain and clamp (a clamp
    that bites): values and gradients to x and b within 1e-6 (the bias
    gradient, a sum over 24 elements a channel, of its magnitude)."""
    x = _rand(0, (2, 5, 3, 4))
    b = _rand(1, (5,), 0.5)
    kwargs = {} if variant == "plain" else dict(alpha=0.3, gain=0.7, clamp=0.5)

    def port(x, b):
        return ops.bias_act(x, b, act=act, **kwargs)

    def ref(x, b):
        return jbias_act(x, b, act=act, **kwargs)

    got, grads, probe = _torch_grads(port, x, b)
    want, jgrads = _jax_grads(ref, probe, x, b)
    _assert_close(got, want, 1e-6)
    for g, jg in zip(grads, jgrads):
        _assert_close(g, jg, 1e-6 * max(1.0, np.abs(jg).max()))
    y = ops.bias_act(torch.tensor(x), act=act, dim=1, clamp=-1.0)  # a negative clamp is none
    _assert_close(y, jbias_act(jnp.asarray(x), act=act, clamp=-1.0), 1e-6)


def test_bias_act_broadcasts_on_dim_and_refuses_unknown():
    x, b = _rand(2, (3, 4, 6)), _rand(3, (6,))
    _assert_close(ops.bias_act(torch.tensor(x), torch.tensor(b), dim=-1, act="lrelu"),
                  jbias_act(jnp.asarray(x), jnp.asarray(b), dim=-1, act="lrelu"), 1e-6)
    assert set(ACTIVATIONS) == set(JAX_ACTIVATIONS)
    with pytest.raises(ValueError, match="unknown activation"):
        ops.bias_act(torch.tensor(x), act="gelu")


def _layer(config, index):
    return jsg.StyleGANXLGenerator(config).layers[index]


# (name, layer geometry, input size, clamp): TINY's up-2 and up-4 layers, the
# imagenet128 crops (-6, -9) and (-11, -12), the to-RGB layer with no filter
# (gain 1, slope 1) and a flipped filter
FILTERED_LRELU_CASES = {
    "tiny_up2": (lambda: _layer(jsg.TINY, 0), 22, 256.0, False),
    "tiny_up4": (lambda: _layer(jsg.TINY, 2), 22, 0.5, False),
    "imagenet128_up4_crop": (lambda: _layer(jsg.MODEL_CONFIGS["imagenet128"], 3), 16, 256.0, False),
    "imagenet128_last_crop": (lambda: _layer(jsg.MODEL_CONFIGS["imagenet128"], 13), 30, 256.0,
                              False),
    "torgb": (lambda: _layer(jsg.TINY, 6), 32, 256.0, False),
    "tiny_up2_flipped": (lambda: _layer(jsg.TINY, 1), 22, 1.0, True),
}


@pytest.mark.parametrize("case", sorted(FILTERED_LRELU_CASES))
def test_filtered_lrelu_matches_jax(case):
    spec_fn, size, clamp, flip = FILTERED_LRELU_CASES[case]
    spec = spec_fn()
    x = _rand(4, (2, 3, size, size))
    b = _rand(5, (3,), 0.3)
    torgb = spec["is_torgb"]
    kwargs = dict(up=spec["up_factor"], down=spec["down_factor"], padding=spec["padding"],
                  gain=1.0 if torgb else np.sqrt(2), slope=1.0 if torgb else 0.2, clamp=clamp,
                  flip_filter=flip)
    fu, fd = spec["up_filter"], spec["down_filter"]

    def port(x, b):
        return ops.filtered_lrelu(x, None if fu is None else torch.tensor(fu),
                                  None if fd is None else torch.tensor(fd), b, **kwargs)

    def ref(x, b):
        return jfiltered_lrelu(x, None if fu is None else jnp.asarray(fu),
                               None if fd is None else jnp.asarray(fd), b, **kwargs)

    got, grads, probe = _torch_grads(port, x, b)
    want, jgrads = _jax_grads(ref, probe, x, b)
    _assert_close(got, want, 1e-5)
    _assert_close(grads[0], jgrads[0], 1e-5)
    _assert_close(grads[1], jgrads[1], 1e-5 * np.abs(jgrads[1]).max())


# as tests/test_conv2d_resample.py's reference parity cases
@pytest.mark.parametrize("up,down,padding,groups,flip_weight,flip_filter,kh", [
    (1, 1, 0, 1, True, False, 3),
    (1, 1, (2, 1, 0, 3), 1, True, False, 3),
    (2, 1, 1, 1, True, False, 3),
    (2, 1, 0, 2, False, False, 3),
    (1, 2, 1, 1, True, False, 3),
    (1, 2, (1, 0), 1, True, True, 1),
    (2, 2, 2, 1, True, False, 3),
    (4, 1, 1, 1, True, False, 1),
])
def test_conv2d_resample_matches_jax(up, down, padding, groups, flip_weight, flip_filter, kh):
    x = _rand(6, (2, 4, 10, 11))
    w = _rand(7, (6, 4 // groups, kh, kh), 0.2)
    taps = [1.0, 2.0, 2.0, 1.0]
    kwargs = dict(up=up, down=down, padding=padding, groups=groups, flip_weight=flip_weight,
                  flip_filter=flip_filter)
    got, grads, probe = _torch_grads(
        lambda x, w: ops.conv2d_resample(x, w, f=setup_filter(taps), **kwargs), x, w)
    want, jgrads = _jax_grads(
        lambda x, w: jconv2d_resample(x, w, f=jsetup_filter(taps), **kwargs), probe, x, w)
    _assert_close(got, want, 1e-5)
    for g, jg in zip(grads, jgrads):
        _assert_close(g, jg, 1e-5 * max(1.0, np.abs(jg).max()))


@pytest.mark.parametrize("mode,padding,align", list(itertools.product(
    ["bilinear", "nearest"], ["zeros", "border"], [False, True])))
def test_grid_sample_matches_jax(mode, padding, align):
    """Values and gradients to the input and the grid (a grid past [-1, 1]),
    fp32, and bf16 input comes back bf16."""
    x = _rand(8, (2, 3, 5, 7))
    grid = np.random.default_rng(9).uniform(-1.3, 1.3, size=(2, 4, 6, 2)).astype(np.float32)
    kwargs = dict(mode=mode, padding_mode=padding, align_corners=align)
    got, grads, probe = _torch_grads(lambda x, g: ops.grid_sample(x, g, **kwargs), x, grid)
    want, jgrads = _jax_grads(lambda x, g: jgrid_sample(x, g, **kwargs), probe, x, grid)
    _assert_close(got, want, 1e-5)
    for g, jg in zip(grads, jgrads):
        _assert_close(g, jg, 1e-4)
    assert ops.grid_sample(torch.tensor(x, dtype=torch.bfloat16), torch.tensor(grid),
                           **kwargs).dtype == torch.bfloat16


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_flow_warp_matches_jax(padding):
    x = _rand(10, (2, 3, 6, 5))
    flow = _rand(11, (2, 6, 5, 2), 1.5)
    got, grads, probe = _torch_grads(lambda x, f: ops.flow_warp(x, f, padding_mode=padding),
                                     x, flow)
    want, jgrads = _jax_grads(lambda x, f: jflow_warp(x, f, padding_mode=padding), probe, x, flow)
    _assert_close(got, want, 1e-5)
    for g, jg in zip(grads, jgrads):
        _assert_close(g, jg, 1e-4)
    with pytest.raises(ValueError, match="unsupported mode"):
        ops.grid_sample(torch.tensor(x), torch.zeros(2, 2, 2, 2), mode="bicubic")


def test_fma_unbroadcasts_gradients():
    a, b, c = _rand(12, (2, 3, 4)), _rand(13, (3, 1)), _rand(14, (4,))
    got, grads, probe = _torch_grads(ops.fma, a, b, c)
    want, jgrads = _jax_grads(lambda a, b, c: a * b + c, probe, a, b, c)
    _assert_close(got, want, 1e-6)
    for g, jg, operand in zip(grads, jgrads, (a, b, c)):
        assert g.shape == operand.shape
        _assert_close(g, jg, 1e-5)


def test_no_weight_gradients_detaches_every_tensor():
    w = torch.ones(3, requires_grad=True)
    tree = no_weight_gradients({"a": w, "b": [w * 2, (w,)], "n": 4})
    assert not tree["a"].requires_grad and not tree["b"][0].requires_grad
    assert not tree["b"][1][0].requires_grad and tree["n"] == 4
    assert isinstance(tree["b"], list) and isinstance(tree["b"][1], tuple)
    x = torch.ones(3, requires_grad=True)
    (x * tree["a"]).sum().backward()
    assert w.grad is None and torch.equal(x.grad, torch.ones(3))


# -- the generator -------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "imagenet128", "ffhq256"])
def test_design_matches_jax(name):
    """layer_specs and every layer's design (names, factors, padding,
    filters) equal JAX's exactly."""
    jcfg, cfg = jsg.MODEL_CONFIGS[name], sg.MODEL_CONFIGS[name]
    for got, want in zip(sg.layer_specs(cfg.synthesis), jsg.layer_specs(jcfg.synthesis)):
        np.testing.assert_array_equal(got, want)
    jlayers = jsg.StyleGANXLGenerator(jcfg).layers
    layers = sg.design_layers(cfg.synthesis)
    assert len(layers) == len(jlayers)
    for spec, jspec in zip(layers, jlayers):
        assert spec.keys() == jspec.keys()
        for key in spec:
            if key.endswith("_filter"):
                assert (spec[key] is None) == (jspec[key] is None)
                if spec[key] is not None:
                    np.testing.assert_array_equal(spec[key], jspec[key])
            else:
                assert spec[key] == jspec[key], key
    assert sg.design_lowpass_filter(1, 2.0, 1.0, 8.0) is None
    np.testing.assert_array_equal(sg.design_lowpass_filter(12, 2.0, 3.0, 16.0, radial=True),
                                  jsg.design_lowpass_filter(12, 2.0, 3.0, 16.0, radial=True))


def _jax_params(config):
    return jax.tree.map(np.asarray, jsg.StyleGANXLGenerator(config).init_params())


@pytest.mark.parametrize("conditional", [True, False])
def test_init_params_equal_jax_bit_for_bit(conditional):
    cfg, jcfg = (sg.TINY, jsg.TINY) if conditional else (TINY_UNCOND, JAX_TINY_UNCOND)
    want = jax.tree_util.tree_leaves_with_path(_jax_params(jcfg))
    got = jax.tree_util.tree_leaves_with_path(sg.init_params(cfg))
    assert [path for path, _ in got] == [path for path, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    generator = sg.StyleGANXLGenerator(cfg)
    generator.load_state_dict(convert.stylegan_xl_state_dict_from_jax(sg.init_params(cfg), cfg))
    back = jsg.convert_stylegan_xl({k: v.numpy() for k, v in generator.state_dict().items()},
                                   jsg.StyleGANXLGenerator(jcfg))
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(a, b), back, _jax_params(jcfg)))


_JAX_RUNS = {}


def _jax_synthesis(dtype, ws):
    """JAX's synthesis of the tiny generator (seed-0 params), jitted once
    per dtype."""
    if dtype not in _JAX_RUNS:
        generator = jsg.StyleGANXLGenerator(jsg.TINY, dtype=dtype)
        _JAX_RUNS[dtype] = (jax.jit(generator.synthesis), generator.init_params())
    run, params = _JAX_RUNS[dtype]
    return np.asarray(run(params, jnp.asarray(ws)))


def _ws(seed, batch=2):
    return _rand(seed, (batch, sg.TINY.synthesis.num_ws, sg.TINY.w_dim))


def test_synthesis_fp32_and_bf16_match_jax():
    """The fp32 generator within 5e-4 of JAX's fp32 synthesis (the bound of
    JAX's own parity test against the reference), the bf16 one within
    BF16_FACTOR times JAX's bf16 error, both of the wrapper's builds."""
    ws = _ws(20)
    want = _jax_synthesis(jnp.float32, ws)
    jax_bf16_err = np.abs(_jax_synthesis(jnp.bfloat16, ws) - want).max()
    fp32 = models.StyleGANXL("tiny", device="cpu", dtype=torch.float32)
    bf16 = models.StyleGANXL("tiny", device="cpu")
    assert bf16.generator.dtype == torch.bfloat16 and fp32.generator.dtype == torch.float32
    with torch.no_grad():
        got32 = fp32.generator(torch.tensor(ws))
        got16 = bf16.generator(torch.tensor(ws))
    assert got32.dtype == got16.dtype == torch.float32 and got32.shape == (2, 3, 32, 32)
    assert np.abs(got32.numpy() - want).max() <= 5e-4
    assert 0 < jax_bf16_err and np.abs(got16.numpy() - want).max() <= BF16_FACTOR * jax_bf16_err
    with torch.no_grad():
        images = fp32(torch.tensor(ws))
    np.testing.assert_allclose(images.numpy(), (got32.numpy() + 1) / 2, atol=1e-7)
    assert fp32.num_ws == 8 and fp32.w_dim == 16


def test_mapping_and_latents_match_jax():
    """`latents` (numpy-seeded z and classes, truncation 0.7) and the
    mapping with given classes and psi against JAX's; a conditional mapping
    without classes raises; the unconditional mapping too."""
    model = models.StyleGANXL("tiny", device="cpu", dtype=torch.float32)
    jmodel = jsg.StyleGANXL.__wrapped__("tiny")
    got = model.latents(3, seeds=[0, 5, 7])
    want = np.asarray(jmodel.latents(3, seeds=[0, 5, 7]))
    assert got.shape == (3, 8, 16)
    _assert_close(got, want, 1e-5)
    _assert_close(model.latents(2), np.asarray(jmodel.latents(2)), 1e-5)
    z = _rand(21, (2, 8))
    for classes, psi in (([1, 3], 1.0), ([2, 0], 0.5)):
        got = model.generator.mapping(torch.tensor(z), classes, psi)
        want = jmodel.generator.mapping(jmodel.params, jnp.asarray(z), classes, psi)
        _assert_close(got, want, 1e-5)
    with pytest.raises(ValueError, match="needs class_indices"):
        model.generator.mapping(torch.tensor(z))
    params = _jax_params(JAX_TINY_UNCOND)
    generator = sg.StyleGANXLGenerator(TINY_UNCOND)
    generator.load_state_dict(convert.stylegan_xl_state_dict_from_jax(params, TINY_UNCOND))
    want = jsg.StyleGANXLGenerator(JAX_TINY_UNCOND).mapping(params, jnp.asarray(z), None, 0.7)
    _assert_close(generator.mapping(torch.tensor(z), None, 0.7), want, 1e-5)
    with pytest.raises(ValueError, match="unknown stylegan-xl model"):
        models.StyleGANXL("huge", device="cpu")


def _image_loss(images, xp):
    weights = xp.asarray(np.linspace(0.5, 1.5, images.shape[-1], dtype=np.float32))
    return ((images - 0.5) ** 2 * weights).mean()


def test_drawer_gradient_matches_jax():
    """The drawer's gradient to its latents under a weighted image loss:
    the fp32 build against `jax.grad` of JAX's fp32 drawer within 1e-4 of
    its largest magnitude, the bf16 build within BF16_FACTOR times JAX's own
    bf16 error; `synthesize_fn` over `model_params` equals `synthesize`;
    `encode` raises."""
    jmodel = jsg.StyleGANXL.__wrapped__("tiny")
    latents = np.asarray(jmodel.latents(2, seeds=[3, 4]))
    jdrawer = jdrawers.StyleGANXL(model=jmodel, latents=latents)

    def jgrad(dtype):
        jmodel.generator = jsg.StyleGANXLGenerator(jsg.TINY, dtype=dtype)
        return np.asarray(jax.jit(jax.grad(
            lambda p: _image_loss(jdrawer.synthesize(p), jnp)))(jdrawer.params))

    want, jax_bf16 = jgrad(jnp.float32), jgrad(jnp.bfloat16)
    jax_err = np.abs(jax_bf16 - want).max()

    def grad(dtype):
        drawer = drawers.StyleGANXL(model=models.StyleGANXL("tiny", device="cpu", dtype=dtype),
                                    latents=latents)
        assert [p is drawer.latents for p in drawer.parameters()] == [True]
        _image_loss(drawer.synthesize(), torch).backward()
        return drawer, drawer.latents.grad.numpy()

    drawer, got = grad(torch.float32)
    _assert_close(got, want, 1e-4 * np.abs(want).max())
    _, got16 = grad(torch.bfloat16)
    assert 0 < jax_err and np.abs(got16 - want).max() <= BF16_FACTOR * jax_err
    with torch.no_grad():
        np.testing.assert_array_equal(
            drawer.synthesize_fn(drawer.model_params, drawer.latents).numpy(),
            drawer.synthesize().numpy())
        assert drawer.synthesize().shape == (2, 3, 32, 32)
    with pytest.raises(NotImplementedError):
        drawer.encode(torch.zeros(1, 3, 32, 32))
    default = drawers.StyleGANXL(model=drawer.model, size=2, seeds=[3, 4])
    np.testing.assert_allclose(default.latents.detach().numpy(), latents, atol=1e-5)


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _tree_equal(a, b):
    la, lb = (jax.tree_util.tree_leaves_with_path(t) for t in (a, b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("snapshot", ["conditional", "unconditional_with_embed", "synthesis_only"])
def test_converters_round_trip_each_other(snapshot):
    """An upstream-style snapshot state_dict -> the port's
    `convert_stylegan_xl` (loaded strictly) -> JAX's `convert_stylegan_xl`
    gives the tree JAX reads from the snapshot itself; and JAX's tree ->
    `stylegan_xl_state_dict_from_jax` -> the port's state_dict. The
    unconditional snapshot carries `mapping.embed.weight` but no
    `embed_proj`; the synthesis-only one takes the seed-0 random mapping."""
    cfg, jcfg = (sg.TINY, jsg.TINY) if snapshot == "conditional" else (TINY_UNCOND,
                                                                         JAX_TINY_UNCOND)
    params = _jax_params(jcfg)
    params = jax.tree.map(lambda v: v + _rand(v.size, v.shape, 0.1).astype(v.dtype), params)
    sd = convert.stylegan_xl_state_dict_from_jax(params, cfg)
    if snapshot == "unconditional_with_embed":
        sd["mapping.embed.weight"] = torch.tensor(_rand(30, (1000, 320)))
    if snapshot == "synthesis_only":
        sd = {k: v for k, v in sd.items() if k.startswith("synthesis.")}
    generator = sg.StyleGANXLGenerator(cfg)
    generator.load_state_dict(sg.convert_stylegan_xl(sd, generator), strict=True)
    jgen = jsg.StyleGANXLGenerator(jcfg)
    want = jsg.convert_stylegan_xl(_np_sd(sd), jgen)
    back = jsg.convert_stylegan_xl(_np_sd(generator.state_dict()), jgen)
    assert _tree_equal(back, want)
    if snapshot == "synthesis_only":
        assert _tree_equal(want["mapping"], _jax_params(jcfg)["mapping"])
    else:
        assert _tree_equal(want, params)
    for key, value in convert.stylegan_xl_state_dict_from_jax(want, cfg).items():
        assert torch.equal(value, generator.state_dict()[key]), key


def test_wrapper_loads_a_checkpoint_it_finds(tmp_path, monkeypatch):
    """`StyleGANXL("tiny")` finds `stylegan_xl_tiny.pt` in a cache
    directory, as the JAX wrapper does, and both hold its weights."""
    from perceptor_tpu.utils import checkpoints as jcheckpoints
    from perceptor_tpu_torch.utils import checkpoints

    params = jax.tree.map(lambda v: v * 1.5, _jax_params(jsg.TINY))
    torch.save(convert.stylegan_xl_state_dict_from_jax(params, sg.TINY),
               tmp_path / "stylegan_xl_tiny.pt")
    monkeypatch.setattr(checkpoints, "CACHE_DIRS", (str(tmp_path),))
    monkeypatch.setattr(jcheckpoints, "CACHE_DIRS", (str(tmp_path),))
    model = sg.StyleGANXL.__wrapped__("tiny", device="cpu")
    jmodel = jsg.StyleGANXL.__wrapped__("tiny")
    back = jsg.convert_stylegan_xl(_np_sd(model.generator.state_dict()), jmodel.generator)
    assert _tree_equal(back, jax.tree.map(np.asarray, jmodel.params))
    assert _tree_equal(back, params)
