"""The port's `core` against the JAX package's: the nine names of
`core.__all__`, `assert_shape` / `assert_dims` exceptions and messages,
`Functional` flattening and `.replace`, the `Policy` casts, and
`init_on_cpu`'s fill rule per layer kind (fan-in equal to JAX's for the
same layer: flax stores kernels (in, out) and (kh, kw, in, out), torch
(out, in) and (out, in, kh, kw))."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from flax import linen as fnn
from torch import nn

import perceptor_tpu.core as jcore
import perceptor_tpu.core.dtypes as jdtypes
import perceptor_tpu.core.init as jinit
import perceptor_tpu_torch.core as core
import perceptor_tpu_torch.core.dtypes as dtypes
import perceptor_tpu_torch.core.init as init

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)


def test_core_exports_the_jax_names():
    assert core.__all__ == jcore.__all__
    for name in jcore.__all__:
        assert callable(getattr(core, name)), name


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


SHAPE_CASES = [
    ((2, 3, 4), (2, 3)),                   # rank
    ((2, 3, 4), (2, None, 5)),             # fixed dim
    ((2, 3, 4, 5), ("N", 3, "H", "H")),    # named dims that disagree
    ((1, 3), ("B", 4)),
]


@pytest.mark.parametrize("shape,spec", SHAPE_CASES)
def test_assert_shape_raises_as_jax(shape, spec):
    x = np.zeros(shape, np.float32)
    want = _raised(lambda: jcore.assert_shape(jnp.asarray(x), spec, name="latents"))
    got = _raised(lambda: core.assert_shape(torch.from_numpy(x), spec, name="latents"))
    assert got == want and want[0] is ValueError


def test_assert_shape_and_dims_pass_and_raise_as_jax():
    x = torch.zeros(2, 3, 4, 4)
    core.assert_shape(x, ("N", 3, "H", "H"))
    core.assert_shape(x, (None, None, 4, None))
    core.assert_dims(x, 4)
    want = _raised(lambda: jcore.assert_dims(jnp.zeros((2, 3)), 3, name="x"))
    assert _raised(lambda: core.assert_dims(torch.zeros(2, 3), 3, name="x")) == want


class TorchPair(core.Functional):
    a: torch.Tensor
    b: torch.Tensor = core.field(default=None)
    tag: str = core.static_field(default="t")


class JaxPair(jcore.Functional):
    a: jax.Array
    b: jax.Array = jcore.field(default=None)
    tag: str = jcore.static_field(default="t")


def test_functional_flattens_and_replaces_as_jax():
    a, b = np.arange(3, dtype=np.float32), np.ones(2, np.float32)
    pair = TorchPair(torch.from_numpy(a), torch.from_numpy(b), tag="x")
    jpair = JaxPair(jnp.asarray(a), jnp.asarray(b), tag="x")
    leaves, spec = pytree.tree_flatten(pair)
    jleaves, jdef = jax.tree_util.tree_flatten(jpair)
    assert len(leaves) == len(jleaves) == 2
    for got, want in zip(leaves, jleaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    again = pytree.tree_unflatten(leaves, spec)
    assert isinstance(again, TorchPair) and again.tag == "x"
    doubled = pytree.tree_map(lambda t: t * 2, pair)
    jdoubled = jax.tree.map(lambda t: t * 2, jpair)
    np.testing.assert_array_equal(doubled.a.numpy(), np.asarray(jdoubled.a))
    assert doubled.tag == jdoubled.tag == "x"
    keyed = pytree.tree_flatten_with_path(pair)[0]
    assert [pytree.keystr(path) for path, _ in keyed] == [".a", ".b"]
    replaced = pair.replace(tag="y")
    assert replaced.tag == "y" and replaced.a is pair.a and pair.tag == "x"
    assert jpair.replace(tag="y").tag == "y"
    with pytest.raises(dataclasses.FrozenInstanceError):
        pair.tag = "z"
    # a static field changes the structure, not the leaves
    assert pytree.tree_flatten(replaced)[1] != spec


def test_functional_is_an_input_torch_export_can_take():
    pair = TorchPair(torch.ones(3), torch.full((3,), 2.0))

    class Add(nn.Module):
        def forward(self, p):
            return p.a + p.b

    program = torch.export.export(Add(), (pair,))
    out = program.module()(TorchPair(torch.ones(3), torch.ones(3)))
    assert torch.equal(out, torch.full((3,), 2.0))


_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("name", ["default_policy", "half_policy", "full_policy"])
def test_policies_match_jax(name):
    policy, jpolicy = getattr(dtypes, name)(), getattr(jdtypes, name)()
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert getattr(policy, field) == _DTYPES[getattr(jpolicy, field)], field
    tree = {"w": np.ones((2, 2), np.float32), "n": np.arange(3, dtype=np.int32),
            "s": [np.float32(1.5)]}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = pytree.tree_map(torch.as_tensor, tree)
    for cast in ("cast_to_compute", "cast_to_output"):
        got = getattr(policy, cast)(ttree)
        want = getattr(jpolicy, cast)(jtree)
        for key in ("w", "n", "s"):
            g, w = (got[key], want[key]) if key != "s" else (got[key][0], want[key][0])
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), cast
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


# -- init_on_cpu -----------------------------------------------------------


class _Scalar(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return x * self.param("logit_scale", fnn.initializers.zeros, ())


class _TorchScalar(nn.Module):
    def __init__(self):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.zeros(()))


# (flax layer, its input, torch factory, {torch name: (flax path, torch <- flax permutation)})
LAYERS = {
    "dense": (fnn.Dense(6), np.zeros((1, 4)), lambda: nn.Linear(4, 6),
              {"weight": ("kernel", (1, 0)), "bias": ("bias", (0,))}),
    "conv": (fnn.Conv(5, (3, 3)), np.zeros((1, 8, 8, 4)), lambda: nn.Conv2d(4, 5, 3),
             {"weight": ("kernel", (3, 2, 0, 1)), "bias": ("bias", (0,))}),
    "conv_transpose": (fnn.ConvTranspose(5, (2, 2)), np.zeros((1, 8, 8, 4)),
                       lambda: nn.ConvTranspose2d(4, 5, 2),
                       {"weight": ("kernel", (2, 3, 0, 1)), "bias": ("bias", (0,))}),
    "embed": (fnn.Embed(10, 4), np.zeros((1, 3), np.int32), lambda: nn.Embedding(10, 4),
              {"weight": ("embedding", (0, 1))}),
    "layer_norm": (fnn.LayerNorm(), np.zeros((1, 4)), lambda: nn.LayerNorm(4),
                   {"weight": ("scale", (0,)), "bias": ("bias", (0,))}),
    "group_norm": (fnn.GroupNorm(num_groups=2), np.zeros((1, 4, 4, 4)),
                   lambda: nn.GroupNorm(2, 4),
                   {"weight": ("scale", (0,)), "bias": ("bias", (0,))}),
    "scalar": (_Scalar(), np.zeros((1,)), _TorchScalar, {"logit_scale": ("logit_scale", ())}),
}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_init_on_cpu_fills_each_layer_kind_as_jax(kind):
    """One layer at a time, so both draw the same numbers in the same order:
    the port's tensor is JAX's leaf in torch's layout, value for value, and
    its fan-in is JAX's."""
    layer, x, factory, names = LAYERS[kind]
    params = jinit.init_on_cpu(layer.init, jax.random.PRNGKey(0), jnp.asarray(x), seed=5)
    module = core.init_on_cpu(factory, seed=5)
    got = dict(module.named_parameters())
    assert set(got) == set(names)
    for name, (path, perm) in names.items():
        want = np.asarray(params["params"][path])
        np.testing.assert_array_equal(got[name].detach().numpy(), want.transpose(perm), name)
        if want.ndim >= 2:
            assert init.fan_in(module, name, got[name].shape) == int(np.prod(want.shape[:-1]))


def test_init_on_cpu_batch_norm_statistics_as_jax():
    params = jinit.init_on_cpu(fnn.BatchNorm(use_running_average=True).init,
                               jax.random.PRNGKey(0), jnp.zeros((2, 4)))
    module = core.init_on_cpu(lambda: nn.BatchNorm1d(4))
    np.testing.assert_array_equal(module.running_mean.numpy(),
                                  np.asarray(params["batch_stats"]["mean"]))
    np.testing.assert_array_equal(module.running_var.numpy(),
                                  np.asarray(params["batch_stats"]["var"]))
    np.testing.assert_array_equal(module.weight.detach().numpy(),
                                  np.asarray(params["params"]["scale"]))
    assert int(module.num_batches_tracked) == 0


def test_init_on_cpu_builds_on_meta_and_materializes_on_the_device():
    seen = []

    def factory(width):
        layer = nn.Linear(width, width)
        seen.append(layer.weight.device.type)
        return layer

    module = init.init_by_shape(factory, 512, seed=1)
    assert seen == ["meta"] and module.weight.device.type == "cpu"
    assert abs(float(module.weight.detach().std()) - 1 / np.sqrt(512)) < 2e-3
    again = init.init_by_shape(factory, 512, seed=1)
    assert torch.equal(again.weight, module.weight)
