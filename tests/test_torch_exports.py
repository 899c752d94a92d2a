"""Every name of the JAX package's `__all__` (the top level, `core`, `ops`,
`utils`, `parallel`, and the model/loss/drawer/transform/engine/prediction/
schedule layers) resolves in the port to an object of the same kind, but
for the deliberate differences listed here with their reasons; and the ops
the port gained for it (`group_norm`, `group_norm_silu`,
`upsample2x_nearest_conv3x3`) compute what JAX's compute."""

import importlib
import inspect
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

REPO = Path(__file__).resolve().parents[1]

PACKAGES = ["", ".core", ".ops", ".utils", ".parallel", ".models", ".losses", ".drawers",
            ".transforms", ".engine", ".predictions", ".schedules"]

DELIBERATE = {
    # JAX binds memoized constructors (utils.cache); the port binds the
    # classes, each call a new instance (the DIP's weights train, and the
    # samplers' weights are replaced by load_state_dict(s))
    (".models", "StableDiffusion"): "class for a memoized function",
    (".models", "GuidedDiffusion"): "class for a memoized function",
    (".models", "VelocityDiffusion"): "class for a memoized function",
    (".models", "MonsterDiffusion"): "class for a memoized function",
    (".models", "DeepImagePrior"): "class for a memoized function",
    # JAX's __all__ names a module that does not exist: the name raises
    # there, and the port does not copy it
    (".models", "AestheticVisualAssessment"): "dangling in JAX",
}


def _kind(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("package", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_every_jax_export_resolves_to_the_same_kind(package):
    jax_pkg = importlib.import_module("perceptor_tpu" + package)
    port = importlib.import_module("perceptor_tpu_torch" + package)
    for name in jax_pkg.__all__:
        if (package, name) in DELIBERATE:
            continue
        assert hasattr(port, name), f"perceptor_tpu_torch{package}.{name}"
        assert _kind(getattr(port, name)) == _kind(getattr(jax_pkg, name)), name
    assert set(jax_pkg.__all__) - {n for p, n in DELIBERATE if p == package} <= set(port.__all__)


def test_the_deliberate_differences_still_differ():
    for (package, name), reason in DELIBERATE.items():
        port = importlib.import_module("perceptor_tpu_torch" + package)
        if reason == "dangling in JAX":
            assert not hasattr(port, name)
            with pytest.raises(ImportError):
                getattr(importlib.import_module("perceptor_tpu" + package), name)
        else:
            assert inspect.isclass(getattr(port, name))


def test_ops_attention_is_the_function_whatever_was_imported_first():
    code = (
        "import types\n"
        "import perceptor_tpu_torch.ops.attention\n"
        "import perceptor_tpu_torch.ops.resize\n"
        "import perceptor_tpu_torch.ops.bias_act\n"
        "import perceptor_tpu_torch as p\n"
        "for name in ('attention', 'resize', 'bias_act', 'filtered_lrelu'):\n"
        "    assert not isinstance(getattr(p.ops, name), types.ModuleType), name\n"
        "assert callable(p.ops.flash_attention)\n"
        "assert p.ops.attention.__module__ == 'perceptor_tpu_torch.ops.attention'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


# -- the ops the port gained ---------------------------------------------------

ATOL = 1e-5


@pytest.mark.parametrize("channel_axis", [-1, 1])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("name", ["group_norm", "group_norm_silu"])
def test_group_norm_matches_jax(name, affine, channel_axis):
    import perceptor_tpu.ops as jops
    import perceptor_tpu_torch.ops as ops

    rng = np.random.default_rng(4)
    shape = (2, 5, 6, 8) if channel_axis == -1 else (2, 8, 5, 6)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32) if affine else None
    bias = rng.standard_normal(8).astype(np.float32) if affine else None
    want = getattr(jops, name)(jnp.asarray(x), 4, None if scale is None else jnp.asarray(scale),
                               None if bias is None else jnp.asarray(bias), 1e-5, channel_axis)
    got = getattr(ops, name)(torch.from_numpy(x), 4,
                             None if scale is None else torch.from_numpy(scale),
                             None if bias is None else torch.from_numpy(bias), 1e-5, channel_axis)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_group_norm_keeps_the_input_dtype_and_signature():
    import perceptor_tpu.ops.groupnorm as jgn
    import perceptor_tpu_torch.ops as ops

    assert (list(inspect.signature(ops.group_norm).parameters)
            == list(inspect.signature(jgn.group_norm).parameters))
    x = torch.randn(1, 4, 4, 8, dtype=torch.bfloat16)
    assert ops.group_norm(x, 2).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not divisible"):
        ops.group_norm(torch.zeros(1, 3, 3, 6), 4)


def test_upsample2x_nearest_conv3x3_matches_jax():
    """The port's NCHW / OIHW form against JAX's NHWC / HWIO one."""
    from perceptor_tpu.ops import upsample2x_nearest_conv3x3 as j_upconv
    from perceptor_tpu_torch.ops import upsample2x_nearest_conv3x3 as upconv

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)  # NHWC
    kernel = rng.standard_normal((3, 3, 4, 3)).astype(np.float32)  # HWIO
    bias = rng.standard_normal(3).astype(np.float32)
    want = np.asarray(jax.jit(j_upconv)(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    got = upconv(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(kernel).permute(3, 2, 0, 1), torch.from_numpy(bias))
    assert got.shape == (2, 3, 12, 10)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL)
    with pytest.raises(ValueError, match="3x3"):
        upconv(torch.zeros(1, 4, 2, 2), torch.zeros(3, 4, 1, 1))


def test_utils_exports_the_profiling_names():
    import perceptor_tpu_torch.utils as utils
    from perceptor_tpu_torch.utils import profiling

    for name in ("StepTimer", "annotate", "trace", "memory_stats", "live_array_bytes"):
        assert getattr(utils, name) is getattr(profiling, name)
