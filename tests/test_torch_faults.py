"""Four call forms and behaviours in which the port departed from the JAX
package: `quantile_threshold` on rows of more than 2**24 elements, the
wrappers' `remat=`, `flash_route`'s defaults, MonsterDiffusion's static
`sigmas` / `alphas`, and `setup_filter(separable=)`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.models.monster_diffusion import MonsterDiffusion as JMonsterDiffusion
from perceptor_tpu.ops.upfirdn import setup_filter as jsetup_filter
from perceptor_tpu_torch import guided_step
from perceptor_tpu_torch.core.remat import Remat
from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion
from perceptor_tpu_torch.models.monster_diffusion import MonsterDiffusion
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion
from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion
from perceptor_tpu_torch.ops.attention import flash_route
from perceptor_tpu_torch.ops.upfirdn import setup_filter
from perceptor_tpu_torch.predictions.base import quantile_threshold

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 order statistics interpolated in fp32: XLA may fuse the two products
QUANTILE_RTOL = 1e-6


@pytest.mark.parametrize("quantile", [0.0, 0.5, 0.9, 0.95, 0.995, 1.0])
def test_quantile_threshold_matches_jnp_quantile(quantile):
    xs = np.random.default_rng(0).standard_normal((3, 2, 7, 5)).astype(np.float32)
    xs[2, 0, 3, 1] = np.nan  # a row that holds a NaN gives NaN, as in JAX
    want = np.maximum(np.asarray(jnp.quantile(jnp.abs(jnp.asarray(xs)).reshape(3, -1),
                                              quantile, axis=1)), 0.25)
    got = quantile_threshold(torch.from_numpy(xs), quantile, 0.25)
    assert got.shape == (3, 1, 1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, rtol=QUANTILE_RTOL)


def test_quantile_threshold_takes_a_row_of_more_than_2_24_elements():
    xs = torch.rand((1, 3, 2400, 2400), generator=torch.Generator().manual_seed(0)) * 2 - 1
    assert xs[0].numel() > 2 ** 24
    got = float(quantile_threshold(xs, 0.95, 0.0))
    want = np.quantile(np.abs(xs.numpy().reshape(-1)).astype(np.float64), 0.95)
    assert got == pytest.approx(want, rel=QUANTILE_RTOL)


def _input_gradient(module, x, *args):
    x = x.clone().requires_grad_(True)
    out = module(x, *args)
    probe = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (grad,) = torch.autograd.grad((out * probe).sum(), x)
    return out.detach(), grad


def _block_calls(module, fn):
    """(fn's result, calls of module's first Remat block)."""
    block = next(m for m in module.modules() if isinstance(m, Remat))
    calls = []
    handle = block.register_forward_pre_hook(lambda *_: calls.append(1))
    try:
        return fn(), len(calls)
    finally:
        handle.remove()


def _remat_cases():
    gen = torch.Generator().manual_seed(2)
    x32 = torch.randn((1, 3, 32, 32), generator=gen)
    return {
        "stable_diffusion": (
            lambda remat: StableDiffusion("tiny", fp16=False, device="cpu", remat=remat).unet,
            (torch.randn((1, 4, 8, 8), generator=gen), torch.tensor([500.0]),
             torch.randn((1, 16, 32), generator=gen))),
        "guided_diffusion": (
            lambda remat: GuidedDiffusion("tiny", fp16=False, device="cpu", remat=remat).module,
            (x32, torch.tensor([500.0]))),
        "velocity_diffusion": (
            lambda remat: VelocityDiffusion("tiny", fp16=False, device="cpu", remat=remat).module,
            (x32, torch.tensor([0.5]))),
        "velocity_diffusion_conditioned": (
            lambda remat: VelocityDiffusion("tiny_conditioned", fp16=False, device="cpu",
                                            remat=remat).module,
            (x32, torch.tensor([0.5]), torch.randn((1, 8), generator=gen))),
    }


@pytest.mark.parametrize("name", sorted(_remat_cases()))
def test_remat_recomputes_the_blocks_and_keeps_the_gradient(name):
    build, (x, *args) = _remat_cases()[name]
    plain, remat = build(False), build(True)
    (out, grad), plain_calls = _block_calls(plain, lambda: _input_gradient(plain, x, *args))
    (r_out, r_grad), remat_calls = _block_calls(remat, lambda: _input_gradient(remat, x, *args))
    assert (plain_calls, remat_calls) == (1, 2)
    assert torch.equal(out, r_out) and torch.equal(grad, r_grad)
    # without gradients a remat block runs once
    with torch.no_grad():
        assert _block_calls(remat, lambda: remat(x, *args))[1] == 1


def test_guided_step_with_remat_equals_the_plain_step():
    latents, context = guided_step.build("tiny", device="cpu").initial_inputs()
    plain = guided_step.build("tiny", device="cpu").guided_denoise_step(latents, context)
    remat = guided_step.build("tiny", device="cpu", remat=True).guided_denoise_step(
        latents, context)
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))


def test_jax_call_forms():
    assert flash_route(4096, 4096) == torch.cuda.is_available()
    assert not flash_route(4096, 4096, True)
    assert flash_route(4096, 4096, masked=False, q=torch.zeros(1)) is False
    ts = np.array([0.5, 2.0, 80.0], np.float32)
    for fn in ("sigmas", "alphas"):
        got = getattr(MonsterDiffusion, fn)(ts)
        want = np.asarray(getattr(JMonsterDiffusion, fn)(ts))
        assert got.shape == want.shape == (3, 1, 1, 1) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        assert getattr(MonsterDiffusion, fn)(torch.tensor(1.5)).shape == (1, 1, 1, 1)
    for taps in ([1, 3, 3, 1], [1, 2, 1]):
        np.testing.assert_array_equal(setup_filter(taps, separable=True).numpy(),
                                      np.asarray(jsetup_filter(taps, separable=True)))
