"""The port's ops, schedule, prediction algebra and loss against the JAX
package, in fp32 on the CPU, with inputs from numpy."""

import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.losses.prompt_bank import spherical_distance_squared as j_sph
from perceptor_tpu.ops.attention import causal_mask as j_causal_mask
from perceptor_tpu.ops.attention import dot_product_attention as j_dpa
from perceptor_tpu.ops.clamp import clamp_with_grad as j_clamp
from perceptor_tpu.ops.groupnorm import ScaleShiftGroupNormSiLU as JScaleShift
from perceptor_tpu.ops.groupnorm import fused_group_norm_act as j_gn
from perceptor_tpu.ops.resize import resize as j_resize
from perceptor_tpu.predictions import LatentIndexedEpsPredictions as JPred
from perceptor_tpu.schedules import scaled_linear_alphas_sigmas as j_sched
from perceptor_tpu_torch.core.dtypes import cast_matmul_params_bf16
from perceptor_tpu_torch.losses.prompt_bank import spherical_distance_squared as t_sph
tattn = importlib.import_module("perceptor_tpu_torch.ops.attention")
from perceptor_tpu_torch.ops.clamp import clamp_with_grad as t_clamp
from perceptor_tpu_torch.ops import flash_attention_kernel as tfa
from perceptor_tpu_torch.ops.groupnorm import GroupNormSiLU, ScaleShiftGroupNormSiLU
from perceptor_tpu_torch.ops.groupnorm import fused_group_norm_act as t_gn
from perceptor_tpu_torch.ops.resize import resize as t_resize
from perceptor_tpu_torch.predictions import LatentIndexedEpsPredictions as TPred
from perceptor_tpu_torch.schedules import scaled_linear_alphas_sigmas as t_sched

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# pure algebra agrees to fp32 rounding
ALGEBRA_ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _nchw_to_nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("activation", ["silu", "relu", "gelu", "none"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_fused_group_norm_act_forward_and_backward(activation, per_sample):
    """Port (NCHW) vs JAX (NHWC) op and its custom VJP: atol 2e-5 as in
    tests/test_ops_misc.py."""
    rng = _rng(0)
    groups, (n, c, h, w) = 4, (2, 16, 5, 6)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    shape = (n, c) if per_sample else (c,)
    scale = (rng.standard_normal(shape) + 1.0).astype(np.float32)
    bias = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal((n, c, h, w)).astype(np.float32)

    def j_loss(x, s, b):
        y = j_gn(x, s, b, groups, 1e-5, None, activation)
        return jnp.sum(y * _nchw_to_nhwc(dy)), y

    (_, j_y), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(_nchw_to_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias)
    )
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    t_y = t_gn(tx, ts, tb, groups, 1e-5, None, activation)
    (t_y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(
        t_y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(j_y), atol=2e-5
    )
    np.testing.assert_allclose(
        tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(j_grads[0]), atol=2e-5
    )
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(j_grads[1]), atol=2e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(j_grads[2]), atol=2e-5)


def test_group_norm_silu_module_matches_torch_composite():
    """GroupNormSiLU = F.group_norm + SiLU (min(32, C) groups); the fused
    backward equals autograd of the composite."""
    rng = _rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 64, 4, 4)).astype(np.float32))
    module = GroupNormSiLU(64, eps=1e-6)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(rng.standard_normal(64).astype(np.float32)))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    fused = module(xa)
    composite = torch.nn.functional.silu(
        torch.nn.functional.group_norm(xb, 32, module.weight, module.bias, 1e-6)
    )
    np.testing.assert_allclose(fused.detach().numpy(), composite.detach().numpy(), atol=2e-5)
    fused.sum().backward()
    composite.sum().backward()
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), atol=2e-5)


def test_clamp_with_grad_matches_jax():
    rng = _rng(2)
    x = (rng.standard_normal((3, 7)) * 2).astype(np.float32)
    g = rng.standard_normal((3, 7)).astype(np.float32)
    j_y, j_vjp = jax.vjp(lambda x: j_clamp(x, -1.0, 1.0), jnp.asarray(x))
    (j_gx,) = j_vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    t_y = t_clamp(tx, -1.0, 1.0)
    t_y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t_y.detach().numpy(), np.asarray(j_y))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(j_gx))


@pytest.mark.parametrize("in_size,out_size", [(64, 28), (16, 32)])
def test_resize_matches_jax(in_size, out_size):
    """Antialiased lanczos3 down / bicubic up, forward and adjoint: atol 1e-5
    (fp32 matmuls on both sides)."""
    rng = _rng(3)
    x = rng.standard_normal((2, 3, in_size, in_size)).astype(np.float32)
    g = rng.standard_normal((2, 3, out_size, out_size)).astype(np.float32)
    j_y, j_vjp = jax.vjp(lambda x: j_resize(x, out_shape=(out_size, out_size)), jnp.asarray(x))
    (j_gx,) = j_vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    t_y = t_resize(tx, out_shape=(out_size, out_size))
    t_y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t_y.detach().numpy(), np.asarray(j_y), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), atol=1e-5)


def test_schedule_matches_jax():
    for t, j in zip(t_sched(), j_sched()):
        np.testing.assert_array_equal(t, np.asarray(j))


def _predictions():
    rng = _rng(4)
    latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    alphas, sigmas = j_sched()
    idx = np.array([800, 10])
    jp = JPred(jnp.asarray(latents), jnp.asarray(idx), jnp.asarray(noise),
               jnp.asarray(alphas), jnp.asarray(sigmas))
    tp = TPred(torch.from_numpy(latents), torch.from_numpy(idx), torch.from_numpy(noise),
               torch.from_numpy(alphas), torch.from_numpy(sigmas))
    return rng, jp, tp


def test_predictions_algebra_matches_jax():
    rng, jp, tp = _predictions()
    grad = (rng.standard_normal((2, 4, 8, 8)) * 1e-6).astype(np.float32)
    other = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    pairs = {
        "denoised_xs": (jp.denoised_xs, tp.denoised_xs),
        "step": (jp.step(np.array([780, 5])), tp.step(torch.tensor([780, 5]))),
        "guided.step": (
            jp.guided(jnp.asarray(grad), 0.5).step(np.array([780, 5])),
            tp.guided(torch.from_numpy(grad), 0.5).step(torch.tensor([780, 5])),
        ),
        "forced_denoised_xs": (
            jp.forced_denoised_xs(jnp.asarray(other)).predicted_noise,
            tp.forced_denoised_xs(torch.from_numpy(other)).predicted_noise,
        ),
        "forced_predicted_noise": (
            jp.forced_predicted_noise(jnp.asarray(other)).predicted_noise,
            tp.forced_predicted_noise(torch.from_numpy(other)).predicted_noise,
        ),
        "forced_denoised_latents": (
            jp.forced_denoised_latents(jnp.asarray(other)).predicted_noise,
            tp.forced_denoised_latents(torch.from_numpy(other)).predicted_noise,
        ),
    }
    for name, (j, t) in pairs.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ALGEBRA_ATOL, rtol=1e-6,
                                   err_msg=name)


def test_predictions_scalar_index_and_replace():
    _, _, tp = _predictions()
    assert tp.alphas(800).shape == (1, 1, 1, 1)
    replaced = tp.replace(predicted_noise=tp.predicted_noise * 0)
    assert replaced.from_diffused_latents is tp.from_diffused_latents
    # a stochastic step draws its noise from an explicit generator only
    with pytest.raises(ValueError, match="generator"):
        tp.step(780, eta=0.5)


def test_spherical_distance_matches_jax():
    rng = _rng(5)
    a = rng.standard_normal((3, 8)).astype(np.float32)
    b = rng.standard_normal((2, 8)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        t_sph(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_sph(jnp.asarray(a), jnp.asarray(b))), atol=1e-6,
    )


def test_dot_product_attention_and_causal_mask_match_jax():
    rng = _rng(6)
    q, k, v = (rng.standard_normal((2, 3, 16, 8)).astype(np.float32) for _ in range(3))
    for masked in (False, True):
        j_mask = j_causal_mask(16) if masked else None
        t_mask = tattn.causal_mask(16) if masked else None
        want = j_dpa(*(jnp.asarray(x) for x in (q, k, v)), mask=j_mask)
        got = tattn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)), mask=t_mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_cast_matmul_params_bf16():
    module = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.LayerNorm(4))
    cast_matmul_params_bf16(module)
    assert module[0].weight.dtype == torch.bfloat16
    assert module[0].bias.dtype == torch.float32
    assert module[1].weight.dtype == torch.float32
    sd = cast_matmul_params_bf16({"w": torch.zeros(2, 2), "b": torch.zeros(2)})
    assert sd["w"].dtype == torch.bfloat16 and sd["b"].dtype == torch.float32


@pytest.mark.parametrize("channels,groups", [(32, 32), (24, 8)])
def test_scale_shift_group_norm_silu_forward_and_gradients_match_jax(channels, groups):
    """silu(group_norm(x) * (1 + scale) + shift), the learned affine folded
    in: forward and the gradients of x, scale, shift and the learned affine,
    atol 2e-5 (fp32 on both sides)."""
    rng = _rng(20)
    x = rng.standard_normal((2, channels, 6, 5)).astype(np.float32)
    scale, shift = (0.5 * rng.standard_normal((2, channels)).astype(np.float32) for _ in range(2))
    g_s = (1.0 + 0.1 * rng.standard_normal(channels)).astype(np.float32)
    g_b = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jmodule = JScaleShift(num_groups=groups)

    def j_fn(x, scale, shift, g_s, g_b):
        y = jmodule.apply({"params": {"scale": g_s, "bias": g_b}}, x, scale, shift)
        return (y * _nchw_to_nhwc(jnp.asarray(dy))).sum(), y

    (_, j_y), j_grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        _nchw_to_nhwc(jnp.asarray(x)), *(jnp.asarray(a) for a in (scale, shift, g_s, g_b)))
    module = ScaleShiftGroupNormSiLU(channels, num_groups=groups)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(g_s))
        module.bias.copy_(torch.from_numpy(g_b))
    tx, tscale, tshift = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, shift))
    t_y = module(tx, tscale, tshift)
    (t_y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(t_y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(j_y), atol=2e-5)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(j_grads[0]), atol=2e-5)
    for got, want in zip((tscale.grad, tshift.grad, module.weight.grad, module.bias.grad), j_grads[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_one_group_relu_with_per_sample_affine_matches_jax():
    """The v-diffusion FiLM block's use: GroupNorm(1 group, no learned
    affine), an (N, C) scale-shift, ReLU."""
    rng = _rng(21)
    x = rng.standard_normal((2, 12, 5, 5)).astype(np.float32)
    scale, shift = (rng.standard_normal((2, 12)).astype(np.float32) for _ in range(2))
    j_y = j_gn(_nchw_to_nhwc(jnp.asarray(x)), jnp.asarray(scale) + 1.0, jnp.asarray(shift), 1, 1e-5,
               jnp.float32, "relu")
    t_y = t_gn(torch.from_numpy(x), torch.from_numpy(scale) + 1.0, torch.from_numpy(shift), 1, 1e-5,
               torch.float32, "relu")
    np.testing.assert_allclose(t_y.permute(0, 2, 3, 1).numpy(), np.asarray(j_y), atol=2e-5)
    assert float(t_y.min()) == 0.0


@pytest.mark.parametrize("d", [12, 20, 64])
def test_flash_attention_pads_the_head_dim_to_a_multiple_of_8(d, monkeypatch):
    """A head_dim the kernels' 16-byte loads cannot take is zero-padded in
    the wrapper and the result and gradients sliced back (the JAX wrapper
    pads to its lane width the same way); the scale stays 1/sqrt(true d)."""
    seen = []
    forward = tfa.flash_forward

    def recording(q, k, v, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return forward(q, k, v, scale)

    monkeypatch.setattr(tfa, "flash_forward", recording)
    rng = _rng(22)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, 16, d)).astype(np.float32))
                   for _ in range(4))
    outs = {}
    for use_flash in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tattn.attention(*leaves, use_flash=use_flash)
        grads = torch.autograd.grad((out * do).sum(), leaves)
        outs[use_flash] = (out.detach(), *grads)
    padded = d + (-d % 8)
    assert seen == [(padded, padded, padded, 1.0 / np.sqrt(d))]
    assert outs[True][0].shape == (1, 2, 16, d)
    for got, want in zip(outs[True], outs[False]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_flash_kernels_refuse_loudly_what_they_cannot_run():
    """The checks that stand before a launch: fp16 and a head_dim above 512
    raise; nothing is routed to the plain version on their account."""
    q = torch.zeros((1, 1, 128, 64), dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa._check_cuda_inputs([("q", q)], [128])
    with pytest.raises(ValueError, match="head_dim 520"):
        tfa._check_cuda_inputs([("q", torch.zeros((1, 1, 128, 520)))], [128])
