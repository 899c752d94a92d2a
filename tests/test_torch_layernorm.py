"""The fused residual add + LayerNorm (perceptor_tpu_torch/ops/layernorm.py)
on the CPU: its plain version against the chain the transformer block ran
before, bitwise; its output against the JAX block's LayerNorm; the SD and
SDXL UNets' transformer blocks, which route their three norms through it in
bf16 without a gradient and not otherwise; the argument checks, the fake
implementation, `torch.export` and the port's `layer_norm` span. The
kernel itself runs on the card (`chip_smoke.py`'s `layer_norm` phase)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from perceptor_tpu_torch.core.dtypes import cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import init_random_
from perceptor_tpu_torch.models.stable_diffusion import config as sd_config
from perceptor_tpu_torch.models.stable_diffusion import unet as sd_unet
from perceptor_tpu_torch.ops import layernorm as ln
from perceptor_tpu_torch.ops.layers import LayerNorm
from perceptor_tpu_torch.utils import profiling

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

BF16 = torch.bfloat16


def rows(c, seed, n=(2, 24)):
    """(x, h, weight, bias): bf16 residual and branch rows of mean 0.3 and
    spread 1.5, and a LayerNorm's fp32 affine near (1, 0)."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((*n, c)) * 1.5 + 0.3, dtype=torch.float32).to(BF16)
    h = torch.tensor(rng.standard_normal((*n, c)), dtype=torch.float32).to(BF16)
    weight = torch.tensor(1 + 0.2 * rng.standard_normal(c), dtype=torch.float32)
    bias = torch.tensor(0.2 * rng.standard_normal(c), dtype=torch.float32)
    return x, h, weight, bias


@pytest.mark.parametrize("with_h", [True, False], ids=["add", "norm"])
@pytest.mark.parametrize("c", [320, 640, 1280])
def test_plain_version_is_the_blocks_old_chain_bitwise(c, with_h):
    """The bf16 add, `LayerNorm` (ops/layers.py: `.float()`, fp32
    `F.layer_norm`) and the cast a `Linear` makes of its input."""
    x, h, weight, bias = rows(c, seed=c + with_h)
    norm = LayerNorm(c, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    r, y = ln.add_layer_norm(x, h if with_h else None, norm.weight, norm.bias, norm.eps)
    want_r = x + h if with_h else x
    want_y = norm(want_r).to(BF16)
    assert r.dtype == y.dtype == BF16
    assert torch.equal(r, want_r) and torch.equal(y, want_y)
    if not with_h:
        assert r is x


@pytest.mark.parametrize("with_h", [True, False], ids=["add", "norm"])
@pytest.mark.parametrize("c", [320, 1280])
def test_output_matches_the_jax_blocks_layer_norm(c, with_h):
    """The JAX BasicTransformerBlock: x + branch in bf16, then
    `nn.LayerNorm(epsilon=1e-5, dtype=float32)` and `.astype(bf16)`. r is
    the same bf16 add; y is JAX's fp32 norm rounded once, so it lies within
    half a bf16 spacing of it, up to fp32 summation order."""
    x, h, weight, bias = rows(c, seed=7 * c + with_h)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jr = jx + jnp.asarray(h.float().numpy()).astype(jnp.bfloat16) if with_h else jx
    layer = nn.LayerNorm(epsilon=1e-5, dtype=jnp.float32)
    params = {"params": {"scale": jnp.asarray(weight.numpy()), "bias": jnp.asarray(bias.numpy())}}
    jy32 = np.asarray(layer.apply(params, jr), dtype=np.float32)
    r, y = ln.add_layer_norm(x, h if with_h else None, weight, bias, 1e-5)
    np.testing.assert_array_equal(r.float().numpy(), np.asarray(jr, dtype=np.float32))
    err = np.abs(y.float().numpy() - jy32)
    assert (err <= 2.0**-8 * np.abs(jy32) + 1e-5).all(), float(err.max())
    # and against JAX's own rounding: equal but where fp32 order moves a tie
    same = y.float().numpy() == np.asarray(jnp.asarray(jy32).astype(jnp.bfloat16), np.float32)
    assert same.mean() > 0.99


def chain_forward(block, x, context):
    """BasicTransformerBlock's forward before the fused op: each norm in
    fp32, each Linear casting it to bf16."""
    x = x + block.attn1(block.norm1(x))
    x = x + block.attn2(block.norm2(x), context)
    return x + block.ff(block.norm3(x))


def tiny_unet(config, dtype_bf16=True):
    """(UNet, its inputs) at a tiny config, seeded, matmul weights bf16."""
    unet = sd_unet.UNet(config)
    init_random_(unet, torch.Generator().manual_seed(3))
    if dtype_bf16:
        cast_matmul_params_bf16(unet)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, config.in_channels, 16, 16, generator=gen)
    t = torch.tensor([999.0, 250.0])
    context = torch.randn(2, 7, config.context_dim, generator=gen)
    kwargs = {}
    if config.added_time_dim:
        pooled = torch.randn(2, config.added_input_dim - 6 * config.added_time_dim,
                             generator=gen)
        ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024], [512, 768, 0, 0, 512, 768]])
        kwargs["added"] = (pooled, ids)
    return unet, (x, t, context), kwargs


@pytest.fixture
def calls(monkeypatch):
    """The calls of `add_layer_norm`, as (x shape, with a branch, whether x
    and h are contiguous, so the kernel's wrapper copies nothing)."""
    seen = []
    fused = ln.add_layer_norm

    def spy(x, h, weight, bias, eps):
        seen.append((tuple(x.shape), h is not None,
                     x.is_contiguous() and (h is None or h.is_contiguous())))
        return fused(x, h, weight, bias, eps)

    monkeypatch.setattr(ln, "add_layer_norm", spy)
    return seen


UNETS = {"sd": sd_config.TINY_UNET, "sdxl": sd_config.TINY_XL_UNET}


def blocks(unet):
    return [m for m in unet.modules() if isinstance(m, sd_unet.BasicTransformerBlock)]


@pytest.mark.parametrize("name", sorted(UNETS))
def test_bf16_unet_without_gradient_routes_each_norm_through_the_op(name, calls, monkeypatch):
    unet, args, kwargs = tiny_unet(UNETS[name])
    with torch.no_grad():
        got = unet(*args, **kwargs)
        assert len(calls) == 3 * len(blocks(unet)) and len(blocks(unet)) >= 3
        # norm1 without a branch, norm2 and norm3 with one
        assert [with_h for _, with_h, _ in calls] == [False, True, True] * len(blocks(unet))
        assert all(dense for _, _, dense in calls)
        monkeypatch.setattr(sd_unet.BasicTransformerBlock, "forward", chain_forward)
        want = unet(*args, **kwargs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(UNETS))
def test_unet_with_a_gradient_keeps_the_old_chain(name, calls, monkeypatch):
    unet, (x, t, context), kwargs = tiny_unet(UNETS[name])

    def grad():
        latents = x.clone().requires_grad_(True)
        out = unet(latents, t, context, **kwargs)
        (out.float() ** 2).mean().backward()
        return out.detach(), latents.grad

    got = grad()
    assert calls == []
    monkeypatch.setattr(sd_unet.BasicTransformerBlock, "forward", chain_forward)
    want = grad()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", sorted(UNETS))
def test_bf16_unet_hands_every_group_norm_nchw_memory(name, monkeypatch):
    """The transformers' outputs keep the residual's NCHW layout (the
    residual leads the add), so the GroupNorm kernels after them copy
    nothing."""
    from perceptor_tpu_torch.ops import groupnorm as gn

    layouts = []
    op = gn._gn_op

    def spy(x, *args):
        layouts.append(x.is_contiguous())
        return op(x, *args)

    monkeypatch.setattr(gn, "_gn_op", spy)
    unet, args, kwargs = tiny_unet(UNETS[name])
    with torch.no_grad():
        unet(*args, **kwargs)
    assert layouts and all(layouts)


def test_fp32_unet_keeps_the_old_chain(calls):
    unet, args, kwargs = tiny_unet(sd_config.TINY_UNET, dtype_bf16=False)
    with torch.no_grad():
        unet(*args, **kwargs)
    assert calls == []


def test_block_takes_the_op_only_where_the_kernel_takes_the_width():
    block = sd_unet.BasicTransformerBlock(36, 2, 18, 32)
    cast_matmul_params_bf16(block)
    with torch.no_grad():
        assert not block._fused(torch.zeros(1, 4, 36, dtype=BF16))
        block = sd_unet.BasicTransformerBlock(32, 2, 16, 32)
        cast_matmul_params_bf16(block)
        assert block._fused(torch.zeros(1, 4, 32, dtype=BF16))
        assert not block._fused(torch.zeros(1, 4, 32))
    assert block._fused(torch.zeros(1, 4, 32, dtype=BF16))  # no tensor asks for a gradient
    assert not block._fused(torch.zeros(1, 4, 32, dtype=BF16, requires_grad=True))


def test_takes_channels():
    assert [c for c in range(0, 2100, 4) if ln.takes_channels(c)] == list(range(8, 2049, 8))


GOOD = dict(x_shape=(2, 5, 64), x_dtype=BF16, h_shape=(2, 5, 64), h_dtype=BF16,
            weight_shape=(64,), bias_shape=(64,))


@pytest.mark.parametrize("overrides,error,match", [
    ({"x_dtype": torch.float32, "h_dtype": torch.float32}, TypeError, "bfloat16"),
    ({"x_dtype": torch.float16, "h_shape": None}, TypeError, "bfloat16"),
    ({"x_shape": (2, 5, 60), "h_shape": (2, 5, 60), "weight_shape": (60,),
      "bias_shape": (60,)}, ValueError, "multiple of 8"),
    ({"x_shape": (2, 5, 2056), "h_shape": None, "weight_shape": (2056,),
      "bias_shape": (2056,)}, ValueError, "up to 2048"),
    ({"x_shape": (0, 5, 64), "h_shape": (0, 5, 64)}, ValueError, "rows"),
    ({"h_shape": (2, 4, 64)}, ValueError, "h is"),
    ({"h_dtype": torch.float32}, ValueError, "h is"),
    ({"weight_shape": (32,)}, ValueError, "weight"),
    ({"bias_shape": (1, 64)}, ValueError, "bias"),
])
def test_check_args_refuses_what_the_kernel_does_not_take(overrides, error, match):
    ln.check_args(**GOOD)
    ln.check_args(**{**GOOD, "h_shape": None, "h_dtype": None})
    with pytest.raises(error, match=match):
        ln.check_args(**{**GOOD, **overrides})


def test_public_call_raises_on_a_non_bf16_input():
    x, h, weight, bias = rows(64, seed=1)
    with pytest.raises(TypeError, match="bfloat16"):
        ln.add_layer_norm(x.float(), None, weight, bias, 1e-5)
    with pytest.raises(ValueError, match="h is"):
        ln.add_layer_norm(x, h[:1], weight, bias, 1e-5)


def test_fake_tensors_get_the_outputs_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 9, 64, dtype=BF16)
        r, y = ln._ln_op(x, torch.empty_like(x), torch.ones(64), torch.zeros(64), 1e-5)
        r0, y0 = ln._ln_op(x, None, torch.ones(64), torch.zeros(64), 1e-5)
    assert r.shape == y.shape == y0.shape == x.shape and r0.shape == (0,)
    assert r.dtype == y.dtype == y0.dtype == BF16


def test_export_of_a_block_holds_the_op():
    torch.manual_seed(0)
    block = sd_unet.BasicTransformerBlock(32, 2, 16, 24)
    cast_matmul_params_bf16(block)
    x = torch.randn(2, 16, 32).to(BF16)
    context = torch.randn(2, 5, 24)
    with torch.no_grad():
        program = torch.export.export(block, (x, context), strict=False)
        targets = [str(node.target) for node in program.graph.nodes
                   if node.op == "call_function"]
        assert targets.count("perceptor_tpu_torch.add_layer_norm.default") == 3
        assert torch.equal(program.module()(x, context), block(x, context))
        assert torch.equal(block(x, context), chain_forward(block, x, context))


def test_opens_the_layer_norm_span_under_the_profiler():
    x, h, weight, bias = rows(64, seed=2, n=(3, 4))
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("spatial_transformer"):
            ln.add_layer_norm(x, h, weight, bias, 1e-5)
            ln.add_layer_norm(x, None, weight, bias, 1e-5)
    spans = [s for s in profiling.spans() if s.name == "layer_norm"]
    assert len(spans) == 2 and all(s.parent == "spatial_transformer" for s in spans)
    assert spans[0].ids["rows"] == 3
    profiling.clear_spans()
    ln.add_layer_norm(x, h, weight, bias, 1e-5)
    assert profiling.spans() == []


def test_launch_counter_resets_and_the_cpu_counts_none():
    ln.LN_LAUNCHES["add_layer_norm"] = 5
    ln.reset_launches()
    assert ln.LN_LAUNCHES == {"layer_norm": 0, "add_layer_norm": 0}
    x, h, weight, bias = rows(64, seed=3)
    ln.add_layer_norm(x, h, weight, bias, 1e-5)
    assert ln.LN_LAUNCHES == {"layer_norm": 0, "add_layer_norm": 0}


def test_tiny_configs_hold_widths_the_kernel_takes():
    """Each tiny UNet's transformer widths are ones the kernel takes, so the
    UNet tests above exercise the fused path at every block."""
    for config in UNETS.values():
        widths = {config.base_channels * m for m, attn in
                  zip(config.channel_mults, config.cross_attention) if attn}
        assert widths and all(ln.takes_channels(c) for c in widths)
