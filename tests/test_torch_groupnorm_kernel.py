"""The GroupNorm + activation kernels' wrapper (perceptor_tpu_torch/ops/
groupnorm.py) on the CPU: the launch split, the argument checks, an import
that needs neither CUDA nor nvcc, the plain version's backward against
autograd of the unfused formula, the port's `group_norm` and
`group_norm.backward` spans, and the SD decoder's NCHW memory. The
kernels themselves run on the card (`chip_smoke.py`'s `group_norm` phase)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perceptor_tpu_torch.ops import groupnorm as gn
from perceptor_tpu_torch.utils import profiling

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

REPO = Path(__file__).resolve().parents[1]
TWO_WAVES = gn.WAVES * gn.SMS * gn.THREADS_PER_SM


# (batch, groups, channels per group, H * W): N x G from 1 to 512 over the
# slabs the port meets (the SD UNet's and VAE's levels, v-diffusion's one
# group, SDXL's UNet at batch 8 and its decoder of 4 at 1024 px), odd H * W
# included
SPLIT_CASES = [
    (1, 1, 128, 65536), (1, 1, 512, 1024), (1, 32, 4, 262144), (1, 32, 8, 65536),
    (1, 32, 10, 4096), (1, 32, 40, 64), (1, 32, 80, 64), (2, 32, 20, 1024), (8, 32, 4, 262144),
    (8, 32, 16, 16384), (16, 32, 10, 4096), (16, 32, 40, 256), (16, 32, 40, 64), (4, 32, 2, 35),
    (2, 1, 64, 49), (1, 2, 3, 7), (16, 8, 4, 8), (1, 32, 16, 16384), (8, 32, 8, 65536),
    (8, 32, 10, 16384), (8, 32, 30, 16384), (8, 32, 80, 1024), (4, 32, 16, 262144),
    (4, 32, 8, 262144), (4, 32, 8, 1048576), (4, 32, 4, 1048576),
]


# the wrapper reads element by element where H * W is no multiple of VEC
SPLITS = [(*case, vec) for case in SPLIT_CASES for vec in (gn.VEC, 1) if case[3] % vec == 0]


@pytest.mark.parametrize("n,groups,cg,hw,vec", SPLITS)
def test_launch_shape_covers_each_element_once_and_fills_two_waves(n, groups, cg, hw, vec):
    rows, vecs = n * groups * cg, hw // vec
    threads, chunks, chunk_vecs = gn.launch_shape(rows, hw, vec)
    assert 32 <= threads <= gn.MAX_THREADS and threads % 32 == 0
    assert 1 <= chunks <= gn.MAX_CHUNKS
    # block k of a row takes [k * chunk_vecs, min((k + 1) * chunk_vecs, vecs))
    covered = np.zeros(vecs, dtype=np.int64)
    for k in range(chunks):
        lo, hi = k * chunk_vecs, min((k + 1) * chunk_vecs, vecs)
        assert lo < hi, "an empty block"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # two waves of the card's threads, or every thread already at its least work
    launched = rows * chunks * threads
    assert launched >= TWO_WAVES or chunk_vecs <= 2 * gn.MIN_VECS_PER_THREAD * threads
    assert launched >= min(TWO_WAVES, rows * vecs // (2 * gn.MIN_VECS_PER_THREAD))


@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_the_sd_decoder_hands_every_group_norm_nchw_memory(part):
    """The KL-VAE's GroupNorm + SiLU calls see NCHW memory, so the kernels
    take them without a copy: the mid attention's residual add keeps the
    residual's layout."""
    from perceptor_tpu_torch.models.stable_diffusion.config import VAEConfig
    from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL

    torch.manual_seed(0)
    vae = AutoencoderKL(VAEConfig(base_channels=32, channel_mults=(1, 2), n_res_blocks=1)).eval()
    seen = []
    for module in getattr(vae, part).modules():
        if isinstance(module, gn.GroupNormSiLU):
            module.register_forward_pre_hook(lambda _, args: seen.append(args[0].is_contiguous()))
    with torch.no_grad():
        if part == "decoder":
            vae.decode(torch.randn(2, 4, 8, 8))
        else:
            vae.encode(torch.rand(2, 3, 16, 16))
    assert len(seen) > 4 and all(seen), seen


def test_launch_shape_splits_the_guided_vae_levels_across_the_card():
    # the VAE decoder's last level at batch 1: 128 rows of 512 x 512
    threads, chunks, _ = gn.launch_shape(128, 512 * 512, gn.VEC)
    assert threads == 256 and 128 * chunks * threads >= TWO_WAVES
    # a large batch needs no split
    assert gn.launch_shape(16 * 320, 64 * 64, gn.VEC)[1] == 1


def _check(**overrides):
    args = dict(x_shape=(2, 8, 4, 4), x_dtype=torch.bfloat16, scale_shape=(8,),
                bias_shape=(2, 8), num_groups=4, out_dtype=torch.float32, activation="silu")
    args.update(overrides)
    gn.check_args(**args)


def test_check_args_takes_what_the_kernels_take():
    _check()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        _check(x_dtype=dtype, out_dtype=dtype)
    for activation in gn.ACTIVATIONS:
        _check(activation=activation)
    _check(num_groups=1)
    _check(x_shape=(1, 6, 5, 7), scale_shape=(6,), bias_shape=(6,), num_groups=3)


@pytest.mark.parametrize("overrides,error,match", [
    (dict(x_shape=(2, 8, 16)), ValueError, "N, C, H, W"),
    (dict(x_shape=(2, 8, 0, 4)), ValueError, "empty"),
    (dict(num_groups=3), ValueError, "not divisible"),
    (dict(num_groups=0), ValueError, "not divisible"),
    (dict(x_dtype=torch.float64), TypeError, "x"),
    (dict(out_dtype=torch.int32), TypeError, "out_dtype"),
    (dict(scale_shape=(4,)), ValueError, "scale"),
    (dict(bias_shape=(3, 8)), ValueError, "bias"),
    (dict(scale_shape=(2, 8, 1)), ValueError, "scale"),
    (dict(activation="tanh"), ValueError, "activation"),
    (dict(x_shape=(2**16, 2**15, 1, 1), scale_shape=(2**15,), bias_shape=(2**15,)),
     ValueError, "2\\*\\*31"),
    (dict(x_shape=(1, 8, 2**16, 2**15), bias_shape=(8,)), ValueError, "2\\*\\*31"),
])
def test_check_args_refuses_what_the_kernels_do_not_take(overrides, error, match):
    with pytest.raises(error, match=match):
        _check(**overrides)


def test_public_wrapper_refuses_unknown_activation_and_groups():
    x = torch.randn(1, 8, 2, 2)
    with pytest.raises(ValueError, match="activation"):
        gn.fused_group_norm_act(x, torch.ones(8), torch.zeros(8), 4, activation="tanh")
    with pytest.raises(ValueError, match="not divisible"):
        gn.fused_group_norm_act(x, torch.ones(8), torch.zeros(8), 3)


def test_vector_width_follows_rows_and_alignment():
    x = torch.zeros(2, 4, 8, 8, dtype=torch.bfloat16)
    assert gn._vec(64, x) == gn.VEC
    assert gn._vec(35, x) == 1
    # a view starting one element in is no longer aligned to a vector
    assert gn._vec(64, x.view(-1)[1:]) == 1


def test_affine_is_fp32_and_per_sample_where_either_is():
    scale, bias = torch.ones(8, dtype=torch.bfloat16), torch.zeros(2, 16)[:, ::2]
    s, b, per_sample = gn._affine(scale, bias, 2, 8)
    assert per_sample and s.shape == b.shape == (2, 8)
    assert s.dtype == b.dtype == torch.float32 and s.is_contiguous() and b.is_contiguous()
    s, b, per_sample = gn._affine(torch.ones(8), torch.zeros(8), 2, 8)
    assert not per_sample and s.shape == (8,)


def test_module_imports_and_runs_on_the_cpu_without_cuda_or_nvcc(tmp_path):
    code = (
        "import shutil, torch\n"
        "assert shutil.which('nvcc') is None\n"
        "from perceptor_tpu_torch.ops import groupnorm as gn\n"
        "x = torch.randn(2, 8, 3, 3, requires_grad=True)\n"
        "y = gn.fused_group_norm_act(x, torch.ones(8), torch.zeros(8), 4)\n"
        "y.sum().backward()\n"
        "assert x.grad.shape == x.shape\n"
        "assert gn._lib is None and sum(gn.GN_LAUNCHES.values()) == 0\n"
        "assert torch.ops.perceptor_tpu_torch.group_norm_act_backward.default\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def _unfused(x, scale, bias, groups, eps, activation):
    """act(group_norm(x) * scale + bias) in plain differentiable float64."""
    h = F.group_norm(x, groups, None, None, eps)
    if scale.ndim == 1:
        h = h * scale[None, :, None, None] + bias[None, :, None, None]
    else:
        h = h * scale[:, :, None, None] + bias[:, :, None, None]
    return {"silu": F.silu, "relu": F.relu, "gelu": F.gelu, "none": lambda v: v}[activation](h)


@pytest.mark.parametrize("groups", [1, 32])
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("affine_grads", [True, False])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_plain_backward_matches_autograd_of_the_unfused_formula(groups, per_sample,
                                                                 affine_grads, activation):
    """The CPU op's forward and backward (fp32) against autograd through
    F.group_norm in float64: 1e-4 absolute, fp32 statistics over 3 x 64 x
    6 x 5 values. Without affine gradients the backward returns None for
    scale and bias."""
    rng = np.random.default_rng(11)
    n, c, hh, ww = 3, 64, 6, 5
    x = rng.standard_normal((n, c, hh, ww)) * 2 + 0.5
    shape = (n, c) if per_sample else (c,)
    scale = rng.standard_normal(shape) * 0.3 + 1.0
    bias = rng.standard_normal(shape) * 0.3
    dy = rng.standard_normal((n, c, hh, ww))

    def tensors(dtype, grads):
        return [torch.tensor(a, dtype=dtype, requires_grad=g)
                for a, g in zip((x, scale, bias), (True, grads, grads))]

    tx, ts, tb = tensors(torch.float32, affine_grads)
    y = gn.fused_group_norm_act(tx, ts, tb, groups, 1e-5, None, activation)
    (y * torch.tensor(dy, dtype=torch.float32)).sum().backward()
    rx, rs, rb = tensors(torch.float64, True)
    want = _unfused(rx, rs, rb, groups, 1e-5, activation)
    (want * torch.tensor(dy)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), atol=1e-4)
    if affine_grads:
        np.testing.assert_allclose(ts.grad.numpy(), rs.grad.numpy(), atol=1e-4)
        np.testing.assert_allclose(tb.grad.numpy(), rb.grad.numpy(), atol=1e-4)
    else:
        assert ts.grad is None and tb.grad is None


def test_backward_returns_affine_gradients_only_where_asked(monkeypatch):
    seen = []

    class Probe(gn._FusedGroupNormAct):
        @staticmethod
        def backward(ctx, dy):
            grads = gn._FusedGroupNormAct.backward(ctx, dy)
            seen.append(tuple(g is not None for g in grads[:3]))
            return grads

    x = torch.randn(2, 8, 3, 3, requires_grad=True)
    scale = torch.ones(2, 8, requires_grad=True)
    bias = torch.zeros(8)
    Probe.apply(x, scale, bias, 4, 1e-5, torch.float32, "silu").sum().backward()
    assert seen == [(True, True, False)]


def test_fake_tensors_get_the_outputs_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 8, 4, 4, dtype=torch.bfloat16)
        y, mean, rstd = gn._gn_op(x, torch.ones(8), torch.zeros(8), 4, 1e-5, torch.float32,
                                  "relu")
        dx, dh, dhx = gn._gn_bwd_op(y, x, torch.ones(8), torch.zeros(8), mean, rstd, "relu")
    assert y.shape == x.shape and y.dtype == torch.float32
    assert mean.shape == rstd.shape == (2, 4) and mean.dtype == torch.float32
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dh.shape == dhx.shape == (2, 8) and dh.dtype == torch.float32
    # on the CPU the outputs keep a channels-last input's layout, as the plain
    # version does (the kernels copy it to NCHW and give NCHW outputs)
    with FakeTensorMode():
        x = torch.empty(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
        y, mean, rstd = gn._gn_op(x, torch.ones(8), torch.zeros(8), 4, 1e-5, torch.float32,
                                  "silu")
        dx, _, _ = gn._gn_bwd_op(y, x, torch.ones(8), torch.zeros(8), mean, rstd, "silu")
    for t in (y, dx):
        assert t.is_contiguous(memory_format=torch.channels_last) and not t.is_contiguous()


def test_plain_version_keeps_a_channels_last_layout_and_values():
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 16, 3, 5)), dtype=torch.float32)
    last = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    first = x.clone().requires_grad_(True)
    y_last = gn.fused_group_norm_act(last, torch.ones(16), torch.zeros(16), 4)
    y_first = gn.fused_group_norm_act(first, torch.ones(16), torch.zeros(16), 4)
    assert y_last.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y_last, y_first, rtol=0, atol=1e-6)
    y_last.sum().backward()
    y_first.sum().backward()
    torch.testing.assert_close(last.grad, first.grad, rtol=0, atol=1e-6)


def test_forward_opens_the_group_norm_span_under_the_profiler():
    profiling.clear_spans()
    x = torch.randn(3, 8, 2, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("unet"):
            gn.fused_group_norm_act(x, torch.ones(8), torch.zeros(8), 4)
    spans = [s for s in profiling.spans() if s.name == "group_norm"]
    assert len(spans) == 1 and spans[0].parent == "unet" and spans[0].ids["rows"] == 3
    profiling.clear_spans()
    gn.fused_group_norm_act(x, torch.ones(8), torch.zeros(8), 4)
    assert profiling.spans() == []


@pytest.mark.parametrize("needs_grad", [True, False])
def test_backward_opens_the_group_norm_backward_span_under_the_profiler(needs_grad):
    profiling.clear_spans()
    x = torch.randn(3, 8, 2, 2, requires_grad=True)
    scale = torch.ones(8, requires_grad=needs_grad)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("guidance_backward"):
            y = gn.fused_group_norm_act(x, scale, torch.zeros(8), 4)
            y.sum().backward()
    names = [s.name for s in profiling.spans()]
    assert names.count("group_norm") == names.count("group_norm.backward") == 1
    span = next(s for s in profiling.spans() if s.name == "group_norm.backward")
    assert span.parent == "guidance_backward" and span.ids["rows"] == 3
    profiling.clear_spans()
