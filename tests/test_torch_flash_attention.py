"""The port's flash-attention module against the JAX Pallas kernels.

The JAX side runs `flash_attention` in interpret mode, as
tests/test_flash_attention.py does; the port's wrappers take their plain
versions on CPU tensors (the CUDA kernels are checked on the card by
chip_smoke.py). Inputs come from numpy with a seed. Tolerances are the fp32
ones of tests/test_flash_attention.py: atol 2e-5 forward, 3e-5 gradients.
"""

import importlib.util
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.ops import flash_attention_kernel as jfa
tattn = importlib.import_module("perceptor_tpu_torch.ops.attention")
from perceptor_tpu_torch.ops import flash_attention_kernel as tfa

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

FWD_ATOL = 2e-5
GRAD_ATOL = 3e-5
# S = 256 with 128-row blocks: two K/V tiles, so the online-softmax
# correction and the cross-tile accumulation are exercised
SEQ, BLOCK = 256, 128


# fp32 exp is good to a few ulps: 1e-6 relative is ~8 ulps, ~100x below
# the first-call error
EXP_RTOL = 1e-6
_EXP_CALLS = textwrap.dedent("""
    import jax
    import numpy as np
    import torch
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 256, 256)).astype(np.float32) * 2)
    want = torch.exp(x.double())
    print(*(float(((torch.exp(x).double() - want) / want).abs().max()) for _ in range(2)))
""")


def test_cpu_exp_is_exact_after_one_call():
    """Fresh processes that have imported jax, as this file's: the second
    torch.exp matches float64 to fp32 rounding. The first call's error,
    sometimes ~1e-4 (see test_torch_cpu_guard.py), is printed, not asserted."""
    procs = [
        subprocess.Popen([sys.executable, "-c", _EXP_CALLS], stdout=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    errors = [tuple(map(float, proc.communicate(timeout=120)[0].split())) for proc in procs]
    assert all(proc.returncode == 0 for proc in procs)
    print("torch.exp relative error, (first, second) call per process:", errors)
    assert all(second <= EXP_RTOL for _, second in errors), errors


def _inputs(d, seed=0, b=1, h=2, s=SEQ):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("d", [40, 80, 512])
def test_plain_forward_and_lse_match_pallas(d):
    q, k, v, _ = _inputs(d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv = (jfa._pad_head_dim(jnp.asarray(x))[0] for x in (q, k, v))
    j_out, j_lse = jfa._forward(jq, jk, jv, scale, BLOCK, BLOCK, True)
    t_out, t_lse = tfa.flash_forward(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out)[..., :d], atol=FWD_ATOL)
    # the TPU kernel replicates lse over 128 lanes; the port stores (B, H, S)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0], atol=FWD_ATOL)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("d", [40, 80, 512])
def test_plain_dq_dkv_match_pallas_backward(d, b):
    q, k, v, do = _inputs(d, seed=1, b=b)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jfa._pad_head_dim(jnp.asarray(x))[0] for x in (q, k, v, do))
    j_out, j_lse = jfa._forward(jq, jk, jv, scale, BLOCK, BLOCK, True)
    j_dq, j_dk, j_dv = jfa._backward(
        (jq, jk, jv, j_out, j_lse), jdo, scale, BLOCK, BLOCK, True
    )
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_out, t_lse = tfa.flash_forward(tq, tk, tv, scale)
    delta = (t_out * tdo).sum(-1)
    t_dq = tfa.flash_dq(tq, tk, tv, tdo, t_lse, delta, scale)
    t_dk, t_dv = tfa.flash_dkv(tq, tk, tv, tdo, t_lse, delta, scale)
    for name, got, want in (("dq", t_dq, j_dq), ("dk", t_dk, j_dk), ("dv", t_dv, j_dv)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want)[..., :d], atol=GRAD_ATOL, err_msg=name
        )


@pytest.mark.parametrize("d", [40, 80, 512])
def test_autograd_function_matches_pallas_vjp(d):
    q, k, v, w = _inputs(d, seed=2)

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, block_q=BLOCK, block_k=BLOCK, interpret=True)
        return jnp.sum(out * w)

    j_out = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                block_q=BLOCK, block_k=BLOCK, interpret=True)
    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    t_out = tfa.flash_attention(tq, tk, tv)
    (t_out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=FWD_ATOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=GRAD_ATOL, err_msg=f"d{name}"
        )


def test_cpu_wrappers_launch_no_kernel():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(40, seed=3))
    before = dict(tfa.LAUNCHES)
    out, lse = tfa.flash_forward(q, k, v, 0.5)
    delta = (out * do).sum(-1)
    tfa.flash_dq(q, k, v, do, lse, delta, 0.5)
    tfa.flash_dkv(q, k, v, do, lse, delta, 0.5)
    assert tfa.LAUNCHES == before


def test_strided_views_match_contiguous():
    """The UNet hands the kernels (B, S, H, D) projections viewed as
    (B, H, S, D); the plain path must give the same result."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, SEQ, 2 * 40)).astype(np.float32))
    view = x.view(1, SEQ, 2, 40).transpose(1, 2)
    got = tfa.flash_attention(view, view, view)
    want = tfa.flash_attention(view.contiguous(), view.contiguous(), view.contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_attention_dispatch_on_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(40, seed=5, s=1024))
    # the kernel route needs a CUDA tensor: CPU tensors take the plain path
    assert not tattn.flash_route(1024, 1024, False, q)
    forced = tattn.attention(q, k, v, use_flash=True)
    routed = tattn.attention(q, k, v)
    np.testing.assert_allclose(forced.numpy(), routed.numpy(), atol=FWD_ATOL)


def test_flash_route_rule():
    """The JAX rule (unmasked, S_q == S_k >= 1024, a multiple of 128), for
    tensors on a CUDA device; a stand-in carries the tensor's device."""
    cuda = types.SimpleNamespace(is_cuda=True)
    assert tattn.flash_route(4096, 4096, False, cuda)
    assert tattn.flash_route(1024, 1024, False, cuda)
    for seq in (1234, 77, 512):
        assert not tattn.flash_route(seq, seq, False, cuda)
    assert not tattn.flash_route(4096, 77, False, cuda)
    assert not tattn.flash_route(4096, 4096, True, cuda)
    with pytest.raises(ValueError):
        tattn.attention(*(torch.zeros(1, 1, 8, 8) for _ in range(3)),
                        mask=torch.zeros(1, 1, 8, 8), use_flash=True)


def test_route_shapes_fit_every_kernel_tile():
    """Every shape `flash_route` admits (S a multiple of 128 from 1024, here
    up to 768px's 9216; head_dim a multiple of 8 up to 512) passes the
    block check of all three kernels in bf16 and fp32, so the route never
    sends a shape the kernels refuse. The pair checked is the one the
    wrappers pass to the C dispatch."""
    cuda = types.SimpleNamespace(is_cuda=True)
    for seq in range(1024, 9216 + 1, 128):
        assert tattn.flash_route(seq, seq, False, cuda)
        for d in range(8, tfa.MAX_HEAD_DIM + 1, 8):
            for dtype in tfa.DTYPES:
                for kernel in ("fwd", "dq", "dkv"):
                    assert tfa._check_blocks(seq, seq, d, kernel, dtype) == (
                        tfa._kernel_blocks(d, kernel, dtype)
                    )
    with pytest.raises(ValueError):
        tfa._kernel_blocks(tfa.MAX_HEAD_DIM + 8, "fwd", torch.bfloat16)


REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_chip_smoke_names_each_kernel_source_and_pallas_kernel(name):
    """chip_smoke.py's kernel table names, for each kernel, a source that
    defines its __global__ kernel and the line of the Pallas kernel it
    replaces; `_TILES` has a bf16 and an fp32 row for it up to MAX_HEAD_DIM."""
    smoke = _chip_smoke()
    kernel = name.removeprefix("flash_")
    source = (REPO / smoke.SOURCES[name]).read_text()
    assert re.search(rf"__global__\b[^;{{}}]*?\b{kernel}_kernel\s*\(", source), (
        f"{smoke.SOURCES[name]} defines no __global__ {kernel}_kernel"
    )
    path, line = smoke.REPLACES[name].split(":")
    pallas = (REPO / path).read_text()
    pallas_name = {"fwd": "_fwd_kernel", "dq": "_bwd_dq_kernel", "dkv": "_bwd_dkv_kernel"}[kernel]
    assert pallas.splitlines()[int(line) - 1].startswith(f"def {pallas_name}(")
    # the kernel body handed to a pallas_call (directly, or bound first)
    assert re.search(rf"functools\.partial\(\s*{pallas_name}\b", pallas)
    assert "pl.pallas_call(" in pallas
    for dtype in tfa.DTYPES:
        rows = tfa._TILES[(dtype, kernel)]
        assert rows[-1][0] == tfa.MAX_HEAD_DIM
