"""bench_cuda.py and utils/bench_env.py on the CPU: the script refuses to
run without a card; every cell builds at TINY size and runs one step with
a positive model-FLOP count; the conditions block has the JAX keys."""

import os
import subprocess
import sys

import pytest
import torch

import bench_cuda
from chip_smoke import PER_STEP
from perceptor_tpu.utils import bench_env as jbench_env
from perceptor_tpu_torch.utils import bench_env
from perceptor_tpu_torch.utils.flops import count_model_flops

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_cuda_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run([sys.executable, "bench_cuda.py", "--repeats", "1"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not proc.stdout.strip()


@pytest.mark.parametrize("name", sorted(bench_cuda.CELLS))
def test_cell_runs_at_tiny_size(name):
    cell = bench_cuda.CELLS[name](seed=0, tiny=True, device="cpu")
    assert cell.path in PER_STEP
    outputs = cell.run()
    cell.check(outputs)
    assert tuple(outputs[0].shape) == tuple(cell.out_shape)
    assert count_model_flops(cell.run) > 0


def test_bench_env_has_the_jax_keys_and_the_card_block():
    env = bench_env.bench_env({"library": "lib", "state": "hit", "seconds": 0.0})
    jax_env = jbench_env.bench_env()
    assert set(jax_env) <= set(env)
    assert {"torch", "cuda", "triton", "card", "build"} <= set(env)
    assert env["other_python_procs"] >= 0 and len(env["loadavg"]) == 3
    if not torch.cuda.is_available():
        assert env["card"] is None and env["cuda"] is None


def test_layer_metrics_names_each_idle_gap_after_the_innermost_span():
    """Synthetic events (us): a repeat from 0 to 100 with two kernels and
    nested spans; the gaps are 10-30 (under `unet` inside `step`), 40-90
    (under `backward` only) and 95-100."""
    kernels = [(0, 10, "void flash::fwd_kernel<40>"), (30, 40, "gemm"), (90, 95, "gemm")]
    spans = [(0, 100, "step"), (5, 35, "unet"), (41, 89, "backward")]
    metrics = bench_cuda.layer_metrics(kernels, spans, "step", n_steps=2)
    assert metrics["device_ms_per_step"] == pytest.approx(25e-3 / 2)
    assert metrics["flash_ms_per_step"] == pytest.approx(10e-3 / 2)
    assert metrics["launches_per_step"] == 1.5
    assert [(g["ms"], g["span"]) for g in metrics["idle_gaps"]] == [
        (pytest.approx(50e-3), "backward"), (pytest.approx(20e-3), "unet"),
        (pytest.approx(5e-3), "step")]
    assert metrics["top_kernels"][0] == {"name": "gemm", "ms_per_step": pytest.approx(7.5e-3),
                                         "count": 2}
