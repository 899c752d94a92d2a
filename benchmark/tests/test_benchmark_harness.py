"""The harness at tiny sizes on the CPU: both cells' drivers against the
reference, the control and the planted faults coming out not correct, the
metric arithmetic on synthetic traces, the run command without a card, and
what the runs import."""

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import compare, flops, registry, trace
from benchmark.harness.weights import draw
from benchmark.reference.sd_unet import UNet2DConditionModel
from benchmark.tests import faults

ROOT = registry.ROOT
TINY = {
    "sd15_clipguided_512_b1": ("tiny_guided.json", {"trajectory_steps": 3}),
    "sd15_txt2img_512_b8": ("tiny_sd.json", {"size": 16, "prompts_per_call": 2, "steps": 4}),
}
CELLS = sorted(TINY)


def tiny_overrides(cell: str) -> dict:
    config, mix = TINY[cell]
    entry = registry.cell_spec(cell)
    return {"config_data": registry.load_json(registry.BENCH_DIR / "tests" / "configs" / config),
            "mix": dict(entry["mix"], **mix)}


@contextlib.contextmanager
def tiny_port(config: dict):
    """The port's tiny SD text tower with the configuration's vocabulary
    (CLIP's 49408), so that the port's own tokenizer serves it."""
    from perceptor_tpu_torch.models.stable_diffusion import config as sd_config

    text = sd_config.TINY_TEXT
    vocab = config.get("text_encoder", {}).get("vocab_size", text.vocab_size)
    sd_config.TINY_TEXT = dataclasses.replace(text, vocab_size=vocab)
    try:
        yield
    finally:
        sd_config.TINY_TEXT = text


def tiny_run(cell: str, seed: int = 2**31 + 5, seconds: float = 0.3) -> dict:
    overrides = tiny_overrides(cell)
    with tiny_port(overrides["config_data"]):
        return run.run(cell, seed, seconds, False, device="cpu", cell_overrides=overrides)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_matches_reference_at_tiny_size(cell):
    result = tiny_run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    # in float32 on both sides the program and the reference agree to rounding
    for name, check in result["checks"].items():
        assert check["value"] <= 1e-4, (name, check)
    assert set(result["metrics"]) == {m["name"] for m in run.cell_metrics(
        registry.benchmark_spec()["end_to_end"], cell)}


def test_inputs_and_traffic_are_drawn_from_the_seed():
    guided = registry.load_module("drivers", "guided_step")
    txt2img = registry.load_module("drivers", "txt2img")
    cfg = tiny_overrides("sd15_clipguided_512_b1")["config_data"]
    a, b, c = (guided.inputs(cfg, 1, seed, "cpu") for seed in (2**35, 2**35, 2**35 + 1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    mix = registry.cell_spec("sd15_txt2img_512_b8")["mix"]
    first, same, other = (txt2img.Traffic(mix, seed) for seed in (5, 5, 6))
    calls = [first.next() for _ in range(3)]
    assert calls == [same.next() for _ in range(3)] != [other.next() for _ in range(3)]
    assert all(len(set(prompts)) == mix["prompts_per_call"] for prompts, _ in calls)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    entry = registry.cell_spec(cell)
    entry.update(tiny_overrides(cell))
    driver = registry.load_module("drivers", entry["driver"])
    for seed in (3, 4, 2**40 + 1):
        checks = compare.verdict(driver.control_measures(entry, seed, torch.device("cpu")),
                                 entry["limits"])
        assert not compare.correct(checks), checks


FAULTS = [(cell, name) for cell, names in sorted(faults.CELL_FAULTS.items()) for name in names]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch)
    result = tiny_run(cell)
    assert not result["correct"], result["checks"]


def test_interval_union_and_attribution():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert trace.length([(0, 2), (1, 3), (5, 6)]) == 4
    kernels = [(10, 20, "k1", 1), (15, 30, "k2", 2), (40, 45, "k3", 3), (50, 52, "k4", 9)]
    launch_at = {1: 1.0, 2: 2.0, 3: 8.0}  # correlation id 9 has no host launch
    spans = [(0, 5, "unet"), (0, 60, trace.CALL_SPAN), (6, 9, "backward"), (31, 39, "vae")]
    t = trace.Trace(kernels, launch_at, 3, spans, 0.0)
    assert [k[2] for k in t.kernels_in({"unet"})] == ["k1", "k2"]
    assert t.busy_us(t.kernels_in({"unet"})) == 20
    assert [k[2] for k in t.kernels_in({"backward"})] == ["k3"]
    assert t.busy_us() == 20 + 5 + 2
    # idle: 0-10 (the middle, 5, in "unet"), 30-40 (in "vae"), 45-50, 52-60
    assert t.idle_gaps(3) == [["unet", 10e-6], ["vae", 10e-6], [trace.CALL_SPAN, 8e-6]]


def _reading(kernels, attention, ms_per_step=1.0, flops_per_step=0.0, steps=1):
    spans = [(0, 1e9, trace.CALL_SPAN), (0, 1e9, "perceptor_tpu_torch::flash_fwd")]
    launch_at = {k[3]: 1.0 for k in kernels}
    t = trace.Trace(kernels, launch_at, len(kernels), spans, 0.0)
    return trace.Reading(trace=t, steps=steps, ms_per_step=ms_per_step,
                         flops_per_step=flops_per_step, attention_per_call=attention, calls=1,
                         attention_ops=registry.attention_ops(), peak_flops=989e12,
                         peak_bytes=3.35e12)


def test_attention_roofline_and_mfu_at_most_100_on_known_shapes():
    ops = registry.attention_ops()
    q = torch.zeros(1, 8, 256, 40)
    counter = flops.FlopCount(ops)
    with counter:
        from perceptor_tpu_torch.ops.flash_attention_kernel import flash_forward

        flash_forward(q, q, q, 0.1)
    assert len(counter.attention) == 1
    name, f, nbytes = counter.attention[0]
    assert f == 4 * 8 * 256 * 256 * 40 == counter.flops  # nothing inside the op counted
    assert nbytes == 4 * q.numel() * 4 + 8 * 256 * 4  # q, k, v read; o, lse written
    least_s = max(f / 989e12, nbytes / 3.35e12)
    roofline = registry.load_module("metrics", "attention_roofline")
    # a kernel that takes exactly the least time reads 100 %, a slower one less
    assert roofline.read(_reading([(0, least_s * 1e6, "k", 1)], counter.attention)) == \
        pytest.approx(100.0)
    assert roofline.read(_reading([(0, 4 * least_s * 1e6, "k", 1)], counter.attention)) == \
        pytest.approx(25.0)
    assert roofline.read(_reading([], counter.attention)) is None
    mfu = registry.load_module("metrics", "mfu")
    assert mfu.read(_reading([], [], ms_per_step=1.0, flops_per_step=989e9)) == \
        pytest.approx(100.0)
    idle = registry.load_module("metrics", "device_idle_share")
    assert idle.read(_reading([(0, 250.0, "k", 1)], [], ms_per_step=1.0)) == pytest.approx(75.0)


def test_flop_count_of_a_matmul_and_a_convolution():
    with flops.FlopCount({}) as counter:
        torch.ones(4, 5) @ torch.ones(5, 6)
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8), torch.ones(2, 3, 3, 3), padding=1)
    assert counter.flops == 2 * 4 * 5 * 6 + 2 * 2 * 3 * 9 * 64


def test_window_counts_whole_calls():
    class Sleeper:
        sampling = False

        def call(self):
            time.sleep(0.03)

    wall_s, times = run.window(Sleeper(), 0.1)
    assert len(times) == 4  # the call that starts at 0.09 s runs to its end
    assert wall_s >= sum(times) and wall_s >= 0.12


def test_weights_are_drawn_from_the_seed():
    cfg = registry.load_json(registry.BENCH_DIR / "tests" / "configs" / "tiny_sd.json")["unet"]
    a, b = (draw(UNet2DConditionModel, cfg, 7, "unet", "cpu") for _ in range(2))
    c = draw(UNet2DConditionModel, cfg, 8, "unet", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    assert a["conv_in.weight"].dtype == torch.bfloat16 and a["conv_in.bias"].dtype == torch.float32


def test_run_exits_nonzero_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sd15_txt2img_512_b8", "--seed",
         str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_runs_load_no_jax_and_the_reference_no_program():
    code = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.test_benchmark_harness import tiny_run
from benchmark import run
before = sorted({{m.split(".")[0] for m in sys.modules}})
import benchmark.reference.pipelines, benchmark.reference.tokenizer
reference_only = sorted(m for m in sys.modules if m.startswith("perceptor_tpu_torch"))
for cell in ("sd15_clipguided_512_b1", "sd15_txt2img_512_b8"):
    assert tiny_run(cell)["correct"]
print(json.dumps({{"reference_only": reference_only, "forbidden": run.forbidden_modules(),
                   "program": "perceptor_tpu_torch" in sys.modules}}))
""".format(root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["reference_only"] == []  # the reference loads nothing of the program
    assert out["forbidden"] == [] and out["program"]  # the runs load the port, never JAX


def test_benchmark_json_names_only_files_that_exist():
    spec = registry.benchmark_spec()
    for config in spec["configs"]:
        assert (ROOT / config["file"]).is_file()
    for cell in spec["workloads"]:
        entry = registry.cell_spec(cell["name"], spec)
        assert (registry.BENCH_DIR / "drivers" / f"{entry['driver']}.py").is_file()
        assert all(math.isfinite(v) for v in entry["limits"].values())
    for metric in spec["per_layer"]:
        assert callable(registry.load_module("metrics", registry.quantity(metric["name"])).read)
    assert set(registry.attention_ops()) == {"perceptor_tpu_torch::flash_fwd",
                                             "perceptor_tpu_torch::flash_dq",
                                             "perceptor_tpu_torch::flash_dkv"}


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell, cuda_device):
    result = run.run(cell, 2**31 + 99, 5.0, False, device=cuda_device)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
