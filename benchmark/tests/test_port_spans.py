"""The readers of the port's own spans (`harness/port_spans.py` and the
metrics that use it) on synthetic traces and span logs, and (marked `chip`)
the port's spans against the benchmark's own on the card.

    python -m pytest benchmark/tests/test_port_spans.py -q -p no:cacheprovider
"""

import pytest

from benchmark import run
from benchmark.harness import port_spans, registry, trace
from benchmark.tests.test_benchmark_harness import CELLS
from perceptor_tpu_torch.utils import profiling

NEW_READERS = {
    "clip_device_ms_per_step": "clip_loss",
    "unet_backward_device_ms_per_step": "unet.backward",
    "vae_backward_device_ms_per_step": "vae_decode.backward",
    "clip_backward_device_ms_per_step": "clip_loss.backward",
    "text_device_ms_per_step": "text_encode",
}


def record(name, start_us, end_us, parent=None):
    return profiling.SpanRecord(name, parent, {}, 1, int(start_us * 1e3), int(end_us * 1e3))


def reading(kernels, launch_at, steps=1, window=(0.0, 100.0)):
    spans = [(window[0], window[1], trace.CALL_SPAN)]
    t = trace.Trace(kernels, launch_at, len(launch_at), spans, 0.0)
    return trace.Reading(trace=t, steps=steps, ms_per_step=1.0, flops_per_step=0.0,
                         attention_per_call=[], calls=1, attention_ops={}, peak_flops=989e12,
                         peak_bytes=3.35e12)


@pytest.fixture
def log(monkeypatch):
    """The port's span log, replaced by the test's list."""
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return records


def test_device_work_belongs_to_the_span_its_launch_lies_in(log):
    # kernels run later than they launch; one has no host launch
    kernels = [(10, 30, "a", 1), (35, 40, "b", 2), (50, 70, "c", 3), (60, 65, "d", 4),
               (80, 90, "e", 9)]
    r = reading(kernels, {1: 2.0, 2: 8.0, 3: 21.0, 4: 22.0}, steps=2)
    log += [record("unet", 1, 9), record("vae_decode", 20, 25), record("unet", 200, 300),
            record("old", -500, -400)]
    assert [s[2] for s in port_spans.in_window(r)] == ["unet", "vae_decode"]
    assert [k[2] for k in port_spans.kernels_in(r, port_spans.in_window(r)[:1])] == ["a", "b"]
    assert port_spans.device_ms_per_step(r, "unet") == pytest.approx((20 + 5) / 1e3 / 2)
    # c and d overlap: the union, not the sum
    assert port_spans.device_ms_per_step(r, "vae_decode") == pytest.approx(20 / 1e3 / 2)
    assert port_spans.device_ms_per_step(r, "clip_loss") is None
    # a span that exists but launched nothing reads 0
    log.append(record("clip_loss", 95, 99))
    assert port_spans.device_ms_per_step(r, "clip_loss") == 0.0


@pytest.mark.parametrize("metric", sorted(NEW_READERS))
def test_each_span_reader_reads_its_span_and_none_without_it(metric, log):
    reader = registry.load_module("metrics", metric)
    r = reading([(10, 14, "k", 1)], {1: 5.0}, steps=4)
    assert reader.read(r) is None
    log.append(record(NEW_READERS[metric], 4, 6, parent="parent"))
    assert reader.read(r) == pytest.approx(4 / 1e3 / 4)
    log[0] = record("another", 4, 6)
    assert reader.read(r) is None


SPAN_READERS = (*NEW_READERS, "idle_in_program_share", "idle_in_program_ms_per_step",
                "sampler_host_ms_per_step")


def test_readers_read_none_from_a_port_without_the_log(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    r = reading([(10, 14, "k", 1)], {1: 5.0})
    assert port_spans.port_log() == []
    for metric in SPAN_READERS:
        assert registry.load_module("metrics", metric).read(r) is None


def test_idle_in_program_share_on_hand_made_gaps(log):
    share = registry.load_module("metrics", "idle_in_program_share")
    kernels = [(10, 20, "a", 1), (40, 60, "b", 2)]  # idle 0-10, 20-40, 60-100: 70 us
    r = reading(kernels, {1: 1.0, 2: 30.0})
    assert share.read(r) is None  # no root span
    log.append(record("unet", 0, 100, parent="sample"))  # a child alone is no root
    assert share.read(r) is None
    log.append(record("sample", 0, 100))
    assert share.read(r) == pytest.approx(100.0)
    log[-1] = record("sample", 10, 40)  # holds the 20-40 gap only
    assert share.read(r) == pytest.approx(100.0 * 20 / 70)
    log[-1] = record("guided_step", 20.5, 39.5)
    log.append(record("guided_step", 60, 65))
    assert share.read(r) == pytest.approx(100.0 * (19 + 5) / 70)
    log[:] = [record("sample", 10, 20), record("guided_step", 40, 60)]  # only busy time
    assert share.read(r) == 0.0
    busy = reading([(0, 100, "a", 1)], {1: 1.0})
    assert share.read(busy) == 0.0  # the device never idled


def test_idle_in_program_ms_counts_the_held_idle_time_a_step(log):
    """The idle time inside the port's roots, a step: unlike the share, it
    does not fall when the caller's idle time grows."""
    held = registry.load_module("metrics", "idle_in_program_ms_per_step")
    kernels = [(10, 20, "a", 1), (40, 60, "b", 2)]  # idle 0-10, 20-40, 60-100
    r = reading(kernels, {1: 1.0, 2: 30.0}, steps=2)
    assert held.read(r) is None
    log.append(record("guided_step", 10, 40))  # holds the 20-40 gap
    assert held.read(r) == pytest.approx(20 / 1e3 / 2)
    wider = reading(kernels, {1: 1.0, 2: 30.0}, steps=2, window=(-200.0, 100.0))
    assert held.read(wider) == held.read(r)  # more idle time outside the port
    share = registry.load_module("metrics", "idle_in_program_share")
    assert share.read(wider) < share.read(r)
    log[:] = [record("sample", 10, 20)]
    assert held.read(r) == 0.0


def test_sampler_host_ms_is_the_sampler_steps_less_their_unet(log):
    host = registry.load_module("metrics", "sampler_host_ms_per_step")
    r = reading([(10, 14, "k", 1)], {1: 5.0}, steps=2)
    log.append(record("unet", 0, 10, parent="guided_step"))
    assert host.read(r) is None
    log += [record("sampler_step", 10, 40, parent="sample"),
            record("unet", 12, 30, parent="sampler_step"),
            record("cfg_combine", 30, 33, parent="sampler_step"),
            record("sampler_step", 50, 60, parent="sample"),
            record("unet", 51, 58, parent="sampler_step"),
            record("sampler_step", 95, 120, parent="sample")]  # clipped at the window's end
    assert host.read(r) == pytest.approx((30 - 18 + 10 - 7 + 5) / 1e3 / 2)
    log[:] = [record("guided_update", 70, 76, parent="guided_step"),
              record("unet", 0, 10, parent="guided_step")]
    assert host.read(r) == pytest.approx(6 / 1e3 / 2)


def test_the_new_metrics_are_declared_with_their_cells():
    spec = registry.benchmark_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    guided, b8 = "sd15_clipguided_512_b1", "sd15_txt2img_512_b8"
    for name in (*[m for m in NEW_READERS if m != "text_device_ms_per_step"],
                 "idle_in_program_share"):
        assert entries[name]["workloads"] == [guided] and entries[name]["moves"] == "ms_per_step"
    for name in ("idle_in_program_ms_per_step", "sampler_host_ms_per_step"):
        assert entries[name]["workloads"] == [guided] and entries[name]["moves"] == "ms_per_step"
    for name in ("text_device_ms_per_step", "idle_in_program_share",
                 "idle_in_program_ms_per_step", "sampler_host_ms_per_step"):
        name += ".device_bound"
        assert entries[name]["workloads"] == [b8]
        assert entries[name]["moves"] == "ms_per_step.device_bound"
    for name in ("idle_in_program_share", "idle_in_program_share.device_bound"):
        assert entries[name]["unit"] == "%"
    for name in ("sampler_host_ms_per_step", "sampler_host_ms_per_step.device_bound"):
        assert entries[name]["source"] == "program_span"


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_port_spans_agree_with_the_benchmark_spans_on_the_card(cell, cuda_device, monkeypatch):
    """A `--trace 1` run of the cell: the UNet's and the VAE decode's device
    ms through the port's own spans (stamped on the host's clock) within 1 %
    of the benchmark's readers (its spans, on the profiler's); the new
    metrics read; in the guided cell the three backward parts make up
    97-100.5 % of the whole backward."""
    readings = []

    class Kept(trace.Reading):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            readings.append(self)

    monkeypatch.setattr(trace, "Reading", Kept)
    result = run.run(cell, 2**31 + 77, 5.0, True, device=cuda_device)
    assert result["correct"], result["checks"]
    (r,) = readings
    metrics = {name: m["value"] for name, m in result["metrics"].items()}
    suffix = "" if cell == "sd15_clipguided_512_b1" else ".device_bound"
    for span, outside in (("unet", "unet_device_ms_per_step"),
                          ("vae_decode", "vae_device_ms_per_step")):
        assert port_spans.device_ms_per_step(r, span) == \
            pytest.approx(metrics[outside + suffix], rel=0.01)
    new = [m["name"] for m in run.cell_metrics(registry.benchmark_spec()["per_layer"], cell)
           if registry.quantity(m["name"]) in SPAN_READERS]
    assert len(new) == (7 if not suffix else 4) and all(name in metrics for name in new)
    assert 0.0 <= metrics["idle_in_program_share" + suffix] <= 100.0
    assert 0.0 < metrics["sampler_host_ms_per_step" + suffix] < r.trace.wall_s * 1e3 / r.steps
    assert 0.0 <= metrics["idle_in_program_ms_per_step" + suffix] <= r.trace.wall_s * 1e3 / r.steps
    if not suffix:
        parts = sum(metrics[f"{m}_backward_device_ms_per_step"] for m in ("unet", "vae", "clip"))
        assert 0.97 <= parts / metrics["backward_device_ms_per_step"] <= 1.005
