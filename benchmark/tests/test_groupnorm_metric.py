"""The GroupNorm reader (`metrics/groupnorm_device_ms_per_step.py`) on
synthetic traces and span logs: the device work launched inside the port's
`group_norm` and `group_norm.backward` spans, None from a port that opens
neither.

    python -m pytest benchmark/tests/test_groupnorm_metric.py -q -p no:cacheprovider
"""

import pytest

from benchmark.harness import registry
from benchmark.tests.test_port_spans import reading, record
from perceptor_tpu_torch.utils import profiling

METRIC = "groupnorm_device_ms_per_step"


def test_reads_the_work_launched_inside_group_norm_spans(monkeypatch):
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    reader = registry.load_module("metrics", METRIC)
    # stats and apply of one call launched inside it, a convolution after it
    r = reading([(10, 14, "gn_stats", 1), (14, 20, "gn_apply", 2), (20, 40, "conv", 3)],
                {1: 5.0, 2: 6.0, 3: 8.0}, steps=2)
    assert reader.read(r) is None
    records += [record("unet", 0, 9), record("group_norm", 4, 7, parent="unet")]
    assert reader.read(r) == pytest.approx(10 / 1e3 / 2)


def test_adds_the_backward_kernels_launched_inside_group_norm_backward_spans(monkeypatch):
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    reader = registry.load_module("metrics", METRIC)
    # a forward call's two kernels, a convolution's dgrad, a backward call's two
    r = reading([(10, 14, "gn_stats", 1), (14, 20, "gn_apply", 2), (20, 40, "dgrad", 3),
                 (40, 43, "gn_bwd_sums", 4), (43, 48, "gn_bwd_dx", 5)],
                {1: 5.0, 2: 6.0, 3: 8.0, 4: 12.0, 5: 13.0}, steps=2)
    records += [record("unet.backward", 11, 14),
                record("group_norm.backward", 11.5, 13.5, parent="unet.backward")]
    assert reader.read(r) == pytest.approx(8 / 1e3 / 2)
    records += [record("unet", 0, 9), record("group_norm", 4, 7, parent="unet")]
    assert reader.read(r) == pytest.approx(18 / 1e3 / 2)


def test_is_declared_for_both_cells_under_the_kernels_layer():
    entries = {m["name"]: m for m in registry.benchmark_spec()["per_layer"]}
    guided, b8 = entries[METRIC], entries[METRIC + ".device_bound"]
    assert guided["workloads"] == ["sd15_clipguided_512_b1"] and guided["moves"] == "ms_per_step"
    assert b8["workloads"] == ["sd15_txt2img_512_b8"]
    assert b8["moves"] == "ms_per_step.device_bound"
    assert guided["layer"] == b8["layer"] == "kernels" and guided["unit"] == "ms/step"
