"""The LayerNorm reader (`metrics/layernorm_device_ms_per_step.py`) on
synthetic traces and span logs: the device work launched inside the port's
`layer_norm` spans, None from a port that opens none.

    python -m pytest benchmark/tests/test_layernorm_metric.py -q -p no:cacheprovider
"""

import pytest

from benchmark.harness import registry
from benchmark.tests.test_port_spans import reading, record
from perceptor_tpu_torch.utils import profiling

METRIC = "layernorm_device_ms_per_step"


def test_reads_the_work_launched_inside_layer_norm_spans(monkeypatch):
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    reader = registry.load_module("metrics", METRIC)
    # a block's norm1, its q projection, norm2 after the attention
    r = reading([(10, 13, "add_ln_kernel", 1), (13, 30, "gemm", 2),
                 (30, 35, "add_ln_kernel", 3)],
                {1: 5.0, 2: 6.0, 3: 8.0}, steps=2)
    assert reader.read(r) is None
    records += [record("spatial_transformer", 0, 9),
                record("layer_norm", 4, 5.5, parent="spatial_transformer")]
    assert reader.read(r) == pytest.approx(3 / 1e3 / 2)
    records.append(record("layer_norm", 7.5, 8.5, parent="spatial_transformer"))
    assert reader.read(r) == pytest.approx(8 / 1e3 / 2)
    # a port that opens no `layer_norm` span (the parent of this metric)
    records[:] = [record("spatial_transformer", 0, 9), record("group_norm", 4, 9)]
    assert reader.read(r) is None


def test_is_declared_for_the_device_bound_transformer_cells():
    entries = {m["name"]: m for m in registry.benchmark_spec()["per_layer"]}
    metric = entries[METRIC + ".device_bound"]
    assert metric["workloads"] == ["sdxl_txt2img_1024_b4", "sd15_txt2img_512_b8"]
    assert metric["moves"] == "ms_per_step.device_bound"
    assert metric["layer"] == "kernels" and metric["unit"] == "ms/step"
    assert metric["source"] == "device_trace" and metric["better"] == "lower"
    assert METRIC not in entries
