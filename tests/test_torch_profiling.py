"""The port's runtime observability (perceptor_tpu_torch/utils/profiling.py)
against the JAX package's: the StepTimer summary's keys, memory stats on
the CPU, and a trace with a named span."""

import json
import os

from perceptor_tpu.utils import profiling as jprofiling
from perceptor_tpu_torch.utils import profiling

import torch

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)


def test_step_timer_summary_has_the_jax_keys():
    timers = (profiling.StepTimer(), jprofiling.StepTimer())
    for timer in timers:
        for _ in range(3):
            with timer.step() as probe:
                probe(torch.ones(2) * 2)
    summaries = [timer.summary() for timer in timers]
    assert set(summaries[0]) == set(summaries[1])
    assert summaries[0]["steps"] == 2 and summaries[0]["p50_s"] >= 0.0
    empty = profiling.StepTimer()
    try:
        empty.summary()
    except ValueError:
        pass
    else:
        raise AssertionError("summary() of no steps must raise")


def test_memory_stats_are_empty_on_the_cpu():
    assert profiling.memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.memory_stats() == {} and profiling.live_array_bytes() == 0


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("bench_span"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    with open(tmp_path / path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "bench_span" for e in events)
