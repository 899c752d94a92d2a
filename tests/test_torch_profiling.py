"""The port's runtime observability (perceptor_tpu_torch/utils/profiling.py)
against the JAX package's: the StepTimer summary's keys, memory stats on
the CPU, and a trace with a named span."""

import json
import os

from perceptor_tpu.utils import profiling as jprofiling
from perceptor_tpu_torch.utils import profiling

import pytest
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


# -- the port's spans ---------------------------------------------------------

class InRangeTokenizer:
    """A stand-in tokenizer whose ids fit TINY_TEXT's 128-entry table."""

    sot_token, eot_token = 126, 127

    def encode(self, text):
        return [ord(c) % 126 for c in text]


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def _profiled(fn):
    """`fn()` under a CPU profiler, the span log cleared first: (result,
    spans, profiler)."""
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof


def test_annotate_without_a_profiler_is_one_null_context_and_records_nothing():
    profiling.clear_spans()
    first, second = profiling.annotate("unet", rows=1), profiling.annotate("sample", call=3)
    assert first is second
    with first:
        x = torch.ones(3, requires_grad=True)
        y = x * 2
        profiling.backward_span("double", (x,), (y,))
        y.sum().backward()
    assert x._backward_hooks is None and y._backward_hooks is None  # no hook added
    assert profiling.spans() == []


def test_spans_nest_carry_ids_and_keep_the_newest():
    def nested():
        with profiling.annotate("outer", call=7):
            with profiling.annotate("inner", rows=2):
                pass

    _, spans, _ = _profiled(nested)
    inner, outer = spans
    assert (outer.name, outer.parent, outer.ids) == ("outer", None, {"call": 7})
    assert (inner.name, inner.parent, inner.ids) == ("inner", "outer", {"call": 7, "rows": 2})
    assert _inside(inner, outer) and outer.start_ns < outer.end_ns
    # the log is bounded: the oldest records go first
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(profiling.SPAN_LOG_LIMIT + 3):
            with profiling.annotate("many", i=i):
                pass
    log = profiling.spans()
    assert len(log) == profiling.SPAN_LOG_LIMIT and log[0].ids == {"i": 3}
    profiling.clear_spans()
    assert profiling.spans() == []


def test_a_span_on_another_thread_takes_the_open_span_as_parent(monkeypatch):
    """The autograd engine's device threads run a backward while the caller
    waits inside its span: such a span's parent is the caller's. (The
    engine's threads inherit the profiler's state; a plain thread does not,
    so this one is told it records.)"""
    import threading

    monkeypatch.setattr(profiling, "_recording", lambda: True)

    def waiting():
        with profiling.annotate("caller", step=4):
            worker = threading.Thread(target=lambda: profiling.annotate("worker").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()

    _, spans, _ = _profiled(waiting)
    worker, caller = spans
    assert (worker.parent, worker.ids) == ("caller", {"step": 4})
    assert worker.thread != caller.thread and _inside(worker, caller)


def test_a_backward_span_closes_with_the_pass_when_an_input_gets_no_gradient():
    x, y = (torch.randn(3, requires_grad=True) for _ in range(2))

    def grad_of_x_only():
        z = x * y
        profiling.backward_span("product", (x, y), (z,))
        with profiling.annotate("after"):
            pass
        (grad,) = torch.autograd.grad(z.sum(), x)
        with profiling.annotate("later"):
            pass
        return grad

    grad, spans, _ = _profiled(grad_of_x_only)
    assert torch.equal(grad, y)
    assert [r.name for r in spans] == ["after", "product.backward", "later"]
    assert spans[-1].parent is None  # the closed span is no one's parent


def test_a_backward_that_raises_leaves_no_span_open():
    """A pass that raises reaches neither the span's last input nor its end:
    the port's span around it, exiting, forgets the backward span, so later
    spans are roots again."""
    x = torch.randn(3, requires_grad=True)

    def planted(_grad):
        raise RuntimeError("planted")

    def failing_then_later():
        y = x * 2
        out = y.exp()
        profiling.backward_span("exp", (x,), (out,))
        y.register_hook(planted)  # after `exp.backward` opened, before it closes
        with pytest.raises(RuntimeError, match="planted"):
            with profiling.annotate("guidance_backward"):
                torch.autograd.grad(out.sum(), x)
        with profiling.annotate("later"):
            pass

    _, spans, _ = _profiled(failing_then_later)
    assert [(r.name, r.parent) for r in spans] == [("guidance_backward", None),
                                                   ("later", None)]
    assert profiling._OPEN == []


def test_guided_step_records_its_spans_and_backward_by_model():
    from perceptor_tpu_torch import guided_step

    step = guided_step.build("tiny", device="cpu")
    latents, context = step.initial_inputs()

    def two_steps():
        out = latents
        for _ in range(2):
            out, _ = step.guided_denoise_step(out, context)

    _, spans, _ = _profiled(two_steps)
    names = _by_name(spans)
    roots = names["guided_step"]
    assert [r.ids["step"] for r in roots] == [0, 1] and all(r.parent is None for r in roots)
    for root in roots:
        mine = [r for r in spans if r is not root and _inside(r, root)]
        by = _by_name(mine)
        for child in ("unet", "vae_decode", "clip_loss", "guidance_backward", "guided_update"):
            (record,) = by[child]
            assert record.parent == "guided_step" and record.ids["step"] == root.ids["step"]
        assert by["unet"][0].ids["rows"] == by["vae_decode"][0].ids["rows"] == 1
        (backward,) = by["guidance_backward"]
        parts = [by[f"{name}.backward"][0] for name in ("clip_loss", "vae_decode", "unet")]
        for part in parts:  # inside the backward, disjoint, CLIP then VAE then UNet
            assert part.parent == "guidance_backward" and _inside(part, backward)
        assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
        forward = [by[name][0] for name in ("unet", "vae_decode", "clip_loss")]
        assert all(a.end_ns <= b.start_ns for a, b in zip(forward, forward[1:]))
        assert forward[-1].end_ns <= backward.start_ns <= backward.end_ns <= \
            by["guided_update"][0].start_ns


def test_sample_records_text_encode_sampler_steps_and_decode():
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    sd = StableDiffusion("tiny", fp16=False, tokenizer=InRangeTokenizer(), device="cpu")
    _, spans, _ = _profiled(lambda: sd.sample(["a cat"], n_steps=2, size=(16, 16)))
    names = _by_name(spans)
    (root,) = names["sample"]
    assert root.parent is None and root.ids == {"call": 0, "rows": 1}
    encodes, steps = names["text_encode"], names["sampler_step"]
    assert len(encodes) == 2 and all(r.parent == "sample" and r.ids["rows"] == 1
                                     for r in encodes)
    assert [r.ids["step"] for r in steps] == [0, 1] and all(r.parent == "sample" for r in steps)
    for step in steps:
        inside = _by_name(r for r in spans if r is not step and _inside(r, step))
        (unet,) = inside["unet"]
        assert unet.parent == "sampler_step" and unet.ids["rows"] == 2  # the CFG pair
        (combine,) = inside["cfg_combine"]
        (update,) = inside["sampler_update"]
        assert combine.parent == update.parent == "sampler_step"
        assert unet.end_ns <= combine.start_ns and combine.end_ns <= update.start_ns
    (decode,) = names["vae_decode"]
    assert decode.parent == "sample" and decode.start_ns >= steps[-1].end_ns
    assert all(_inside(r, root) for r in spans)


def test_profiler_events_lie_inside_the_spans_on_their_clock():
    """The log's clock is the one the profiler's events carry: every
    convolution the profiler saw in the UNet's forward lies in a `unet`
    span."""
    from perceptor_tpu_torch.core.init import random_module
    from perceptor_tpu_torch.models.stable_diffusion import config as sd_config
    from perceptor_tpu_torch.models.stable_diffusion.unet import UNet

    unet = random_module(UNet, sd_config.TINY_UNET, torch.device("cpu"),
                         torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn(1, sd_config.TINY_UNET.in_channels, 8, 8)
    context = torch.randn(1, 77, sd_config.TINY_UNET.context_dim)

    def forwards():
        with torch.no_grad():
            for t in (10.0, 500.0):
                unet(x, torch.tensor([t]), context)

    _, spans, prof = _profiled(forwards)
    unets = [r for r in spans if r.name == "unet"]
    assert len(unets) == 2
    convolutions = [e for e in prof.profiler.kineto_results.events()
                    if e.name() == "aten::convolution"]
    assert convolutions
    for e in convolutions:
        assert any(r.start_ns <= e.start_ns() and e.end_ns() <= r.end_ns for r in unets), \
            (e.start_ns(), e.end_ns(), [(r.start_ns, r.end_ns) for r in unets])


def test_guided_step_is_bitwise_the_same_under_the_profiler():
    from perceptor_tpu_torch import guided_step

    step = guided_step.build("tiny", device="cpu")
    latents, context = step.initial_inputs()
    plain = step.guided_denoise_step(latents, context)
    traced, spans, _ = _profiled(lambda: step.guided_denoise_step(latents, context))
    assert spans
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def test_a_program_exported_under_a_profiler_holds_no_span():
    from perceptor_tpu_torch import guided_step
    from perceptor_tpu_torch.utils import serving

    step = guided_step.build("tiny", device="cpu")
    latents, context = step.initial_inputs()
    program, spans, _ = _profiled(lambda: serving.export_program(
        step.guided_denoise_step, latents, context, grad=True))
    targets = [str(node.target) for node in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    assert spans == []
