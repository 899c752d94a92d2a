#!/usr/bin/env python3
"""The port's benchmark on one NVIDIA GPU: one JSON line per cell.

    python3 bench_cuda.py [--seed N] [--cell NAME]... [--repeats R]

The counterpart of bench.py and bench_families.py for perceptor_tpu_torch:
each cell is one of their configurations that the port covers, at their
sizes and step counts, with published widths and random weights drawn from
`--seed` (the tree holds no checkpoints; FLOPs and memory equal those of
trained weights). Every cell runs eager, batch 1 unless named, on one card:

  sd512_guided_step            bench.py's guided denoise step at 512px, 30 steps
  sd512_txt2img_cfg7_ddim20    StableDiffusion.sample, one prompt, CFG 7, DDIM 20
  adm512_sample50              GuidedDiffusion("standard").sample, 50 steps
  velocity_yfcc2_512_sample50  VelocityDiffusion("yfcc_2").sample, 50 steps
  ldm_txt2img_256_sample50     latent_diffusion.Text2Image at 256px, 50 steps
  monster48_b16_eval100        MonsterDiffusion("all"), 16 sprites, 100 evaluations
  raw256_clip_opt100           Raw 256px under CLIP ViT-B/32, Adam 0.05, 100 steps
  velocity_yfcc2_256_guided50  engine.guided_sample over yfcc_2 at 256px, 50 steps
  raw512_cutouts32_opt100      Raw 512px, 32 cutouts of 224 under CLIP, 100 steps
  adm256_pixelart_ensemble_guided50  engine.guided_sample over ADM "pixelart" at 256px
                               under BLIP + CLOOB + SLIP, 50 steps
  dip256_openclip_opt100       DeepImagePrior 256px under OpenCLIP ViT-B/32, Adam 0.01,
                               100 steps

Per cell: the model is built, one untimed warm-up repeat runs (it holds the
cuDNN and cuBLAS set-up) and is checked (finite outputs of the expected
shape; flash launches equal to chip_smoke.py's PER_STEP row for the path),
then `--repeats` timed repeats of the fixed step count, each ended by
`torch.cuda.synchronize()`, then one more repeat under torch.profiler for
the per-layer metrics, then one run under `utils.flops.count_model_flops`
(every attention on the dot-product path) for the model FLOPs. A step is
what the bench_families.py row counts: a sampler step, a MonsterDiffusion
evaluation, an optimizer step.

Each line has bench.py's keys (`metric`, `value` = `ms_per_step`, `unit`,
`compile_s` = model build plus the warm-up repeat, `steady_s` = the median
repeat, `n_steps`, `env`) and:

  ms_per_step            median wall ms per step over the repeats, with the
                         quartiles and every repeat's value
  mfu                    model FLOPs of a step / its median seconds / the
                         card's dense bf16 peak
  peak_memory_bytes      max_memory_allocated over the timed repeats
  device_ms_per_step     summed device time of the profiled repeat's kernels
  device_busy_share      device_ms_per_step / ms_per_step
  flash_ms_per_step      the flash kernels' share of device_ms_per_step
  launches_per_step      device kernels (and copies) per step
  traced_ms_per_step     wall ms per step of the profiled repeat
  top_kernels            the ten device kernels of most total time
  idle_gaps              the five longest gaps between device work in the
                         profiled repeat, each named after the innermost span
                         open in the middle of it: this file's spans around
                         calls into the layers (unet, text_encode, vae_decode,
                         clip, loss, predictions_step, optimizer, and the
                         entry point around the repeat) or `backward` for
                         the autograd engine's backward functions

With no CUDA device it exits non-zero and prints no result. A cell whose
check fails prints `"ok": false` with the error; the script then exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
import traceback
from typing import Any, Callable, Sequence

from chip_smoke import ENSEMBLE, PER_STEP, PER_VAE_CALL, PROMPT

GUIDED_STEPS = 30
TXT2IMG_STEPS = 20
CFG_SCALE = 7.0
SAMPLE_STEPS = 50
MONSTER_BATCH = 16
MONSTER_EVALUATIONS = 100
OPTIMIZE_STEPS = 100
ADAM_LR = 0.05
DIP_ADAM_LR = 0.01
ENSEMBLE_RHO = 3.0
N_CUTOUTS = 32
CUT_SIZE = 224
CUT_POW = 0.5
GUIDANCE_SCALE = 0.5
CLAMP_VALUE = 1e-2
DEFAULT_REPEATS = 5
TOP_KERNELS = 10
IDLE_GAPS = 5
# bench_families.py's in-memory BERT vocabulary (no vocabulary file is in
# the tree); the prompt "a" is one of its words
LDM_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
BACKWARD = "autograd::engine::evaluate_function"


class Spans:
    """Named spans around calls into the layers, open only while `on`
    (the profiled repeat); off, a wrapped call costs one Python call."""

    def __init__(self):
        self.on = False
        self.names = set()

    def wrap(self, fn: Callable, name: str) -> Callable:
        from perceptor_tpu_torch.utils.profiling import annotate

        self.names.add(name)

        def spanned(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned

    def shadow(self, obj, attribute: str, name: str):
        """Wrap `obj.attribute` in place (an instance attribute); returns
        `obj`."""
        setattr(obj, attribute, self.wrap(getattr(obj, attribute), name))
        return obj


@dataclasses.dataclass
class Cell:
    """One benchmark cell. `run()` is one repeat of `n_steps` steps and
    returns tensors, the first of shape `out_shape`; `path` is its row of
    chip_smoke.PER_STEP, counted per call of `counted` (per step when None),
    plus PER_VAE_CALL for each of `decodes` decodes a repeat."""

    metric: str
    n_steps: int
    run: Callable[[], Sequence[Any]]
    out_shape: tuple
    path: str
    entry: str
    spans: Spans
    counted: Any = None
    decodes: int = 0

    def check(self, outputs) -> None:
        import torch

        first = outputs[0]
        if tuple(first.shape) != tuple(self.out_shape):
            raise AssertionError(f"output shape {tuple(first.shape)}, want {self.out_shape}")
        for out in outputs:
            if not bool(torch.isfinite(out).all()):
                raise AssertionError("non-finite output")

    def expected_launches(self, calls: int) -> dict:
        return {k: PER_STEP[self.path][k] * calls + PER_VAE_CALL[k] * self.decodes
                for k in PER_STEP[self.path]}


def _generator(device, seed):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def _random_encodings(loss, device, seed):
    """bench_families.py's prompt-bank target: a fixed random direction of
    the tower's width (the compute of a text target)."""
    import torch

    dim = loss.model.config.embed_dim
    return loss.add_encodings_(torch.randn((1, dim), generator=_generator(device, seed),
                                           device=device))


def _clip_loss(spans, seed, tiny, device):
    from perceptor_tpu_torch import losses
    from perceptor_tpu_torch.guided_step import TINY_CLIP

    options = {"config": TINY_CLIP, "precision": "fp32"} if tiny else {}
    loss = _random_encodings(losses.CLIP("ViT-B-32", device=device, **options), device, seed + 1)
    return spans.wrap(loss, "clip")


def _adam(spans, lr=ADAM_LR):
    """run_on_device's optimizer factory: Adam, lr 0.05 unless given
    (optax.adam(lr))."""
    import torch

    return lambda params: spans.shadow(torch.optim.Adam(params, lr=lr), "step", "optimizer")


class _ByteTokenizer:
    """A tokenizer whose ids fit the tiny SD text tower's 128 entries."""

    sot_token, eot_token = 126, 127

    def encode(self, text):
        return [ord(c) % 126 for c in text]


def bench_guided_step(seed=0, tiny=False, device="cuda") -> Cell:
    """bench.py:139-169: the CLIP-guided SD denoise step at 512px, 30 steps
    from the same seeded latents each repeat."""
    from perceptor_tpu_torch import guided_step

    spans = Spans()
    step = guided_step.build("tiny" if tiny else "sd-v1-512", device=device, seed=seed)
    spans.shadow(step.unet, "forward", "unet")
    spans.shadow(step.vae, "decode", "vae_decode")
    step.clip_loss = spans.wrap(step.clip_loss, "clip")
    spans.shadow(step, "step_with_gradient", "predictions_step")
    latents0, context = step.initial_inputs()
    n_steps = 1 if tiny else GUIDED_STEPS

    def run():
        import torch

        latents, losses = latents0, []
        for _ in range(n_steps):
            latents, loss = step.guided_denoise_step(latents, context)
            losses.append(loss)
        return latents, torch.stack(losses)

    return Cell("CLIP-guided SD-1.x denoise step, 512px, CLIP ViT-B/32", n_steps, run,
                tuple(latents0.shape), "guided_step", "guided_denoise_step", spans)


def bench_txt2img(seed=0, tiny=False, device="cuda") -> Cell:
    """StableDiffusion text to image: one prompt, CFG 7 as one batch-2 UNet
    call, a 20-step DDIM, the decode."""
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    spans = Spans()
    if tiny:
        sd = StableDiffusion("tiny", fp16=False, tokenizer=_ByteTokenizer(), device=device,
                             seed=seed)
    else:
        sd = StableDiffusion("runwayml/stable-diffusion-v1-5", device=device, seed=seed)
    spans.shadow(sd, "conditioning", "text_encode")
    spans.shadow(sd.unet, "forward", "unet")
    spans.shadow(sd, "decode", "vae_decode")
    size = 16 if tiny else 512
    n_steps = 1 if tiny else TXT2IMG_STEPS

    def run():
        return (sd.sample([PROMPT], n_steps=n_steps, guidance_scale=CFG_SCALE, size=(size, size),
                          generator=_generator(device, seed)),)

    return Cell("StableDiffusion v1-5 text to image, 512px, CFG 7, 20-step DDIM", n_steps, run,
                (1, 3, size, size), "sample", "sample", spans, counted=sd.unet, decodes=1)


def bench_adm(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_adm: ADM "standard" 512px, a 50-step sample."""
    from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion

    spans = Spans()
    model = GuidedDiffusion("tiny" if tiny else "standard", fp16=not tiny, device=device,
                            seed=seed)
    spans.shadow(model.module, "forward", "unet")
    n_steps = 1 if tiny else SAMPLE_STEPS

    def run():
        return (model.sample(n_images=1, n_steps=n_steps, generator=_generator(device, seed)),)

    return Cell("ADM standard 512px 50-step DDIM sample", n_steps, run, (1, *model.shape),
                "adm_sample", "sample", spans, counted=model.module)


def bench_velocity(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_velocity: yfcc_2 512px, a 50-step DDIM sample."""
    from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion

    spans = Spans()
    model = VelocityDiffusion("tiny" if tiny else "yfcc_2", fp16=not tiny, device=device,
                              seed=seed)
    spans.shadow(model.module, "forward", "unet")
    n_steps = 1 if tiny else SAMPLE_STEPS

    def run():
        return (model.sample(n_images=1, n_steps=n_steps, generator=_generator(device, seed)),)

    return Cell("v-diffusion yfcc_2 512px 50-step DDIM sample", n_steps, run, (1, *model.shape),
                "velocity_yfcc2_sample", "sample", spans, counted=model.module)


def bench_ldm(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_ldm: LDM Text2Image at 256px, 50 steps with its
    built-in CFG (one batch-2 UNet call a step), the in-memory vocabulary."""
    from perceptor_tpu_torch.models.latent_diffusion import BERTTokenizer, Text2Image, bert

    spans = Spans()
    max_length = (bert.TINY_BERT if tiny else bert.BERTConfig()).max_seq_len
    model = Text2Image(fp16=not tiny, tiny=tiny, device=device, seed=seed,
                       tokenizer=BERTTokenizer(vocab=LDM_VOCAB, max_length=max_length))
    spans.shadow(model, "conditioning", "text_encode")
    spans.shadow(model.unet, "forward", "unet")
    spans.shadow(model, "images", "vae_decode")
    size = 16 if tiny else 256
    n_steps = 2 if tiny else SAMPLE_STEPS  # a 1-step schedule has no pair

    def run():
        return (model.sample(["a"], n_steps=n_steps, size=(size, size),
                             generator=_generator(device, seed)),)

    return Cell("LDM text2image 256px 50-step DDIM sample (built-in CFG)", n_steps, run,
                (1, 3, size, size), "ldm_text2image", "sample", spans, counted=model.unet,
                decodes=1)


def bench_monster(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_monster: MonsterDiffusion "all", 16 sprites at
    48px, the elucidated sampler over 100 evaluations."""
    from perceptor_tpu_torch.models.monster_diffusion import MonsterDiffusion

    spans = Spans()
    model = MonsterDiffusion("tiny" if tiny else "all", fp16=not tiny, device=device, seed=seed)
    spans.shadow(model.module, "forward", "unet")
    batch = 2 if tiny else MONSTER_BATCH
    n_steps = 4 if tiny else MONSTER_EVALUATIONS  # two sigma pairs

    def run():
        return (model.sample(batch, n_evaluations=n_steps, generator=_generator(device, seed)),)

    return Cell("MonsterDiffusion 48px elucidated sample, batch 16, 100 evaluations", n_steps,
                run, (batch, *model.shape), "monster_sample", "sample", spans,
                counted=model.module)


def bench_raw(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_raw: a 256px Raw drawer under CLIP ViT-B/32 with
    a random target, Adam 0.05, 100 steps through `engine.run_on_device`."""
    from perceptor_tpu_torch import drawers, engine

    spans = Spans()
    size = 16 if tiny else 256
    drawer = drawers.Raw.random_fractal_image((1, 3, size, size), seed=seed, device=device)
    objective = _clip_loss(spans, seed, tiny, device)
    optimizer = _adam(spans)
    n_steps = 1 if tiny else OPTIMIZE_STEPS

    def run():
        return engine.run_on_device(drawer, [objective], drawer.params, n_steps,
                                    optimizer=optimizer)

    return Cell("Raw 256px + CLIP ViT-B/32 guided optimization", n_steps, run,
                (1, 3, size, size), "optimize", "run_on_device", spans)


def bench_velocity_guided(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_velocity_guided: `engine.guided_sample` over
    yfcc_2 at 256px under CLIP ViT-B/32 with a random target, guidance 0.5,
    clamp 1e-2, 50 steps."""
    from perceptor_tpu_torch import engine
    from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion

    spans = Spans()
    model = VelocityDiffusion("tiny" if tiny else "yfcc_2", fp16=not tiny, device=device,
                              seed=seed)
    spans.shadow(model.module, "forward", "unet")
    objective = _clip_loss(spans, seed, tiny, device)
    size = 16 if tiny else 256
    n_steps = 1 if tiny else SAMPLE_STEPS
    diffused = model.random_diffused((1, 3, size, size), _generator(device, seed))
    pairs = model.schedule_ts(n_steps)

    def run():
        return engine.guided_sample(model, [objective], diffused, pairs,
                                    guidance_scale=GUIDANCE_SCALE, clamp_value=CLAMP_VALUE)

    return Cell("v-diffusion yfcc_2 + CLIP guidance, 256px, 50 steps", n_steps, run,
                (1, 3, size, size), "velocity_yfcc2_guided_sample", "guided_sample", spans)


def bench_cutouts(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_cutouts at 32 cutouts: a 512px Raw drawer, 32
    random 224px cutouts a step (cut_pow 0.5) under CLIP ViT-B/32 with a
    random target, Adam 0.05, 100 steps through `engine.run_on_device`."""
    from perceptor_tpu_torch import drawers, engine
    from perceptor_tpu_torch.transforms import random_cutouts

    spans = Spans()
    size, cut = (32, 16) if tiny else (512, CUT_SIZE)
    drawer = drawers.Raw.random_fractal_image((1, 3, size, size), seed=seed, device=device)
    clip = _clip_loss(spans, seed, tiny, device)
    optimizer = _adam(spans)
    n_steps = 1 if tiny else OPTIMIZE_STEPS
    state = {}

    def cutout_loss(images):
        return clip(random_cutouts(images, state["generator"], N_CUTOUTS, cut_size=cut,
                                   cut_pow=CUT_POW))

    objective = spans.wrap(cutout_loss, "loss")

    def run():
        state["generator"] = _generator(device, seed)
        return engine.run_on_device(drawer, [objective], drawer.params, n_steps,
                                    optimizer=optimizer)

    return Cell("Raw 512px + 32 cutouts + CLIP ViT-B/32 guided optimization", n_steps, run,
                (1, 3, size, size), "optimize", "run_on_device", spans)


def bench_ensemble(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_ensemble: `engine.guided_sample` over ADM
    "pixelart" (fp16) at 256px under BLIP (384px), CLOOB and SLIP, each to a
    random target, loss weights 1, 1, 1, guidance 0.5, clamp 1e-2, the
    rho-3 schedule, 50 steps."""
    from perceptor_tpu_torch import engine, losses
    from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion

    spans = Spans()
    model = GuidedDiffusion("tiny" if tiny else "pixelart", fp16=not tiny, device=device,
                            seed=seed)
    spans.shadow(model.module, "forward", "unet")
    options = {"precision": "fp32"} if tiny else {}
    # chip_smoke's ENSEMBLE, bench_families.bench_ensemble's towers in its
    # order, each to its own random target (seeds 1, 2, 3 above --seed)
    ensemble = [
        spans.wrap(_random_encodings(
            getattr(losses, kind)("tiny" if tiny else name, device=device, seed=seed, **options),
            device, seed + k), "clip")
        for k, (kind, name) in enumerate(ENSEMBLE, start=1)
    ]
    size = model.shape[-1]
    n_steps = 2 if tiny else SAMPLE_STEPS
    diffused = model.random_diffused((1, 3, size, size), _generator(device, seed))
    pairs = model.schedule_indices(n_steps, rho=ENSEMBLE_RHO)

    def run():
        return engine.guided_sample(model, ensemble, diffused, pairs,
                                    guidance_scale=GUIDANCE_SCALE, loss_weights=[1.0, 1.0, 1.0],
                                    clamp_value=CLAMP_VALUE)

    return Cell("ADM pixelart + BLIP/CLOOB/SLIP ensemble guidance, 256px, 50 steps", n_steps, run,
                (1, 3, size, size), "ensemble_guided_sample", "guided_sample", spans)


def bench_dip(seed=0, tiny=False, device="cuda") -> Cell:
    """bench_families.bench_dip: a 256px DeepImagePrior drawer (192-channel
    skip levels, bf16 convs) under OpenCLIP ViT-B/32 (laion2b_s34b_b79k)
    with a random target, Adam 0.01, 100 steps through
    `engine.run_on_device`."""
    from perceptor_tpu_torch import drawers, engine, losses
    from perceptor_tpu_torch.guided_step import TINY_CLIP

    spans = Spans()
    size = 16 if tiny else 256
    drawer = drawers.DeepImagePrior((size, size), seed=seed, fp16=not tiny, device=device)
    spans.shadow(drawer, "synthesize", "drawer")
    options = {"config": TINY_CLIP, "precision": "fp32"} if tiny else {}
    loss = losses.OpenCLIP("ViT-B-32", "laion2b_s34b_b79k", device=device, seed=seed, **options)
    objective = spans.wrap(_random_encodings(loss, device, seed + 1), "clip")
    optimizer = _adam(spans, DIP_ADAM_LR)
    n_steps = 1 if tiny else OPTIMIZE_STEPS

    def run():
        final, history = engine.run_on_device(drawer, [objective], drawer.params, n_steps,
                                              optimizer=optimizer)
        return (final[-1], history, *final[:-1])  # the residual images first

    return Cell("DeepImagePrior 256px + OpenCLIP ViT-B/32 guided optimization", n_steps, run,
                (1, 3, size, size), "dip_optimize", "run_on_device", spans)


CELLS = {
    "sd512_guided_step": bench_guided_step,
    "sd512_txt2img_cfg7_ddim20": bench_txt2img,
    "adm512_sample50": bench_adm,
    "velocity_yfcc2_512_sample50": bench_velocity,
    "ldm_txt2img_256_sample50": bench_ldm,
    "monster48_b16_eval100": bench_monster,
    "raw256_clip_opt100": bench_raw,
    "velocity_yfcc2_256_guided50": bench_velocity_guided,
    "raw512_cutouts32_opt100": bench_cutouts,
    "adm256_pixelart_ensemble_guided50": bench_ensemble,
    "dip256_openclip_opt100": bench_dip,
}


def count_calls(module):
    """A list that grows by one at each call of `module` and the hook's
    handle (remove it when done)."""
    calls = []
    return calls, module.register_forward_pre_hook(lambda *_: calls.append(1))


def checked_run(cell: Cell, fa) -> dict:
    """One repeat with its flash launches counted: the outputs checked,
    the launches held to the cell's PER_STEP row."""
    fa.reset_launches()
    calls, handle = count_calls(cell.counted) if cell.counted is not None else (None, None)
    try:
        outputs = cell.run()
    finally:
        if handle is not None:
            handle.remove()
    cell.check(outputs)
    n = len(calls) if calls is not None else cell.n_steps
    launches = dict(fa.LAUNCHES)
    want = cell.expected_launches(n)
    if launches != want:
        raise AssertionError(f"flash launches {launches}, want {want} ({n} calls of the path)")
    return {"launches": launches, "path": cell.path, "path_calls": n}


def quartiles(values):
    import numpy as np

    q1, median, q3 = np.percentile(values, [25, 50, 75])
    return float(median), float(q1), float(q3)


def layer_metrics(kernels, spans, entry: str, n_steps: int) -> dict:
    """Per-layer metrics of a profiled repeat from its device work `kernels`
    and host `spans`, each (start_us, end_us, name); the repeat is the span
    named `entry`. Device time sums the kernels' durations; an idle gap is
    an interval of the repeat with no kernel running, named after the span
    open at its middle that opened last (the innermost)."""
    start, end = next((a, b) for a, b, name in spans if name == entry)
    by_name, device_us, flash_us, gaps, busy_to = {}, 0.0, 0.0, [], start
    for a, b, name in sorted(kernels):
        device_us += b - a
        if "flash::" in name or "flash_" in name:
            flash_us += b - a
        total = by_name.setdefault(name, [0.0, 0])
        total[0] += b - a
        total[1] += 1
        if a > busy_to:
            gaps.append((busy_to, a))
        busy_to = max(busy_to, b)
    if end > busy_to:
        gaps.append((busy_to, end))

    def innermost(a, b):
        mid = (a + b) / 2
        open_spans = [s for s in spans if s[0] <= mid <= s[1]]
        return max(open_spans)[2] if open_spans else None

    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:IDLE_GAPS]
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:TOP_KERNELS]
    n = n_steps
    return {
        "device_ms_per_step": device_us / 1e3 / n,
        "flash_ms_per_step": flash_us / 1e3 / n,
        "launches_per_step": len(kernels) / n,
        "top_kernels": [{"name": name[:90], "ms_per_step": us / 1e3 / n, "count": count}
                        for name, (us, count) in top],
        "idle_gaps": [{"ms": (b - a) / 1e3, "at_ms": (a - start) / 1e3, "span": innermost(a, b)}
                      for a, b in longest],
    }


def profiled(cell: Cell) -> dict:
    """One repeat under torch.profiler with the spans on: `layer_metrics`
    of its events (read from the profiler's raw results: building its
    event tree costs minutes for a repeat of 240,000 kernels) and its wall
    ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perceptor_tpu_torch.utils.profiling import annotate

    cell.spans.on = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with annotate(cell.entry):
                cell.run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cell.spans.on = False
    names = cell.spans.names | {cell.entry}
    kernels, spans = [], []
    for event in prof.profiler.kineto_results.events():
        name = event.name()
        interval = (event.start_ns() / 1e3, event.end_ns() / 1e3)
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            # the device timeline also carries each span, as a user annotation
            if not (getattr(event, "is_user_annotation", lambda: False)() or name in names):
                kernels.append((*interval, name))
        elif name.startswith(BACKWARD):
            spans.append((*interval, "backward"))
        elif name in names:
            spans.append((*interval, name))
    return {"traced_ms_per_step": wall_ms / cell.n_steps,
            **layer_metrics(kernels, spans, cell.entry, cell.n_steps)}


def bench_cell(name: str, seed: int, repeats: int, fa) -> dict:
    import torch

    from perceptor_tpu_torch.utils.flops import card_peaks, count_model_flops, mfu

    t0 = time.perf_counter()
    cell = CELLS[name](seed=seed)
    check = checked_run(cell, fa)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    median, q1, q3 = quartiles(seconds)
    ms = median * 1e3 / cell.n_steps
    t0 = time.perf_counter()
    layers = profiled(cell)
    profile_s = time.perf_counter() - t0
    flops = count_model_flops(cell.run) / cell.n_steps
    torch.cuda.empty_cache()
    count_s = time.perf_counter() - t0 - profile_s
    peak_flops, _ = card_peaks(torch.cuda.get_device_name(0))
    return {
        "cell": name, "ok": True, "metric": cell.metric, "value": ms, "unit": "ms/step",
        "compile_s": compile_s, "steady_s": median, "n_steps": cell.n_steps,
        "repeats": repeats,
        "ms_per_step": {"median": ms, "q1": q1 * 1e3 / cell.n_steps,
                        "q3": q3 * 1e3 / cell.n_steps,
                        "repeats": [s * 1e3 / cell.n_steps for s in seconds]},
        "mfu": mfu(flops, ms / 1e3, peak_flops), "model_flops_per_step": flops,
        "peak_memory_bytes": peak,
        "device_busy_share": layers["device_ms_per_step"] / ms, **layers,
        "flash_launches_per_step": {k: v / cell.n_steps for k, v in check["launches"].items()},
        "check": check,
        "seconds": {"build_and_warmup": compile_s, "repeats": sum(seconds),
                    "profile": profile_s, "flop_count": count_s},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cell", action="append", choices=sorted(CELLS))
    parser.add_argument("--repeats", type=int, default=DEFAULT_REPEATS)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_cuda: CUDA is not available; the benchmark runs on a GPU only",
              file=sys.stderr)
        return 1
    from perceptor_tpu_torch.core.init import resolve_device
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa
    from perceptor_tpu_torch.utils.bench_env import bench_env, build_kernels

    resolve_device("cuda")
    build = build_kernels()
    failed = 0
    for name in args.cell or list(CELLS):
        try:
            line = bench_cell(name, args.seed, args.repeats, fa)
        except Exception as error:  # a failed cell is reported and the run goes on
            traceback.print_exc()
            failed += 1
            line = {"cell": name, "ok": False, "error": f"{type(error).__name__}: {error}"}
        line["env"] = bench_env(build)  # the conditions the cell ran under
        print(json.dumps(line), flush=True)
        # the spans' wrappers make reference cycles through each model: free
        # the cell's models before the next cell's peak is read
        gc.collect()
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
