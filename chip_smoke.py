#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (perceptor_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the flash-attention kernels from csrc/ with nvcc, then runs these
phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result line:

1. kernels        each CUDA kernel against its plain PyTorch version (fp32
                  arithmetic on the same bf16 inputs) at the three attention
                  shapes of the 512px guided step and at the 512px ADM
                  UNet's site (1, 8, 1024, 64), head-interleaved as its
                  AttentionBlock passes q, k and v, two dq and two dk/dv
                  launches held bitwise equal at each; at the CFG sampling
                  step's batch-2 sites (S = 4096 and 1024), strided as the
                  UNet passes them; and off the main path: fp32 inputs,
                  strided batch-2 bf16 inputs (S = 1024 and 768px's 2304),
                  d = 512 at S = 1024, and K/V of a single tile; then each
                  kernel's registers, spills, shared memory and resident
                  blocks per SM;
2. guided_step    the full-width guided step (SD-1.x UNet + VAE at 512px,
                  CLIP ViT-B/32, batch 1, random weights from seed 0) for 5
                  steps: finite latents and loss, exactly 11 launches of each
                  kernel per step, steady ms per step and peak memory (from
                  an emptied allocator cache);
3. profile        one guided step under torch.profiler: device time by
                  kernel and the device's busy share, against the profiled
                  step and against the same step timed unprofiled;
4. route_parity   the UNet forward and its latent gradient, a batch-2 CFG
                  UNet evaluation, and the VAE decode, through the kernels
                  against the plain attention route (and both against an
                  fp32 copy), same weights and inputs, bf16;
5. sample         `StableDiffusion(MODEL).sample` at 512px, batch 1, CFG 7:
                  a 20-step DDIM, a 10-step DPM-Solver++(2M) and an
                  img2img/RePaint run from the first image; launches
                  asserted (10 per batched UNet evaluation, one per VAE
                  decode or encode), finite images, seconds per image, ms
                  per sampling step, text-encode and decode ms, peak memory;
6. sample_profile one CFG sampling step under torch.profiler;
7. guided_sample  `engine.guided_sample` with CFG for 2 steps, the guided
                  step's CLIP loss (a fixed random target): 21 launches of
                  each kernel a step, finite latents and losses, ms per step
                  and peak memory;
8. text_tower     `models.CLIP("ViT-B-32")` (both towers, bf16): two prompts
                  through the port's vocabulary and the text tower, unit
                  norm, finite, within 5e-2 relative L2 of an fp32 copy of
                  the same weights; text-encode ms;
9. optimize_raw   `engine.optimize` of a 256px `Raw` fractal image under
                  `losses.CLIP("ViT-B-32")` with a text prompt plus
                  `losses.Smoothness()`, Adam 0.05, 30 steps: the loss falls,
                  finite pixels, no flash launch (50 image tokens, masked
                  text); ms per step, peak memory, one step under the
                  profiler; then the same steps through `run_on_device`,
                  whose history must equal `optimize`'s within 1e-6;
10. optimize_cutouts  a 512px `Raw` under the same CLIP loss over
                  `random_cutouts` (n = 8, 32, 64 cutouts of 224px, cut_pow
                  0.5, a seeded CUDA generator), 10 steps each;
11. optimize_jpeg `drawers.JPEG` from the 256px fractal image, 10 steps; its
                  decode on the card against the CPU's (1e-4) and the round
                  trip's mean error;
12. guided_sample_text  `engine.guided_sample` with CFG 7, guidance 0.5, the
                  text-prompted `losses.CLIP` over 16 random cutouts a step,
                  4 steps at 512px: 21 launches of each kernel a step, finite
                  latents and losses, ms per step and peak memory;
13. adm_sample    `GuidedDiffusion("standard").sample` at 512px, batch 1,
                  full depth: a 10-step DDIM, a 5-step DPM-Solver++(2M) and an
                  img2img run (from index 600, eta 0.5) from the first
                  image: exactly 5 forward launches a UNet evaluation and no
                  backward launch, finite images, seconds per image, ms per
                  step, peak memory, parameters; one UNet evaluation under
                  torch.profiler;
14. adm_guided_sample  `engine.guided_sample` on that model under the
                  text-prompted `losses.CLIP` over 16 random cutouts a step
                  (no generator passed: the augment gets the default one), 3
                  steps from the first image diffused to index 600: 5 / 5 / 5
                  launches a step, finite images and losses, ms per step,
                  peak memory;
15. adm_route_parity  the ADM UNet forward at 512px and its input gradient
                  through the kernels against the plain attention route and
                  an fp32 copy, with route_parity's tolerances;
16. velocity_sample  `VelocityDiffusion("cc12m_1_cfg")` at 256px, full width
                  and depth, conditioned on the prompt through
                  `models.CLIP("ViT-B-16")`: 10-step DDIM with correction,
                  10-step "plms", 5-step "dpm++", a `reverse_sample` of the
                  DDIM image, and a 3-step `guided_sample` under the text loss
                  over float (from_t, to_t) pairs: no flash launch (its
                  attention sites have at most 256 tokens), finite outputs,
                  seconds per image, ms per UNet evaluation, peak memory; one
                  UNet evaluation under torch.profiler;
17. timings       each kernel, its plain version and PyTorch's
                  scaled_dot_product_attention at each site (and the
                  forward at the batch-2 sites), beside the card's bound;
                  launches queue up behind a spin on the device, so a small
                  kernel is timed at the device's pace, not the host's.

Each phase measures its launches per step and holds them against the one
table PER_STEP. Then the kernel table as one JSON line (launches of every
main-path run and measured launches per step, by entry point) and, last,
the device line. Exits non-zero with no result when
CUDA is not available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

STEPS = 5
# (site, batch, heads, seq, head_dim, launches per guided step)
SITES = (
    ("unet_level0_attn1", 1, 8, 4096, 40, 5),
    ("unet_level1_attn1", 1, 8, 1024, 80, 5),
    ("vae_mid_attn", 1, 1, 4096, 512, 1),
)
# the forward's sites in a CFG sampling step: the uncond/cond pair batched,
# (site, batch, heads, seq, head_dim, launches per sampling step)
CFG_SITES = (
    ("unet_level0_attn1_cfg", 2, 8, 4096, 40, 5),
    ("unet_level1_attn1_cfg", 2, 8, 1024, 80, 5),
)
# the 512px ADM "standard" UNet's flash site: its five attention blocks at
# downsampling 16 (32 x 32 tokens, 8 heads of 64 channels), q, k and v
# head-interleaved views of one qkv projection;
# (site, batch, heads, seq, head_dim, launches per UNet evaluation)
ADM_SITES = (("adm_ds16_attn", 1, 8, 1024, 64, 5),)
# The one table of expected launches: each kernel's launches per step of
# each path, by entry point. The guided step is one UNet evaluation (5
# self-attentions at level 0, S = 4096, and 5 at level 1, S = 1024) and the
# VAE decode, forward and backward; `sample` is counted per batched CFG UNet
# evaluation, forward only; `guided_sample` with CFG is two UNet
# evaluations and the VAE decode, forward and backward. Each phase measures
# its counts and holds them against this table.
PER_STEP = {
    "guided_step": {"flash_fwd": 11, "flash_dq": 11, "flash_dkv": 11},
    "sample": {"flash_fwd": 10, "flash_dq": 0, "flash_dkv": 0},
    "guided_sample": {"flash_fwd": 21, "flash_dq": 21, "flash_dkv": 21},
    "guided_sample_text": {"flash_fwd": 21, "flash_dq": 21, "flash_dkv": 21},
    # drawer -> CLIP ViT-B/32: 50 image tokens and a masked text tower
    "optimize": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # ADM at 512px: per UNet evaluation (sample), and per guided step, which
    # is one evaluation forward and backward (CLIP ViT-B/32 launches none)
    "adm_sample": {"flash_fwd": 5, "flash_dq": 0, "flash_dkv": 0},
    "adm_guided_sample": {"flash_fwd": 5, "flash_dq": 5, "flash_dkv": 5},
    # cc12m_1_cfg at 256px: attention at 16 x 16 tokens and below
    "velocity_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "velocity_guided_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
}
# launches of one no-grad VAE decode or encode (the mid-block attention)
PER_VAE_CALL = {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0}
# the B = 1 sites' launches per CFG-guided step: the UNet's sites twice
CFG_GUIDED_SITE_LAUNCHES = {
    site: n * (2 if site.startswith("unet") else 1) for site, *_, n in SITES
}
MODEL = "runwayml/stable-diffusion-v1-5"
IMAGE_SIZE = 512
PROMPT = "a photograph of an astronaut riding a horse on the moon"
CFG_SCALE = 7.0
# text-to-image runs of `StableDiffusion.sample` at 512px, batch 1, in this
# order; img2img starts from the first run's image
SAMPLE_RUNS = (
    ("ddim", {"n_steps": 20}),
    ("dpm++", {"n_steps": 10, "method": "dpm++"}),
    ("img2img", {"n_steps": 5, "from_index": 600, "eta": 0.5, "n_resample": 1}),
)
GUIDED_SAMPLE_STEPS = 2
# the pixel-space families: ADM "standard" at 512px and the CLIP-conditioned
# v-diffusion model at 256px, full width and depth, batch 1
ADM_MODEL = "standard"
ADM_SAMPLE_RUNS = (
    ("ddim", {"n_steps": 10}),
    ("dpm++", {"n_steps": 5, "method": "dpm++"}),
    ("img2img", {"n_steps": 5, "from_index": 600, "eta": 0.5}),
)
ADM_GUIDED_STEPS = 3
ADM_GUIDED_FROM_INDEX = 600
ADM_GUIDED_CUTOUTS = 16
VELOCITY_MODEL = "cc12m_1_cfg"
VELOCITY_SAMPLE_RUNS = (
    ("ddim_correction", {"n_steps": 10, "correction": True}),
    ("plms", {"n_steps": 10, "method": "plms"}),
    ("dpm++", {"n_steps": 5, "method": "dpm++"}),
)
VELOCITY_REVERSE_STEPS = 10
VELOCITY_GUIDED_STEPS = 3
# the text-prompted optimization phases (CLIP ViT-B/32, openai config)
CLIP_NAME = "ViT-B-32"
TEXT_PROMPTS = (PROMPT, "an oil painting of a lighthouse at dusk")
RAW_SIZE = 256
RAW_STEPS = 30
CUTOUT_IMAGE_SIZE = 512
CUTOUT_COUNTS = (8, 32, 64)
CUT_SIZE = 224
CUT_POW = 0.5
CUTOUT_STEPS = 10
# every step draws new cutouts, so the history is noisy from step to step:
# the loss must fall under one fixed draw of this many boxes, before to after
CUTOUT_EVAL_COUNT = 64
JPEG_STEPS = 10
GUIDED_TEXT_STEPS = 4
GUIDED_TEXT_CUTOUTS = 16
# bf16 towers against an fp32 copy of the same weights, relative L2
TEXT_BF16_RTOL = 5e-2
# `optimize` and `run_on_device` do the same arithmetic in the same order
RUN_ON_DEVICE_ATOL = 1e-6
# the JPEG decode on the card against the CPU's, same coefficients, fp32
JPEG_DECODE_ATOL = 1e-4
# the codec is lossy (2x chroma subsampling, quantization at factor 1): the
# round trip of the fractal image is held to a mean absolute error only
JPEG_ROUND_TRIP_MEAN = 0.1
# bf16 kernels vs fp32 arithmetic: bf16 keeps 8 mantissa bits, so rounding
# the output alone costs ~2e-3 of its magnitude, and P / dS are rounded to
# bf16 before their products; 2e-2 of the reference's largest magnitude
# leaves a 10x margin while a wrong tile, index or scale errs by O(1) of it.
KERNEL_RTOL = 2e-2
LSE_ATOL = 1e-3
# Off the main path: fp32 inputs (the kernels' scalar path: the plain
# version's fp32 arithmetic up to summation order, so 1e-4; d = 64 too) and
# bf16 inputs (KERNEL_RTOL), all viewed from (B, S, H * D) projections as the
# SD UNet passes them: batch 2 at S = 1024 (d = 40, 80 and ADM's 64) and at
# 768px's S = 2304, the VAE's d = 512 at S = 1024, and Sk of a single K/V
# tile of the three bf16 kernels (64 keys at d = 40, 32 at d = 512).
# (dtype, batch, heads, seq_q, seq_k, head_dim)
FP32_RTOL = 1e-4
EXTRA_CASES = (
    ("float32", 1, 2, 256, 256, 40), ("float32", 1, 2, 256, 256, 80),
    ("float32", 1, 1, 256, 256, 512), ("float32", 1, 2, 256, 256, 64),
    ("bfloat16", 2, 2, 1024, 1024, 40), ("bfloat16", 2, 2, 1024, 1024, 80),
    ("bfloat16", 2, 2, 2304, 2304, 40), ("bfloat16", 2, 2, 2304, 2304, 80),
    ("bfloat16", 2, 2, 1024, 1024, 64),
    ("bfloat16", 1, 1, 1024, 1024, 512),
    ("bfloat16", 1, 2, 256, 64, 40), ("bfloat16", 1, 1, 128, 32, 512),
)
# kernel route vs plain route through the whole bf16 model, relative L2
# error. Both routes are bf16 approximations: the plain route rounds the
# scores to bf16 before its fp32 softmax (as the JAX dot-product path does),
# and with random weights the scores reach tens, where bf16's spacing is
# 0.125. So each route is also held against an fp32 copy of the model, and
# the kernel route must be no less accurate than the plain one (within
# ROUTE_MARGIN), besides the direct comparison below.
ROUTE_FWD_RTOL = 5e-2
ROUTE_GRAD_RTOL = 1e-1
ROUTE_MARGIN = 1.25
SOURCES = {
    "flash_fwd": "perceptor_tpu_torch/csrc/flash_mma.cu",
    "flash_dq": "perceptor_tpu_torch/csrc/flash_mma.cu",
    "flash_dkv": "perceptor_tpu_torch/csrc/flash_mma.cu",
}
REPLACES = {
    "flash_fwd": "perceptor_tpu/ops/flash_attention_kernel.py:45",
    "flash_dq": "perceptor_tpu/ops/flash_attention_kernel.py:126",
    "flash_dkv": "perceptor_tpu/ops/flash_attention_kernel.py:159",
}
FLOPS_PER_S2D = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_peaks(name: str):
    """(dense bf16 FLOP/s, memory bytes/s) from NVIDIA's data sheets."""
    upper = name.upper()
    if "H100" in upper and "PCIE" in upper:
        return 756e12, 2.0e12
    if "H100" in upper and "NVL" in upper:
        return 835e12, 3.9e12
    if "H200" in upper:
        return 989e12, 4.8e12
    return 989e12, 3.35e12  # H100 SXM


def site_work(kernel: str, b: int, h: int, s: int, d: int):
    """(FLOPs, bytes) the kernel must do and move at one site: each input
    read once, each output written once."""
    flops = FLOPS_PER_S2D[kernel] * b * h * s * s * d
    tensor = b * h * s * d * 2
    rows = b * h * s * 4
    if kernel == "flash_fwd":
        nbytes = 4 * tensor + rows  # q, k, v -> o, lse
    elif kernel == "flash_dq":
        nbytes = 5 * tensor + 2 * rows  # q, k, v, do, lse, delta -> dq
    else:
        nbytes = 6 * tensor + 2 * rows  # q, k, v, do, lse, delta -> dk, dv
    return flops, nbytes


_SPIN_CYCLES_PER_MS = None


def spin_cycles_per_ms() -> float:
    """Cycles of `torch.cuda._sleep` (a kernel that spins on the device) per
    millisecond, measured once."""
    global _SPIN_CYCLES_PER_MS
    import torch

    if _SPIN_CYCLES_PER_MS is None:
        cycles = 10_000_000
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS = cycles / start.elapsed_time(end)
    return _SPIN_CYCLES_PER_MS


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of `fn`, by CUDA events around `reps` calls. A
    wrapper call costs the host tens of microseconds, more than a small
    kernel runs, and events around calls enqueued at the host's pace would
    time the host. So the device first spins for twice the time the host
    needs to enqueue all the calls (its pace is taken from the warm-up, at
    most 200 ms of spin): the timed calls queue up behind the spin and run
    back to back."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_cycles_per_ms() * min(2.0 * reps * host_ms, 200.0)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def site_inputs(b, h, s, d, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(4)
    ]


def adm_site_inputs(b, h, s, d, seed):
    """q, k, v, do as the ADM `AttentionBlock` hands them over: q, k and v
    are views of one (B, S, H * 3 * D) qkv projection whose channels are
    [head0(q|k|v), head1(q|k|v), ...]; do is the gradient of the
    (B, S, H * D) merge, viewed (B, H, S, D)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, h * 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv.view(b, s, h, 3, d)[:, :, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, s, h * d), generator=gen, device="cuda").to(torch.bfloat16)
    return [q, k, v, do.view(b, s, h, d).transpose(1, 2)]


def phase_kernels(fa) -> dict:
    """Each kernel against its plain version at the main paths' shapes."""
    import torch

    errors = {name: 0.0 for name in REPLACES}
    sites = []
    site_list = [(site, site_inputs) for site in SITES]
    site_list += [(site, adm_site_inputs) for site in ADM_SITES]
    for i, ((site, b, h, s, d, _), make_inputs) in enumerate(site_list):
        q, k, v, do = make_inputs(b, h, s, d, seed=i)
        scale = 1.0 / math.sqrt(d)
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        o_ref, lse_ref = fa.flash_forward_plain(qf, kf, vf, scale)
        o, lse = fa.flash_forward(q, k, v, scale)
        # both backward versions take the same residuals: the plain forward's
        o_in = o_ref.to(torch.bfloat16)
        delta = (o_in.float() * dof).sum(-1)
        dq_ref = fa.flash_dq_plain(qf, kf, vf, dof, lse_ref, delta, scale)
        dk_ref, dv_ref = fa.flash_dkv_plain(qf, kf, vf, dof, lse_ref, delta, scale)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, scale)
        dq2 = fa.flash_dq(q, k, v, do, lse_ref, delta, scale)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, scale)
        dk2, dv2 = fa.flash_dkv(q, k, v, do, lse_ref, delta, scale)
        torch.cuda.synchronize()
        if not torch.equal(dq, dq2):
            raise AssertionError(f"flash_dq at {site}: two launches differ")
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash_dkv at {site}: two launches differ")
        checks = {
            "o": ("flash_fwd", o, o_ref), "dq": ("flash_dq", dq, dq_ref),
            "dk": ("flash_dkv", dk, dk_ref), "dv": ("flash_dkv", dv, dv_ref),
        }
        record = {"site": site, "shape": [b, h, s, d], "q_strides": list(q.stride())}
        for out_name, (kernel, got, ref) in checks.items():
            err = float((got.float() - ref).abs().max())
            tol = KERNEL_RTOL * float(ref.abs().max())
            if not err <= tol:
                raise AssertionError(f"{kernel} {out_name} at {site}: max |err| {err} > {tol}")
            errors[kernel] = max(errors[kernel], err)
            record[out_name] = {"max_abs_err": err, "tol": tol}
        lse_err = float((lse - lse_ref).abs().max())
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"flash_fwd lse at {site}: max |err| {lse_err} > {LSE_ATOL}")
        record["lse"] = {"max_abs_err": lse_err, "tol": LSE_ATOL}
        record["dq_bitwise_repeatable"] = True
        record["dkv_bitwise_repeatable"] = True
        sites.append(record)
    # the CFG sampling step's batch-2 sites, strided as the UNet passes them
    cfg_sites = []
    for i, (site, b, h, s, d, _) in enumerate(CFG_SITES):
        for record in check_strided(fa, ("bfloat16", b, h, s, s, d), seed=80 + i):
            kernel = OUT_KERNEL[record["out"]]
            errors[kernel] = max(errors[kernel], record["max_abs_err"])
            cfg_sites.append({"site": site, **record})
    extra = []
    for i, case in enumerate(EXTRA_CASES):
        extra.extend(check_strided(fa, case, seed=50 + i))
    emit({"phase": "kernels", "ok": True, "sites": sites, "cfg_sites": cfg_sites,
          "off_path": extra})
    return errors


OUT_KERNEL = {"o": "flash_fwd", "dq": "flash_dq", "dk": "flash_dkv", "dv": "flash_dkv"}


def check_strided(fa, case, seed) -> list:
    """All three kernels against their plain versions on (B, S, H * D)
    projections viewed as (B, H, S, D), the UNet's strided layout; raises on
    an error above the tolerance."""
    import torch

    dtype, b, h, sq, sk, d = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        torch.randn((b, s, h * d), generator=gen, device="cuda")
        .to(getattr(torch, dtype)).view(b, s, h, d).transpose(1, 2)
        for s in (sq, sk, sk, sq)
    )
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = fa.flash_forward_plain(qf, kf, vf, scale)
    delta = (o_ref.to(q.dtype).float() * dof).sum(-1)
    refs = [o_ref, fa.flash_dq_plain(qf, kf, vf, dof, lse_ref, delta, scale),
            *fa.flash_dkv_plain(qf, kf, vf, dof, lse_ref, delta, scale)]
    outs = [fa.flash_forward(q, k, v, scale)[0], fa.flash_dq(q, k, v, do, lse_ref, delta, scale),
            *fa.flash_dkv(q, k, v, do, lse_ref, delta, scale)]
    torch.cuda.synchronize()
    rtol = FP32_RTOL if dtype == "float32" else KERNEL_RTOL
    records = []
    for out_name, got, ref in zip(("o", "dq", "dk", "dv"), outs, refs):
        err, tol = float((got.float() - ref).abs().max()), rtol * float(ref.abs().max())
        if not err <= tol:
            raise AssertionError(f"{out_name} at {list(case)}: max |err| {err} > {tol}")
        records.append({"case": list(case), "out": out_name, "max_abs_err": err, "tol": tol})
    return records


def phase_kernel_info(fa, library) -> None:
    """Per kernel at each site's head_dim: registers, local bytes, dynamic
    shared bytes, threads and resident blocks per SM from the CUDA runtime,
    and ptxas's spill report from the build."""
    import re

    import torch

    info = [
        {"kernel": name, "site": site, "head_dim": d,
         **fa.kernel_info(name.removeprefix("flash_"), d, torch.bfloat16)}
        for site, _, _, _, d, _ in SITES + ADM_SITES for name in REPLACES
    ]
    ptxas = []
    report = library.with_suffix(".ptxas.txt")
    for mangled, body in re.findall(
        r"Function properties for (\S+)\n(.*?)(?=Compile time|\Z)", report.read_text(), re.S
    ):
        kernel = re.search(r"((?:flash_)?(?:fwd|dq|dkv)_kernel)I", mangled)
        numbers = lambda pattern: [int(x) for x in re.findall(pattern, body)]
        ptxas.append({
            "kernel": kernel.group(1) if kernel else mangled,
            "bf16": "bfloat16" in mangled,
            "template": [int(x) for x in re.findall(r"Li(\d+)E", mangled)],
            "registers": numbers(r"Used (\d+) registers"),
            "spill_stores": numbers(r"(\d+) bytes spill stores"),
            "spill_loads": numbers(r"(\d+) bytes spill loads"),
        })
    emit({"phase": "kernel_info", "ok": True, "runtime": info, "ptxas": ptxas})


def per_step(launches: dict, steps: int) -> dict:
    """Measured launches of each kernel per step."""
    return {name: n / steps for name, n in launches.items()}


def check_per_step(path: str, measured: dict) -> None:
    if measured != PER_STEP[path]:
        raise AssertionError(f"{path}: kernel launches per step {measured}, want {PER_STEP[path]}")


def phase_guided_step(fa, step):
    """Five full-width guided steps through the kernels: (launches, launches
    per step)."""
    import torch

    latents, context = step.initial_inputs()
    step.guided_denoise_step(latents, context)  # warm-up: cuDNN/cuBLAS set-up
    torch.cuda.synchronize()
    # the peak is the step's own: no blocks cached by earlier phases
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    losses = []
    for i in range(STEPS):
        latents, loss = step.guided_denoise_step(latents, context)
        events[i + 1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, STEPS)
    check_per_step("guided_step", measured)
    if not (torch.isfinite(latents).all() and all(torch.isfinite(x) for x in losses)):
        raise AssertionError("non-finite latents or loss")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(STEPS)]
    emit({
        "phase": "guided_step", "ok": True, "config": "sd-v1-512", "steps": STEPS,
        "latents_shape": list(latents.shape), "losses": [float(x) for x in losses],
        "step_ms": step_ms, "steady_ms_per_step": sorted(step_ms)[STEPS // 2],
        "wall_s": wall, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def _set_route(module, use_flash) -> None:
    for m in module.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = use_flash


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_route_parity(step) -> None:
    """Kernel route vs plain route at full width, same weights and inputs,
    both also against an fp32 copy of each model."""
    import torch

    latents, context = step.initial_inputs()
    gen = torch.Generator(device="cuda").manual_seed(7)
    probe = torch.randn(latents.shape, generator=gen, device="cuda")
    # a CFG evaluation: the latents twice, under two contexts (batch 2)
    context2 = step.initial_inputs(batch=2)[1]

    def unet_out_grad(unet, use_flash):
        _set_route(unet, use_flash)
        x = latents.detach().requires_grad_(True)
        with torch.enable_grad():
            out = unet(x, step.from_idx.float(), context)
            (grad,) = torch.autograd.grad((out * probe).sum(), x)
        return out.detach(), grad

    def unet_cfg_out(unet, use_flash):
        _set_route(unet, use_flash)
        with torch.no_grad():
            return (unet(torch.cat([latents, latents]), step.from_idx.float().expand(2), context2),)

    def vae_decode(vae, use_flash):
        _set_route(vae, use_flash)
        with torch.no_grad():
            return (vae.decode(latents),)

    results = {}
    for name, bf16_model, run, outputs in (
        ("unet", step.unet, unet_out_grad, ("out", "latent_grad")),
        ("unet_cfg", step.unet, unet_cfg_out, ("out",)),
        ("vae_decode", step.vae, vae_decode, ("images",)),
    ):
        results.update(compare_routes(name, bf16_model, run, outputs))
    emit({"phase": "route_parity", "ok": True, "metric": "relative L2 error", **results})


def compare_routes(name, bf16_model, run, outputs) -> dict:
    """`run(model, use_flash)` through the kernels, through the plain
    attention route and on an fp32 copy of the model: per output, the
    relative L2 errors, held to ROUTE_FWD_RTOL (ROUTE_GRAD_RTOL for a
    gradient) between the routes and to ROUTE_MARGIN against fp32."""
    import copy

    import torch

    kernel, plain = run(bf16_model, None), run(bf16_model, False)
    reference = run(copy.deepcopy(bf16_model).float(), False)
    _set_route(bf16_model, None)
    results = {}
    for i, out_name in enumerate(outputs):
        tol = ROUTE_GRAD_RTOL if out_name.endswith("_grad") else ROUTE_FWD_RTOL
        rec = {
            "kernel_vs_plain": _rel_l2(kernel[i], plain[i]), "tol": tol,
            "kernel_vs_fp32": _rel_l2(kernel[i], reference[i]),
            "plain_vs_fp32": _rel_l2(plain[i], reference[i]),
        }
        key = f"{name}_{out_name}"
        if not rec["kernel_vs_plain"] <= tol:
            raise AssertionError(f"route parity {key}: {rec}")
        if not rec["kernel_vs_fp32"] <= ROUTE_MARGIN * rec["plain_vs_fp32"] + 1e-3:
            raise AssertionError(f"kernel route less accurate than the plain one, {key}: {rec}")
        results[key] = rec
    del reference
    torch.cuda.empty_cache()
    return results


def phase_profile(step) -> dict:
    """One guided step under torch.profiler: device time by kernel, and the
    step's device busy share."""
    latents, context = step.initial_inputs()
    record = {"phase": "profile", "ok": True,
              **profile_record(lambda: step.guided_denoise_step(latents, context))}
    emit(record)
    return record


def profile_record(fn) -> dict:
    """`fn()` once under torch.profiler: its wall ms, device ms, busy share,
    flash-kernel ms, kernel launches and the 15 kernels of most device time;
    and `fn()` unprofiled (CUDA events, median of 3), against which the busy
    share is also given: the profiler's cost per launch stretches the
    profiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    unprofiled = []
    for _ in range(3):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        unprofiled.append(start.elapsed_time(end))
    unprofiled_ms = sorted(unprofiled)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    # flash_attention.cu's (fp32) kernels are flash_*_kernel, flash_mma.cu's
    # (bf16: fwd, dq, dk/dv) flash::*
    flash_us = sum(
        e.self_device_time_total for e in kernels if "flash_" in e.key or "flash::" in e.key
    )
    return {
        "step_wall_ms": wall_ms,
        "device_ms": total_us / 1e3, "device_busy_share": total_us / 1e3 / wall_ms,
        "unprofiled_ms": unprofiled_ms,
        "device_busy_share_unprofiled": total_us / 1e3 / unprofiled_ms,
        "flash_kernels_ms": flash_us / 1e3, "kernel_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
                for e in top],
    }


class PartTimer:
    """Shadows methods of `obj` with wrappers that record CUDA events and
    the flash launches around each call; `remove()` restores them."""

    def __init__(self, fa, obj, names):
        self.fa, self.obj, self.calls = fa, obj, {name: [] for name in names}
        for name in names:
            setattr(obj, name, self._wrap(name, getattr(obj, name)))

    def _wrap(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            before = dict(self.fa.LAUNCHES)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            launched = {k: self.fa.LAUNCHES[k] - before[k] for k in before}
            self.calls[name].append((start, end, launched))
            return out

        return timed

    def remove(self) -> None:
        for name in self.calls:
            delattr(self.obj, name)

    def ms(self, name) -> float:
        return sum(start.elapsed_time(end) for start, end, _ in self.calls[name])

    def launches(self, name) -> dict:
        """Launches of each kernel over every call of `name`."""
        return {k: sum(launched[k] for _, _, launched in self.calls[name]) for k in self.fa.LAUNCHES}


def phase_sample(fa, sd):
    """`StableDiffusion.sample` at 512px, batch 1, CFG 7: a 20-step DDIM, a
    10-step DPM-Solver++(2M) and an img2img/RePaint run from the first
    image. Per run: the schedule's k, flash launches (the loop's per UNet
    evaluation, the decode's and encode's, each asserted), the image
    (asserted finite, (1, 3, 512, 512)), seconds per image, the text
    encoding, the UNet loop and the decode apart, and peak memory. Returns
    (launches, launches per UNet evaluation)."""
    import torch

    def generator(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    size = (IMAGE_SIZE, IMAGE_SIZE)
    sd.sample([PROMPT], n_steps=2, size=size, generator=generator(1))  # warm-up
    torch.cuda.synchronize()
    totals = {name: 0 for name in REPLACES}
    runs, first_image = [], None
    for name, options in SAMPLE_RUNS:
        if name == "img2img":
            options = {**options, "init_images": first_image}
        k = len(sd.schedule_indices(options["n_steps"], from_index=options.get("from_index", 999)))
        evals = k * (1 + options.get("n_resample", 0))
        timer = PartTimer(fa, sd, ("conditioning", "sample_loop", "decode", "encode"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        images = sd.sample([PROMPT], guidance_scale=CFG_SCALE, size=size, generator=generator(0),
                           **options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        timer.remove()
        parts = {part: timer.launches(part) for part in timer.calls}
        measured = per_step(parts["sample_loop"], evals)
        check_per_step("sample", measured)
        vae_calls = {"decode": 1, "encode": int("init_images" in options)}
        for part, calls in vae_calls.items():
            if parts[part] != {k: n * calls for k, n in PER_VAE_CALL.items()}:
                raise AssertionError(f"sample {name}: {part} launched {parts[part]}")
        # text encoding (masked, S = 77) launches none
        if any(parts["conditioning"].values()):
            raise AssertionError(f"sample {name}: the text encoder launched a flash kernel")
        if launches != {k: sum(p[k] for p in parts.values()) for k in launches}:
            raise AssertionError(f"sample {name}: launches {launches} outside {parts}")
        if images.shape != (1, 3, IMAGE_SIZE, IMAGE_SIZE) or not torch.isfinite(images).all():
            raise AssertionError(f"sample {name}: images {tuple(images.shape)} not finite")
        loop_ms = timer.ms("sample_loop")
        runs.append({
            "run": name, "options": {k: v for k, v in options.items() if k != "init_images"},
            "k": k, "unet_evals": evals, "launches": launches,
            "launches_per_unet_eval": measured,
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "s_per_image": wall,
            "ms_per_sampling_step": loop_ms / k, "ms_per_unet_eval": loop_ms / evals,
            "loop_ms": loop_ms, "text_encode_ms": timer.ms("conditioning"),
            "decode_ms": timer.ms("decode"), "encode_ms": timer.ms("encode"),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
        for kernel in totals:
            totals[kernel] += launches[kernel]
        if first_image is None:
            first_image = images
    emit({"phase": "sample", "ok": True, "model": MODEL, "guidance_scale": CFG_SCALE,
          "runs": runs})
    return totals, measured


def phase_sample_profile(sd) -> dict:
    """One CFG sampling step (the batched UNet evaluation and the DDIM
    update) under torch.profiler."""
    import torch

    uncond, cond = sd.conditioning([""]), sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE), torch.Generator("cuda").manual_seed(2))
    pairs = sd.schedule_indices(20)[:1]
    sd.sample_loop(latents, pairs, uncond, cond, CFG_SCALE)
    record = {"phase": "sample_profile", "ok": True,
              **profile_record(lambda: sd.sample_loop(latents, pairs, uncond, cond, CFG_SCALE))}
    emit(record)
    return record


def phase_guided_sample(fa, sd, step):
    """`engine.guided_sample` at 512px with CFG 7 and guidance scale 0.5,
    the loss the guided step's prompt-bank loss (CLIP ViT-B/32, spherical
    distance to its fixed target), for GUIDED_SAMPLE_STEPS steps: finite latents and losses, 21
    launches of each kernel a step, ms per step and peak memory. Returns
    (launches, launches per step)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample

    uncond, cond = sd.conditioning([""]), sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE), torch.Generator("cuda").manual_seed(3))
    pairs = sd.schedule_indices(GUIDED_SAMPLE_STEPS)
    options = dict(conditioning=cond, uncond_conditioning=uncond, cfg_scale=CFG_SCALE,
                   guidance_scale=0.5)
    guided_sample(sd, [step.clip_loss], latents, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, losses = guided_sample(sd, [step.clip_loss], latents, pairs, **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step("guided_sample", measured)
    if not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("guided_sample: non-finite latents or losses")
    emit({
        "phase": "guided_sample", "ok": True, "steps": k, "pairs": pairs.tolist(),
        "guidance_scale": 0.5, "cfg_scale": CFG_SCALE, "losses": losses.tolist(),
        "latents_shape": list(out.shape), "ms_per_step": start.elapsed_time(end) / k,
        "wall_s": wall, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def text_loss(prompts=TEXT_PROMPTS[:1]):
    """`losses.CLIP` with a text prompt bank; every call shares the one
    memoized tower."""
    from perceptor_tpu_torch import losses

    return losses.CLIP(CLIP_NAME).add_texts_(list(prompts))


def phase_text_tower(fa):
    """Both CLIP towers at full width; the text tower on two prompts against
    an fp32 copy of the same weights. Returns the wrapper, which the later
    phases' losses share."""
    import copy

    import torch

    from perceptor_tpu_torch import models
    from perceptor_tpu_torch.models.clip.tokenizer import tokenize

    t0 = time.perf_counter()
    clip = models.CLIP(CLIP_NAME)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fa.reset_launches()
    prompts = list(TEXT_PROMPTS)
    encodings = clip.encode_texts(prompts)  # warm-up, and the checked result
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(5):
        start.record()
        clip.encode_texts(prompts)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    tokens = tokenize(prompts, clip.config.context_length, tokenizer=clip.tokenizer)
    with torch.no_grad():
        reference = copy.deepcopy(clip.module).float().encode_text(tokens)
    reference = reference / reference.norm(dim=-1, keepdim=True)
    err = _rel_l2(encodings, reference)
    norms = encodings.norm(dim=-1)
    if tuple(encodings.shape) != (len(prompts), clip.config.embed_dim):
        raise AssertionError(f"text_tower: encodings {tuple(encodings.shape)}")
    if not torch.isfinite(encodings).all() or float((norms - 1).abs().max()) > 1e-5:
        raise AssertionError(f"text_tower: norms {norms.tolist()}")
    if not err <= TEXT_BF16_RTOL:
        raise AssertionError(f"text_tower: bf16 vs fp32 relative L2 {err} > {TEXT_BF16_RTOL}")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"text_tower: flash launches {dict(fa.LAUNCHES)}")
    emit({
        "phase": "text_tower", "ok": True, "model": CLIP_NAME, "build_s": build_s,
        "parameters": sum(p.numel() for p in clip.module.parameters()),
        "prompts": prompts, "eot_positions": tokens.argmax(-1).tolist(),
        "encodings_shape": list(encodings.shape), "bf16_vs_fp32_rel_l2": err,
        "tol": TEXT_BF16_RTOL, "cosine_between_prompts": float(encodings[0] @ encodings[1]),
        "text_encode_ms": sorted(times)[len(times) // 2],
    })
    return clip


def run_optimize(fa, name, drawer, objectives, steps, extra=None, evaluate=None) -> dict:
    """`engine.optimize` for `steps` Adam steps, a CUDA event after each:
    the loss must fall (the history's last entry below its first, or, where
    every step draws new cutouts, `evaluate()` after the steps below
    `evaluate()` before them), parameters and history stay finite, no flash
    kernel may launch. ms per step is the median after the first (warm-up)
    step; the peak is read from an emptied allocator cache."""
    import torch

    from perceptor_tpu_torch import engine

    before = evaluate() if evaluate else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    _, history = engine.optimize(
        drawer, objectives, n_steps=steps,
        callback=lambda i, params, aux: events[i + 1].record(),
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    check_per_step("optimize", per_step(launches, steps))
    finite = all(math.isfinite(h) for h in history) and all(
        bool(torch.isfinite(p).all()) for p in drawer.parameters())
    if not finite:
        raise AssertionError(f"{name}: non-finite history or parameters")
    first, last = (before, evaluate()) if evaluate else (history[0], history[-1])
    if not last < first:
        raise AssertionError(f"{name}: loss did not fall: {first} -> {last} ({history})")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    record = {
        "steps": steps, "loss_first": first, "loss_last": last, "history": history,
        "first_step_ms": step_ms[0], "ms_per_step": sorted(step_ms[1:])[(steps - 1) // 2],
        "wall_s": wall, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "flash_launches": launches, **(extra or {}),
    }
    return record


def step_profile(drawer, objectives) -> dict:
    """One more optimization step under torch.profiler (and three unprofiled
    before it): device ms, launches and the busy share."""
    from perceptor_tpu_torch import engine

    record = profile_record(engine.make_guidance_step(drawer, objectives))
    return {k: record[k] for k in (
        "device_ms", "kernel_launches", "unprofiled_ms", "device_busy_share_unprofiled",
        "step_wall_ms", "device_busy_share")}


def phase_optimize_raw(fa) -> None:
    """Text-prompted optimization of a 256px pixel grid, then the same steps
    through `run_on_device`."""
    import torch

    from perceptor_tpu_torch import drawers, engine, losses

    shape = (1, 3, RAW_SIZE, RAW_SIZE)
    objectives = [text_loss(), losses.Smoothness()]
    drawer = drawers.Raw.random_fractal_image(shape, seed=0)
    record = run_optimize(fa, "optimize_raw", drawer, objectives, RAW_STEPS)
    if tuple(drawer.synthesize().shape) != shape:
        raise AssertionError(f"optimize_raw: images {tuple(drawer.synthesize().shape)}")
    # the same steps with no read-back: a fresh drawer from the same seed
    fresh = drawers.Raw.random_fractal_image(shape, seed=0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fa.reset_launches()
    start.record()
    params, history = engine.run_on_device(fresh, objectives, fresh.params, RAW_STEPS)
    end.record()
    torch.cuda.synchronize()
    check_per_step("optimize", per_step(dict(fa.LAUNCHES), RAW_STEPS))
    if not (history.is_cuda and params.is_cuda and history.shape == (RAW_STEPS,)):
        raise AssertionError("run_on_device: history or parameters left the device")
    diff = float((history.cpu() - torch.tensor(record["history"])).abs().max())
    if not diff <= RUN_ON_DEVICE_ATOL:
        raise AssertionError(f"run_on_device: history differs from optimize's by {diff}")
    pixels_diff = float((params - drawer.pixels.detach()).abs().max())
    emit({
        "phase": "optimize_raw", "ok": True, "model": CLIP_NAME, "image_size": RAW_SIZE,
        "prompt": TEXT_PROMPTS[0], **record,
        "run_on_device": {
            "ms_per_step": start.elapsed_time(end) / RAW_STEPS,
            "history_max_abs_diff": diff, "tol": RUN_ON_DEVICE_ATOL,
            "pixels_max_abs_diff": pixels_diff,
        },
        "profile": step_profile(drawer, objectives),
    })


def phase_optimize_cutouts(fa) -> None:
    """A 512px pixel grid under the CLIP loss over n random cutouts."""
    import torch

    from perceptor_tpu_torch import drawers
    from perceptor_tpu_torch.transforms import random_cutouts

    clip_loss = text_loss()
    shape = (1, 3, CUTOUT_IMAGE_SIZE, CUTOUT_IMAGE_SIZE)

    def fixed_draw_loss(drawer) -> float:
        generator = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            return float(clip_loss(random_cutouts(
                drawer.synthesize(), generator, CUTOUT_EVAL_COUNT, cut_size=CUT_SIZE,
                cut_pow=CUT_POW)))

    runs = []
    for n in CUTOUT_COUNTS:
        generator = torch.Generator(device="cuda").manual_seed(0)
        shapes = set()

        def cutout_loss(images, n=n, generator=generator, shapes=shapes):
            cutouts = random_cutouts(images, generator, n, cut_size=CUT_SIZE, cut_pow=CUT_POW)
            shapes.add(tuple(cutouts.shape))
            return clip_loss(cutouts)

        drawer = drawers.Raw.random_fractal_image(shape, seed=0)
        record = run_optimize(fa, f"optimize_cutouts n={n}", drawer, [cutout_loss],
                              CUTOUT_STEPS, {"n_cutouts": n},
                              evaluate=lambda: fixed_draw_loss(drawer))
        if shapes != {(n, 3, CUT_SIZE, CUT_SIZE)}:
            raise AssertionError(f"optimize_cutouts n={n}: cutouts {sorted(shapes)}")
        record["cutouts_shape"] = [n, 3, CUT_SIZE, CUT_SIZE]
        record["profile"] = step_profile(drawer, [cutout_loss])
        runs.append(record)
    emit({"phase": "optimize_cutouts", "ok": True, "model": CLIP_NAME,
          "image_size": CUTOUT_IMAGE_SIZE, "cut_size": CUT_SIZE, "cut_pow": CUT_POW,
          "runs": runs})


def phase_optimize_jpeg(fa) -> None:
    """The JPEG drawer: its decode on the card against the CPU's, the round
    trip of the image it encoded, then optimization of its coefficients."""
    import torch

    from perceptor_tpu_torch import drawers, losses
    from perceptor_tpu_torch.drawers import inits
    from perceptor_tpu_torch.drawers.jpeg import decompress_jpeg

    image = inits.fractal((1, 3, RAW_SIZE, RAW_SIZE), seed=0)
    drawer = drawers.JPEG(image)
    with torch.no_grad():
        decoded = drawer.synthesize()
        on_cpu = decompress_jpeg(*(p.detach().cpu() for p in drawer.parameters()),
                                 RAW_SIZE, RAW_SIZE, drawer.factor)
    decode_err = float((decoded.cpu() - on_cpu).abs().max())
    if not decode_err <= JPEG_DECODE_ATOL:
        raise AssertionError(f"optimize_jpeg: decode differs from the CPU's by {decode_err}")
    round_trip = (decoded.cpu() - torch.from_numpy(image)).abs()
    if not float(round_trip.mean()) <= JPEG_ROUND_TRIP_MEAN:
        raise AssertionError(f"optimize_jpeg: round trip mean error {float(round_trip.mean())}")
    objectives = [text_loss(), losses.Smoothness()]
    record = run_optimize(fa, "optimize_jpeg", drawer, objectives, JPEG_STEPS)
    emit({
        "phase": "optimize_jpeg", "ok": True, "model": CLIP_NAME, "image_size": RAW_SIZE,
        "coefficient_shapes": [list(p.shape) for p in drawer.parameters()],
        "decode_vs_cpu_max_abs": decode_err, "decode_tol": JPEG_DECODE_ATOL,
        "round_trip_mean_abs": float(round_trip.mean()),
        "round_trip_max_abs": float(round_trip.max()), "round_trip_mean_tol": JPEG_ROUND_TRIP_MEAN,
        **record, "profile": step_profile(drawer, objectives),
    })


def phase_guided_sample_text(fa, sd):
    """`engine.guided_sample` at 512px with CFG 7 and guidance scale 0.5
    under the text-prompted CLIP loss over 16 random cutouts a step: finite
    latents and losses, 21 launches of each kernel a step, ms per step and
    peak memory. Returns (launches, launches per step)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.transforms import random_cutouts

    uncond, cond = sd.conditioning([""]), sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE), torch.Generator("cuda").manual_seed(4))
    pairs = sd.schedule_indices(GUIDED_TEXT_STEPS)
    shapes = set()

    def augment(generator, images):
        cutouts = random_cutouts(images, generator, GUIDED_TEXT_CUTOUTS)
        shapes.add(tuple(cutouts.shape))
        return cutouts

    options = dict(conditioning=cond, uncond_conditioning=uncond, cfg_scale=CFG_SCALE,
                   guidance_scale=0.5, image_augment=augment)
    objectives = [text_loss()]
    guided_sample(sd, objectives, latents, pairs[:1],
                  generator=torch.Generator("cuda").manual_seed(5), **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, losses = guided_sample(sd, objectives, latents, pairs,
                                generator=torch.Generator("cuda").manual_seed(5), **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step("guided_sample_text", measured)
    if not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("guided_sample_text: non-finite latents or losses")
    if shapes != {(GUIDED_TEXT_CUTOUTS, 3, 224, 224)}:
        raise AssertionError(f"guided_sample_text: cutouts {sorted(shapes)}")
    emit({
        "phase": "guided_sample_text", "ok": True, "steps": k, "pairs": pairs.tolist(),
        "prompt": PROMPT, "n_cutouts": GUIDED_TEXT_CUTOUTS, "guidance_scale": 0.5,
        "cfg_scale": CFG_SCALE, "losses": losses.tolist(), "latents_shape": list(out.shape),
        "ms_per_step": start.elapsed_time(end) / k, "wall_s": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def phase_adm_sample(fa, gd):
    """`GuidedDiffusion.sample` at 512px, batch 1, full depth: the runs of
    ADM_SAMPLE_RUNS, img2img from the first run's image. Per run: the
    schedule's k, the UNet evaluations (k + 1: the last gives the denoised
    images), flash launches per evaluation (asserted: 5 forward, no
    backward), the image (asserted finite, (1, 3, 512, 512); its range is
    reported: like the JAX sampler this one does not clamp), seconds per
    image, ms per step and per evaluation, peak memory. Returns (launches,
    launches per UNet evaluation, the first image)."""
    import torch

    size = (IMAGE_SIZE, IMAGE_SIZE)
    gd.sample(n_steps=2, size=size)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    totals = {name: 0 for name in REPLACES}
    runs, first_image = [], None
    for name, options in ADM_SAMPLE_RUNS:
        if name == "img2img":
            options = {**options, "init_images": first_image}
        k = len(gd.schedule_indices(options["n_steps"], from_index=options.get("from_index", 999),
                                    rho=3.0))
        timer = PartTimer(fa, gd, ("predicted_noise",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        images = gd.sample(n_images=1, size=size,
                           generator=torch.Generator(device="cuda").manual_seed(0), **options)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        timer.remove()
        evals = len(timer.calls["predicted_noise"])
        if evals != k + 1:
            raise AssertionError(f"adm_sample {name}: {evals} UNet evaluations for k = {k}")
        if launches != timer.launches("predicted_noise"):
            raise AssertionError(f"adm_sample {name}: launches outside the UNet: {launches}")
        measured = per_step(launches, evals)
        check_per_step("adm_sample", measured)
        if images.shape != (1, 3, IMAGE_SIZE, IMAGE_SIZE) or not torch.isfinite(images).all():
            raise AssertionError(f"adm_sample {name}: images {tuple(images.shape)} not finite")
        runs.append({
            "run": name, "options": {k_: v for k_, v in options.items() if k_ != "init_images"},
            "k": k, "unet_evals": evals, "launches": launches, "launches_per_unet_eval": measured,
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "image_min": float(images.min()),
            "image_max": float(images.max()), "s_per_image": wall,
            "ms_per_sampling_step": start.elapsed_time(end) / k,
            "ms_per_unet_eval": timer.ms("predicted_noise") / evals,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
        for kernel in totals:
            totals[kernel] += launches[kernel]
        if first_image is None:
            first_image = images
    # one UNet evaluation under the profiler: device ms and the busy share
    diffused = gd.diffuse_images(first_image.clamp(0, 1), ADM_GUIDED_FROM_INDEX,
                                 generator=torch.Generator(device="cuda").manual_seed(9))

    def evaluate():
        with torch.no_grad():
            gd.predicted_noise(diffused, ADM_GUIDED_FROM_INDEX)

    emit({"phase": "adm_sample", "ok": True, "model": ADM_MODEL, "image_size": IMAGE_SIZE,
          "parameters": sum(p.numel() for p in gd.module.parameters()), "runs": runs,
          "unet_eval_profile": profile_record(evaluate)})
    return totals, measured, first_image


def phase_adm_guided_sample(fa, gd, image):
    """`engine.guided_sample` on the ADM model at 512px under the
    text-prompted CLIP loss over 16 random cutouts a step, from `image`
    diffused to ADM_GUIDED_FROM_INDEX; no generator is passed, so the
    augment draws from the default one. Returns (launches, launches per
    step)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.transforms import random_cutouts

    pairs = gd.schedule_indices(ADM_GUIDED_STEPS, from_index=ADM_GUIDED_FROM_INDEX)
    diffused = gd.diffuse_images(image.clamp(0, 1), int(pairs[0, 0]),
                                 generator=torch.Generator(device="cuda").manual_seed(6))
    shapes = set()

    def augment(generator, images):
        cutouts = random_cutouts(images, generator, ADM_GUIDED_CUTOUTS)
        shapes.add(tuple(cutouts.shape))
        return cutouts

    objectives = [text_loss()]
    options = dict(guidance_scale=0.5, image_augment=augment)
    guided_sample(gd, objectives, diffused, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, losses = guided_sample(gd, objectives, diffused, pairs, **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step("adm_guided_sample", measured)
    if out.shape != diffused.shape or not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("adm_guided_sample: non-finite images or losses")
    if shapes != {(ADM_GUIDED_CUTOUTS, 3, 224, 224)}:
        raise AssertionError(f"adm_guided_sample: cutouts {sorted(shapes)}")
    emit({
        "phase": "adm_guided_sample", "ok": True, "model": ADM_MODEL, "steps": k,
        "pairs": pairs.tolist(), "prompt": PROMPT, "n_cutouts": ADM_GUIDED_CUTOUTS,
        "guidance_scale": 0.5, "losses": losses.tolist(), "images_shape": list(out.shape),
        "ms_per_step": start.elapsed_time(end) / k, "wall_s": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def phase_adm_route_parity(gd) -> None:
    """The ADM UNet forward at 512px and its input gradient: kernel route vs
    plain route, both also against an fp32 copy."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    xs = torch.randn((1, 3, IMAGE_SIZE, IMAGE_SIZE), generator=gen, device="cuda")
    probe = torch.randn((1, 6, IMAGE_SIZE, IMAGE_SIZE), generator=gen, device="cuda")
    timesteps = torch.tensor([600.0], device="cuda")

    def unet_out_grad(unet, use_flash):
        _set_route(unet, use_flash)
        x = xs.detach().requires_grad_(True)
        with torch.enable_grad():
            out = unet(x, timesteps)
            (grad,) = torch.autograd.grad((out * probe).sum(), x)
        return out.detach(), grad

    torch.cuda.reset_peak_memory_stats()
    results = compare_routes("adm_unet", gd.module, unet_out_grad, ("out", "input_grad"))
    emit({"phase": "adm_route_parity", "ok": True, "metric": "relative L2 error",
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **results})


def phase_velocity_sample(fa):
    """`VelocityDiffusion("cc12m_1_cfg")` at 256px, batch 1, conditioned on
    the prompt: the runs of VELOCITY_SAMPLE_RUNS, a `reverse_sample` of the
    first image and a 3-step `guided_sample` under the text loss over float
    (from_t, to_t) pairs. No flash kernel may launch. Returns ({path:
    launches}, {path: launches per step})."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion

    t0 = time.perf_counter()
    vd = VelocityDiffusion(VELOCITY_MODEL, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    cond = vd.conditioning(texts=[PROMPT])
    end.record()
    torch.cuda.synchronize()
    conditioning_ms = start.elapsed_time(end)
    if tuple(cond.shape) != (1, 1, vd.config.mapping.clip_dim) or not torch.isfinite(cond).all():
        raise AssertionError(f"velocity_sample: conditioning {tuple(cond.shape)}")
    shape = (1, *vd.shape)
    vd.sample(n_steps=2, conditioning=cond)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def timed(fn):
        """fn() with the UNet evaluations counted and timed: (result,
        record)."""
        timer = PartTimer(fa, vd, ("velocities",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timer.remove()
        evals = len(timer.calls["velocities"])
        return result, {
            "unet_evals": evals, "wall_s": wall, "ms": start.elapsed_time(end),
            "ms_per_unet_eval": timer.ms("velocities") / evals,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }

    fa.reset_launches()
    runs, first_image = [], None
    for name, options in VELOCITY_SAMPLE_RUNS:
        images, record = timed(lambda: vd.sample(
            n_images=1, conditioning=cond,
            generator=torch.Generator(device="cuda").manual_seed(0), **options))
        if images.shape != shape or not torch.isfinite(images).all():
            raise AssertionError(f"velocity_sample {name}: images {tuple(images.shape)} not finite")
        runs.append({
            "run": name, "options": options, **record, "s_per_image": record["wall_s"],
            "ms_per_sampling_step": record["ms"] / options["n_steps"],
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "image_min": float(images.min()),
            "image_max": float(images.max()),
        })
        if first_image is None:
            first_image = images
    reversed_images, record = timed(lambda: vd.reverse_sample(
        first_image.clamp(0, 1), n_steps=VELOCITY_REVERSE_STEPS, conditioning=cond))
    if reversed_images.shape != shape or not torch.isfinite(reversed_images).all():
        raise AssertionError("velocity_sample: reverse_sample not finite")
    runs.append({"run": "reverse_sample", "options": {"n_steps": VELOCITY_REVERSE_STEPS}, **record,
                 "image_std": float(reversed_images.std())})
    launches = {"velocity_sample": dict(fa.LAUNCHES)}
    total_evals = sum(r["unet_evals"] for r in runs)
    measured = {"velocity_sample": per_step(launches["velocity_sample"], total_evals)}
    check_per_step("velocity_sample", measured["velocity_sample"])

    # guided sampling over float (from_t, to_t) pairs
    pairs = vd.schedule_ts(VELOCITY_GUIDED_STEPS)
    diffused = vd.random_diffused(shape, torch.Generator(device="cuda").manual_seed(7))
    objectives = [text_loss()]
    options = dict(conditioning=cond, guidance_scale=0.5)
    guided_sample(vd, objectives, diffused, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fa.reset_launches()
    (out, losses), record = timed(lambda: guided_sample(vd, objectives, diffused, pairs, **options))
    launches["velocity_guided_sample"] = dict(fa.LAUNCHES)
    measured["velocity_guided_sample"] = per_step(launches["velocity_guided_sample"], len(pairs))
    check_per_step("velocity_guided_sample", measured["velocity_guided_sample"])
    if out.shape != shape or not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("velocity guided_sample: non-finite images or losses")

    def evaluate():
        with torch.no_grad():
            vd.velocities(diffused, 0.5, cond)

    emit({
        "phase": "velocity_sample", "ok": True, "model": VELOCITY_MODEL,
        "image_size": list(vd.shape[1:]), "build_s": build_s,
        "parameters": sum(p.numel() for p in vd.module.parameters()),
        "clip_model": vd.config.mapping.clip_model, "conditioning_ms": conditioning_ms,
        "prompt": PROMPT, "runs": runs,
        "guided_sample": {
            "steps": len(pairs), "pairs": pairs.tolist(), "guidance_scale": 0.5,
            "losses": losses.tolist(), "ms_per_step": record["ms"] / len(pairs), **record,
        },
        "flash_launches": launches, "unet_eval_profile": profile_record(evaluate),
    })
    return launches, measured


def phase_timings(fa, peak_flops, peak_bw) -> list:
    """Kernel, plain version and SDPA per site, and the bound."""
    import torch
    import torch.nn.functional as F

    rows = []
    site_list = [(site, site_inputs, "guided_step") for site in SITES] + [
        (site, adm_site_inputs, "adm_guided_sample") for site in ADM_SITES]
    for i, ((site, b, h, s, d, count), make_inputs, path) in enumerate(site_list):
        q, k, v, do = make_inputs(b, h, s, d, seed=100 + i)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_forward(q, k, v, scale)
        delta = (o.float() * do.float()).sum(-1)
        kernels = {
            "flash_fwd": (lambda: fa.flash_forward(q, k, v, scale),
                          lambda: fa.flash_forward_plain(q, k, v, scale)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, scale),
                         lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, scale)),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, scale),
                          lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, scale)),
        }
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qg, kg, vg, scale=scale).backward(do)

        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
        for name, (kernel_fn, plain_fn) in kernels.items():
            flops, nbytes = site_work(name, b, h, s, d)
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            rows.append({
                "kernel": name, "site": site, "path": path, "shape": [b, h, s, d],
                "per_step": count, "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn, reps=5),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes,
                "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
            })
    # the forward at the CFG sampling step's batch-2 sites
    for i, (site, b, h, s, d, count) in enumerate(CFG_SITES):
        q, k, v, _ = site_inputs(b, h, s, d, seed=120 + i)
        scale = 1.0 / math.sqrt(d)
        flops, nbytes = site_work("flash_fwd", b, h, s, d)
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        rows.append({
            "kernel": "flash_fwd", "site": site, "path": "sample", "shape": [b, h, s, d],
            "per_step": count, "ms": time_ms(lambda: fa.flash_forward(q, k, v, scale)),
            "plain_ms": time_ms(lambda: fa.flash_forward_plain(q, k, v, scale), reps=5),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "sdpa_fwd_ms": sdpa_fwd,
        })

    # per guided step: the port's two backward kernels against SDPA's
    # backward (its forward plus backward, less its forward)
    def weighted(names, key):
        return sum(r[key] * r["per_step"] for r in rows
                   if r["kernel"] in names and r["path"] == "guided_step")

    backward = {
        "dq_plus_dkv_ms": weighted(("flash_dq", "flash_dkv"), "ms"),
        "sdpa_bwd_ms": weighted(("flash_fwd",), "sdpa_fwd_bwd_ms")
        - weighted(("flash_fwd",), "sdpa_fwd_ms"),
    }
    emit({"phase": "timings", "ok": True, "rows": rows, "backward_per_step": backward})
    return rows


def kernel_table(rows, launches_by_path, per_step_by_path, errors) -> list:
    """Per kernel, the work of one guided step (site times weighted by their
    launches per step), its launches in every main-path run, and its
    measured launches and ms per step of each path."""
    table = []
    for name in REPLACES:
        mine = [r for r in rows if r["kernel"] == name and r["path"] == "guided_step"]

        def weighted(key, weights=None):
            return sum(r[key] * (weights or {}).get(r["site"], r["per_step"]) for r in mine)

        sampling = [r for r in rows if r["kernel"] == name and r["path"] == "sample"]
        adm = sum(r["ms"] * r["per_step"] for r in rows
                  if r["kernel"] == name and r["path"] == "adm_guided_sample")
        t_ops = sum(r["flops"] * r["per_step"] for r in mine)
        t_bytes = sum(r["bytes"] * r["per_step"] for r in mine)
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(path[name] for path in launches_by_path.values()),
            "max_abs_err": errors[name], "ms": weighted("ms"), "plain_ms": weighted("plain_ms"),
            "bound_ms": weighted("bound_ms"),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in mine) else "bytes",
            # one PyTorch call computes the forward alone (SDPA); none computes
            # dq or dk/dv alone (SDPA's backward returns all three)
            "library_ms": weighted("sdpa_fwd_ms") if name == "flash_fwd" else None,
            "flops_per_step": t_ops, "bytes_per_step": t_bytes,
            "launches_by_path": {path: counts[name] for path, counts in launches_by_path.items()},
            "launches_per_step": {path: counts[name] for path, counts in per_step_by_path.items()},
            "ms_per_step_by_path": {
                "guided_step": weighted("ms"),
                "sample": sum(r["ms"] * r["per_step"] for r in sampling),
                "guided_sample": weighted("ms", CFG_GUIDED_SITE_LAUNCHES),
                "guided_sample_text": weighted("ms", CFG_GUIDED_SITE_LAUNCHES),
                # per UNet evaluation (forward only) and per guided step
                "adm_sample": adm if name == "flash_fwd" else 0.0,
                "adm_guided_sample": adm,
            },
        })
    return table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from perceptor_tpu_torch import guided_step
    from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = card_peaks(name)
    emit({
        "phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": name, "nvidia_smi": smi, "peak_bf16_flops": peak_flops,
        "peak_bytes_per_s": peak_bw,
    })

    t0 = time.perf_counter()
    library = fa.build_library()
    emit({"phase": "build", "ok": True, "library": library.name,
          "seconds": time.perf_counter() - t0})

    errors = phase_kernels(fa)
    phase_kernel_info(fa, library)
    t0 = time.perf_counter()
    step = guided_step.build("sd-v1-512", device="cuda", seed=0)
    emit({"phase": "model_build", "ok": True, "seconds": time.perf_counter() - t0})
    launches, measured = {}, {}
    launches["guided_step"], measured["guided_step"] = phase_guided_step(fa, step)
    phase_profile(step)
    phase_route_parity(step)
    t0 = time.perf_counter()
    sd = StableDiffusion(MODEL, device="cuda", seed=0)
    emit({"phase": "sd_build", "ok": True, "model": MODEL, "seconds": time.perf_counter() - t0})
    launches["sample"], measured["sample"] = phase_sample(fa, sd)
    phase_sample_profile(sd)
    launches["guided_sample"], measured["guided_sample"] = phase_guided_sample(fa, sd, step)
    # the optimization phases' peaks are their own: no diffusion model loaded
    del step, sd
    torch.cuda.empty_cache()
    clip = phase_text_tower(fa)  # held: the phases below share this tower
    phase_optimize_raw(fa)
    phase_optimize_cutouts(fa)
    phase_optimize_jpeg(fa)
    sd = StableDiffusion(MODEL, device="cuda", seed=0)
    launches["guided_sample_text"], measured["guided_sample_text"] = phase_guided_sample_text(fa, sd)
    del sd
    torch.cuda.empty_cache()
    # the pixel-space families; the text loss still shares the held tower
    t0 = time.perf_counter()
    gd = GuidedDiffusion(ADM_MODEL, device="cuda", seed=0)
    torch.cuda.synchronize()
    emit({"phase": "adm_build", "ok": True, "model": ADM_MODEL,
          "seconds": time.perf_counter() - t0})
    launches["adm_sample"], measured["adm_sample"], adm_image = phase_adm_sample(fa, gd)
    launches["adm_guided_sample"], measured["adm_guided_sample"] = phase_adm_guided_sample(
        fa, gd, adm_image)
    phase_adm_route_parity(gd)
    del gd
    torch.cuda.empty_cache()
    velocity_launches, velocity_measured = phase_velocity_sample(fa)
    launches.update(velocity_launches)
    measured.update(velocity_measured)
    del clip
    torch.cuda.empty_cache()
    rows = phase_timings(fa, peak_flops, peak_bw)

    print(json.dumps({"kernels": kernel_table(rows, launches, measured, errors)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
