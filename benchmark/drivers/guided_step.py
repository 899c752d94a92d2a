"""Driver of `guided_step.GuidedStep.guided_denoise_step`, the CLIP-guided
SD denoise step.

One call is one guided step of batch `batch`, ended by reading its loss
back to the host, as a user's logging loop does. Calls chain along
trajectories of `trajectory_steps` steps, each from the seeded latents,
under the seeded random text context. The weights, the latents and the
context are drawn here from the run's seed and handed to the program
through its public loaders.

Compared with the reference, once the window has closed: the window's
first step (from the seeded latents) and `compared_steps` more drawn from
the seed among all its steps (reservoir sampling, so every step is as
likely). The reference recomputes each from the latents the program had:
the UNet noise, the loss and its gradient with respect to the latents
(the flash backward included), each against the reference's; and the
program's output latents against the reference's guided update of the
program's own noise and gradient.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import compare
from benchmark.harness.spans import Spans
from benchmark.harness.weights import derived_seed, draw
from benchmark.reference.clip import OpenCLIP
from benchmark.reference.pipelines import GuidedReference
from benchmark.reference.sd_unet import UNet2DConditionModel
from benchmark.reference.sd_vae import AutoencoderKL

PARTS = {"unet": UNet2DConditionModel, "vae": AutoencoderKL, "clip": OpenCLIP}
WARM_UP_STEPS = 3


def draw_weights(cfg: dict, seed: int, device) -> dict:
    return {part: draw(cls, cfg[part], seed, part, device) for part, cls in PARTS.items()}


def build_reference(cfg: dict, seed: int, device, fp8: bool = False) -> GuidedReference:
    return GuidedReference(cfg, draw_weights(cfg, seed, device), device, fp8)


def inputs(cfg: dict, batch: int, seed: int, device):
    """The seeded (latents, text context)."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, "inputs"))
    down = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    size = cfg["image_size"] // down
    latents = torch.randn((batch, cfg["unet"]["in_channels"], size, size), generator=gen,
                          device=device)
    context = torch.randn((batch, cfg["context_length"], cfg["unet"]["cross_attention_dim"]),
                          generator=gen, device=device)
    return latents, context


def measures(records, reference: GuidedReference, context) -> dict:
    """Each measure's worst case over `records`; `per_step` keeps every
    record's readings, with its place in its trajectory and the
    reference's gradient norm."""
    per_step = []
    for r in records:
        noise, grad, loss = reference.loss_noise_grad(r["latents_in"], context)
        stepped = GuidedReference.update(reference, r["latents_in"], r["noise"], r["grad"])
        per_step.append({
            "noise_rel_err": compare.rel_err(r["noise"], noise),
            "grad_rel_err": compare.rel_err(r["grad"], grad),
            "loss_abs_err": compare.max_err(r["loss"], loss),
            "update_max_err": compare.max_err(r["latents_out"], stepped),
            "position": r.get("position"), "grad_norm": float(torch.linalg.norm(grad)),
        })
    values = {name: max(p[name] for p in per_step)
              for name in ("noise_rel_err", "grad_rel_err", "loss_abs_err", "update_max_err")}
    return dict(values, per_step=per_step)


class Cell:
    def __init__(self, cell: dict, seed: int, device):
        from perceptor_tpu_torch import guided_step

        cfg, mix = cell["config_data"], cell["mix"]
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        t0 = time.perf_counter()
        self.step = guided_step.build(cfg["port"]["config"], device=device, seed=seed)
        t1 = time.perf_counter()
        weights = draw_weights(cfg, seed, device)
        for part in PARTS:
            getattr(self.step, part).load_state_dict(weights[part])
        del weights
        self.timings = {"port_build_s": t1 - t0, "weights_s": time.perf_counter() - t1}
        self.latents0, self.context = inputs(cfg, mix["batch"], seed, device)
        self.steps_per_call = 1
        self.spans = Spans()
        self.spans.wrap(self.step.unet, "forward", "unet")
        self.spans.wrap(self.step.vae, "decode", "vae_decode")
        self.spans.wrap(self.step, "clip_loss", "clip_loss")
        self.spans.wrap(self.step, "step_with_gradient", "guided_update")
        self.rng = random.Random(derived_seed(seed, "compared"))
        self.sampling = False
        self._reset()

    def _reset(self):
        self.latents, self.position, self.count = self.latents0, 0, 0
        self.start, self.reservoir = None, []

    def _slot(self):
        """Where this window step's record goes: "start", a reservoir index,
        or None."""
        i = self.count
        self.count += 1
        if i == 0:
            return "start"
        k = self.mix["compared_steps"]
        if len(self.reservoir) < k:
            return len(self.reservoir)
        j = self.rng.randrange(i)
        return j if j < k else None

    def call(self) -> None:
        if self.position == self.mix["trajectory_steps"]:
            self.latents, self.position = self.latents0, 0
        slot = self._slot() if self.sampling else None
        record = {}
        if slot is not None:
            def keep(args, kwargs, out):
                # copies: a program may reuse its buffers from step to step
                record["noise"], record["grad"] = (a.detach().clone() for a in args[1:3])
            self.spans.hooks["guided_update"] = keep
        latents_in = self.latents
        self.latents, loss = self.step.guided_denoise_step(latents_in, self.context)
        float(loss.sum())  # the loss read back: the step is done
        self.position += 1
        if slot is not None:
            self.spans.hooks.pop("guided_update")
            record.update(latents_in=latents_in, latents_out=self.latents, loss=loss,
                          position=self.position - 1)
            if slot == "start":
                self.start = record
            elif slot == len(self.reservoir):
                self.reservoir.append(record)
            else:
                self.reservoir[slot] = record

    def warm_up(self) -> None:
        for _ in range(WARM_UP_STEPS):
            self.call()
        self._reset()

    def count_call(self) -> None:
        self.step.guided_denoise_step(self.latents0, self.context)

    def records(self) -> list:
        return [self.start] + self.reservoir

    def release(self) -> None:
        """Free the program: its modules and every tensor but the records."""
        self.step = self.spans = None
        self.latents = None

    def measures(self) -> dict:
        reference = build_reference(self.cfg, self.seed, self.device)
        return measures(self.records(), reference, self.context)


def control_measures(cell: dict, seed: int, device) -> dict:
    """The control's measures: the reference with fp8 products and a
    bfloat16 update in the program's place, as many chained steps from the
    seeded latents as a run compares, each held to the float32 reference."""
    cfg = cell["config_data"]
    steps = 1 + cell["mix"]["compared_steps"]
    latents, context = inputs(cfg, cell["mix"]["batch"], seed, device)
    control = build_reference(cfg, seed, device, fp8=True)
    records = []
    for _ in range(steps):
        records.append(control.step(latents, context))
        latents = records[-1]["latents_out"]
    del control
    return measures(records, build_reference(cfg, seed, device), context)
