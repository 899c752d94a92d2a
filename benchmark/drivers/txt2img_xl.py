"""Driver of `StableDiffusion.sample` on Stable Diffusion XL: text to image
with classifier-free guidance as one batched UNet call (zeros for the
unconditional half), the DDIM sampler over the rho-spaced index schedule,
and the VAE decode.

As `txt2img.py`, whose traffic and cell it extends: one call samples
`prompts_per_call` distinct prompts from latents drawn by a generator
seeded per call and ends when its images are on the device. The weights
of the UNet, the VAE and both text towers are drawn here from the run's
seed and handed to the program through `StableDiffusion.load_state_dicts`
(the towers' HF names mapped by the program's public converter).

Compared with the reference, once the window has closed: one call drawn
from the seed among all the window's calls. The reference encodes the
prompts with both towers itself (the states and the pooled embedding of
both CFG halves are held to its own), draws the first latents (exact) and
works out the index schedule (exact); at `compared_steps` of the steps,
drawn from the seed and always with the first and the last, it runs its
UNet on the latents the program had there and holds each UNet row to its
own (every step would cost about 1,000 fp32 TFLOP at 1024 px); at every
step it holds the program's next latents to its CFG combination and DDIM
update of the program's latents and UNet rows; and it decodes the
program's final latents.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.drivers import txt2img
from benchmark.harness import compare
from benchmark.harness.spans import Spans
from benchmark.harness.weights import derived_seed, draw
from benchmark.reference import diffusion
from benchmark.reference.pipelines import decode
from benchmark.reference.sdxl_pipeline import PARTS, Txt2ImgXLReference


def draw_weights(cfg: dict, seed: int, device) -> dict:
    return {part: draw(cls, cfg[part], seed, part, device) for part, cls in PARTS.items()}


def build_reference(cfg: dict, seed: int, device, fp8: bool = False) -> Txt2ImgXLReference:
    return Txt2ImgXLReference(cfg, draw_weights(cfg, seed, device), device, fp8)


def compared_steps(n_steps: int, count: int, seed: int) -> list:
    """`count` step indices of `n_steps`: the first, the last and the rest
    drawn from the seed."""
    inner = list(range(1, n_steps - 1))
    drawn = random.Random(derived_seed(seed, "compared_steps")).sample(
        inner, min(len(inner), max(count - 2, 0)))
    return sorted({0, n_steps - 1, *drawn})


def measures(record: dict, reference: Txt2ImgXLReference, mix: dict, seed: int) -> dict:
    values = {}
    cond2 = reference.conditioning2(record["prompts"], mix["size"])
    values["text_rel_err"] = max(compare.rel_err(record["context2"], cond2[0]),
                                 compare.rel_err(record["pooled2"], cond2[1]))
    n = len(record["prompts"])
    first = reference.initial_latents(n, mix["size"], record["generator_seed"])
    values["start_max_err"] = compare.max_err(record["latents"][0], first) \
        if record["latents"] else float("inf")
    pairs = reference.pairs(mix["steps"], mix["rho"])
    values["schedule_mismatches"] = float(
        sum(int(t[0]) != int(i) for t, (i, _) in zip(record["ts"], pairs))
        + abs(len(record["ts"]) - len(pairs)))
    chain = record["latents"] + [record["final_latents"]]
    steps = set(compared_steps(len(pairs), mix["compared_steps"], seed))
    unet_err = update_err = 0.0
    for k, (i, j) in enumerate(pairs[:len(record["latents"])]):
        if k in steps:
            unet_out = reference.unet_out(chain[k], int(i), cond2)
            unet_err = max(unet_err, compare.rel_err(record["unet_out"][k], unet_out))
            del unet_out
        stepped = reference.update(chain[k], record["unet_out"][k], int(i), int(j),
                                   mix["guidance_scale"])
        update_err = max(update_err, compare.rel_err(chain[k + 1], stepped))
    values["unet_rel_err"] = unet_err
    values["update_rel_err"] = update_err
    images = decode(reference.vae, record["final_latents"])
    values["image_rel_err"] = compare.rel_err(record["images"], images)
    values["image_max_err"] = compare.max_err(record["images"], images)
    return values


class Cell(txt2img.Cell):
    """`txt2img.Cell` over SDXL: its weights, its record (the pooled
    embeddings beside the states) and its comparison."""

    def __init__(self, cell: dict, seed: int, device):
        from perceptor_tpu_torch.convert import text_encoder_state_dict_from_hf
        from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

        cfg, mix = cell["config_data"], cell["mix"]
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        port = cfg["port"]
        t0 = time.perf_counter()
        self.sd = StableDiffusion(port["name"], fp16=port["fp16"], device=device, seed=seed)
        t1 = time.perf_counter()
        weights = draw_weights(cfg, seed, device)
        for part, text_config in (("text_encoder", self.sd.text_config),
                                  ("text_encoder_2", self.sd.text_config_2)):
            weights[part] = text_encoder_state_dict_from_hf(weights[part], text_config)
        self.sd.load_state_dicts(weights)
        del weights
        self.timings = {"port_build_s": t1 - t0, "weights_s": time.perf_counter() - t1}
        self.traffic = txt2img.Traffic(mix, seed)
        self.steps_per_call = len(diffusion.rho_index_pairs(
            *diffusion.scaled_linear_schedule(cfg["schedule"]), mix["steps"], mix["rho"]))
        self.spans = Spans()
        self.spans.wrap(self.sd, "conditioning", "text_encode")
        self.spans.wrap(self.sd.unet, "forward", "unet")
        self.spans.wrap(self.sd, "decode", "vae_decode")
        self.rng = random.Random(derived_seed(seed, "compared"))
        self.sampling = False
        self.count, self.record = 0, None

    def call(self) -> None:
        prompts, generator_seed = self.traffic.next()
        keep = False
        if self.sampling:
            self.count += 1
            keep = self.rng.randrange(self.count) == 0
        if not keep:
            self._sample(prompts, generator_seed)
            return
        record = {"prompts": prompts, "generator_seed": generator_seed, "latents": [],
                  "ts": [], "unet_out": []}

        def unet_call(args, kwargs, out):
            # copies: a program may reuse its buffers from step to step
            record["latents"].append(args[0][:len(prompts)].detach().clone())
            record["ts"].append(args[1].detach().clone())
            record["context2"] = args[2].detach().clone()
            record["pooled2"] = kwargs["added"][0].detach().clone()
            record["unet_out"].append(out.detach().clone())

        def decoded(args, kwargs, out):
            record["final_latents"] = args[0].detach().clone()

        self.spans.hooks.update(unet=unet_call, vae_decode=decoded)
        try:
            record["images"] = self._sample(prompts, generator_seed)
        finally:
            self.spans.hooks.clear()
        self.record = record

    def measures(self) -> dict:
        return measures(self.record, build_reference(self.cfg, self.seed, self.device), self.mix,
                        self.seed)


def control_measures(cell: dict, seed: int, device) -> dict:
    """The control's measures: the reference with fp8 products and a
    bfloat16 update in the program's place, one call of the mix's first
    prompts, held to the float32 reference."""
    cfg, mix = cell["config_data"], cell["mix"]
    prompts, generator_seed = txt2img.Traffic(mix, seed).next()
    control = build_reference(cfg, seed, device, fp8=True)
    with torch.no_grad():
        record = control.sample(prompts, generator_seed, mix)
    del control
    with torch.no_grad():
        return measures(record, build_reference(cfg, seed, device), mix, seed)
