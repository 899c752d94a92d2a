"""Driver of `StableDiffusion.sample`: text to image with classifier-free
guidance as one batched UNet call, the DDIM sampler over the rho-spaced
index schedule, and the VAE decode.

One call samples `prompts_per_call` distinct prompts, drawn from the
run's seed with the traffic mix's word list and lengths, from latents
drawn by a generator seeded per call; it ends when its images are on the
device (synchronised). A step is one DDIM step of the batch. The weights
are drawn here from the run's seed and handed to the program through
`StableDiffusion.load_state_dicts` (the text tower's upstream names mapped
by the program's public converter).

Compared with the reference, once the window has closed: one call drawn
from the seed among all the window's calls (reservoir sampling). The
reference tokenizes its prompts and encodes them itself; it draws the
first latents from the call's generator seed (they must match exactly);
it works out the index schedule (the program's timesteps must match
exactly); at every step it runs its UNet on the latents the program had
at that step and holds each of the program's 2 x prompts_per_call UNet
rows to its own, and it holds the program's next latents to its own CFG
combination and DDIM update of the program's latents and UNet rows; and
it decodes the program's final latents.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import compare
from benchmark.harness.device import synchronize
from benchmark.harness.registry import ROOT
from benchmark.harness.spans import Spans
from benchmark.harness.weights import derived_seed, draw
from benchmark.reference import diffusion
from benchmark.reference.clip import CLIPTextModel
from benchmark.reference.pipelines import Txt2ImgReference, decode
from benchmark.reference.sd_unet import UNet2DConditionModel
from benchmark.reference.sd_vae import AutoencoderKL

PARTS = {"unet": UNet2DConditionModel, "vae": AutoencoderKL, "text_encoder": CLIPTextModel}


def draw_weights(cfg: dict, seed: int, device) -> dict:
    return {part: draw(cls, cfg[part], seed, part, device) for part, cls in PARTS.items()}


def build_reference(cfg: dict, seed: int, device, fp8: bool = False) -> Txt2ImgReference:
    return Txt2ImgReference(cfg, draw_weights(cfg, seed, device), device, fp8)


class Traffic:
    """The calls' prompts and generator seeds, drawn from the run's seed:
    each prompt `min_words` to `max_words` words of the mix's word list."""

    def __init__(self, mix: dict, seed: int):
        with open(ROOT / mix["words_file"]) as f:
            self.words = f.read().split()
        self.mix = mix
        self.rng = random.Random(derived_seed(seed, "traffic"))

    def next(self):
        mix, rng = self.mix, self.rng
        prompts = [" ".join(rng.choice(self.words)
                            for _ in range(rng.randint(mix["min_words"], mix["max_words"])))
                   for _ in range(mix["prompts_per_call"])]
        return prompts, rng.randrange(1 << 62)


def measures(record: dict, reference: Txt2ImgReference, mix: dict) -> dict:
    values = {}
    n = len(record["prompts"])
    context2 = reference.encode([""] * n + record["prompts"])
    values["text_rel_err"] = compare.rel_err(record["context2"], context2)
    first = reference.initial_latents(n, mix["size"], record["generator_seed"])
    values["start_max_err"] = compare.max_err(record["latents"][0], first) \
        if record["latents"] else float("inf")
    pairs = reference.pairs(mix["steps"], mix["rho"])
    values["schedule_mismatches"] = float(
        sum(int(t[0]) != int(i) for t, (i, _) in zip(record["ts"], pairs))
        + abs(len(record["ts"]) - len(pairs)))
    chain = record["latents"] + [record["final_latents"]]
    unet_err = update_err = 0.0
    for k, (i, j) in enumerate(pairs[:len(record["latents"])]):
        unet_out = reference.unet_out(chain[k], int(i), context2)
        unet_err = max(unet_err, compare.rel_err(record["unet_out"][k], unet_out))
        stepped = reference.update(chain[k], record["unet_out"][k], int(i), int(j),
                                   mix["guidance_scale"])
        update_err = max(update_err, compare.rel_err(chain[k + 1], stepped))
    values["unet_rel_err"] = unet_err
    values["update_rel_err"] = update_err
    images = decode(reference.vae, record["final_latents"])
    values["image_rel_err"] = compare.rel_err(record["images"], images)
    values["image_max_err"] = compare.max_err(record["images"], images)
    return values


class Cell:
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
        weights["text_encoder"] = text_encoder_state_dict_from_hf(weights["text_encoder"],
                                                                  self.sd.text_config)
        self.sd.load_state_dicts(weights)
        del weights
        self.timings = {"port_build_s": t1 - t0, "weights_s": time.perf_counter() - t1}
        self.traffic = Traffic(mix, seed)
        self.steps_per_call = len(diffusion.rho_index_pairs(
            *diffusion.scaled_linear_schedule(cfg["schedule"]), mix["steps"], mix["rho"]))
        self.spans = Spans()
        self.spans.wrap(self.sd, "conditioning", "text_encode")
        self.spans.wrap(self.sd.unet, "forward", "unet")
        self.spans.wrap(self.sd, "decode", "vae_decode")
        self.rng = random.Random(derived_seed(seed, "compared"))
        self.sampling = False
        self.count, self.record = 0, None

    def _sample(self, prompts, generator_seed):
        gen = torch.Generator(device=self.device).manual_seed(generator_seed)
        mix = self.mix
        images = self.sd.sample(prompts, n_steps=mix["steps"],
                                guidance_scale=mix["guidance_scale"],
                                size=(mix["size"], mix["size"]), eta=0.0, generator=gen)
        synchronize(self.device)
        return images

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
            record["unet_out"].append(out.detach().clone())

        def decoded(args, kwargs, out):
            record["final_latents"] = args[0].detach().clone()

        self.spans.hooks.update(unet=unet_call, vae_decode=decoded)
        try:
            record["images"] = self._sample(prompts, generator_seed)
        finally:
            self.spans.hooks.clear()
        self.record = record

    def warm_up(self) -> None:
        self.call()
        self.count, self.record = 0, None

    def count_call(self) -> None:
        self._sample(*self.traffic.next())

    def release(self) -> None:
        self.sd = self.spans = None

    def measures(self) -> dict:
        return measures(self.record, build_reference(self.cfg, self.seed, self.device), self.mix)


def control_measures(cell: dict, seed: int, device) -> dict:
    """The control's measures: the reference with fp8 products and a
    bfloat16 update in the program's place, one call of the mix's first
    prompts, held to the float32 reference."""
    cfg, mix = cell["config_data"], cell["mix"]
    prompts, generator_seed = Traffic(mix, seed).next()
    control = build_reference(cfg, seed, device, fp8=True)
    with torch.no_grad():
        record = control.sample(prompts, generator_seed, mix)
    del control
    with torch.no_grad():
        return measures(record, build_reference(cfg, seed, device), mix)
