"""Faults planted in the program's SDXL path, each of which the
`sdxl_txt2img_1024_b4` comparison has to turn into `correct` false (the
companions of `faults.py`, in the same form).

    python3 -m benchmark.tests.sdxl_faults --workload <cell> --seeds 1,2 --fault <name>

runs `benchmark/calibrate.py` with these faults among those it can plant.
"""

import dataclasses
import sys

import torch


def final_layernorm_states(monkeypatch):
    """Both towers give their final LayerNorm's states in place of the
    penultimate layer's."""
    from perceptor_tpu_torch.models.stable_diffusion.text_encoder import CLIPTextEncoder

    encode = CLIPTextEncoder.encode

    def final(self, tokens):
        _, pooled = encode(self, tokens)
        config = self.config
        self.config = dataclasses.replace(config, penultimate=False)
        try:
            states, _ = encode(self, tokens)
        finally:
            self.config = config
        return states, pooled

    monkeypatch.setattr(CLIPTextEncoder, "encode", final)


def dropped_added_embedding(monkeypatch):
    """The UNet leaves the added (pooled text and size ids) embedding out."""
    from perceptor_tpu_torch.models.stable_diffusion.unet import UNet

    monkeypatch.setattr(UNet, "_added_embedding", lambda self, added, n: 0.0)


def empty_prompt_uncond(monkeypatch):
    """The unconditional half is the empty prompt's encodings, not zeros."""
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    setup = StableDiffusion._setup

    def empty(self, texts, negative_texts, *args, **kwargs):
        return setup(self, texts, negative_texts or [""] * len(texts), *args, **kwargs)

    monkeypatch.setattr(StableDiffusion, "_setup", empty)


def shallow_transformers(monkeypatch):
    """The deepest spatial transformers (depth 10 at the 32 x 32 level at
    full size) run their first block only."""
    from perceptor_tpu_torch.models.stable_diffusion.unet import SpatialTransformer, UNet

    forward = UNet._forward

    def shallow(self, *args, **kwargs):
        stacks = [m for m in self.modules() if isinstance(m, SpatialTransformer)]
        deepest = max(len(m.transformer_blocks) for m in stacks)
        kept = {m: m.transformer_blocks for m in stacks if len(m.transformer_blocks) == deepest}
        for m, blocks in kept.items():
            m.transformer_blocks = torch.nn.ModuleList(list(blocks)[:1])
        try:
            return forward(self, *args, **kwargs)
        finally:
            for m, blocks in kept.items():
                m.transformer_blocks = blocks

    monkeypatch.setattr(UNet, "_forward", shallow)


FAULTS = {f.__name__: f for f in (final_layernorm_states, dropped_added_embedding,
                                  empty_prompt_uncond, shallow_transformers)}


def main(argv=None) -> int:
    from benchmark import calibrate
    from benchmark.tests import faults

    faults.FAULTS.update(FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
