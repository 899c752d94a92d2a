"""The collective inventory of one CFG sampling step of `StableDiffusion`
under `sample(mesh=)`'s placement, for a mesh of several ranks, counted on
one host: a fake process group (`torch.testing._internal.distributed.fake_pg`,
whose collectives move nothing) lets `make_fx` trace the step as rank 0 of
the mesh would run it, and `utils.hlo` reads the traced program. Counts and
shapes only: no time is measured.

    python scripts/mesh_inventory.py                 # TINY SD, CPU
    python scripts/mesh_inventory.py --axes tensor=2 context=2
    python scripts/mesh_inventory.py --shapes runwayml/stable-diffusion-v1-5

Prints one JSON line per mesh: the collectives by JAX's names, the largest
all-gather's elements, the bytes one rank sends, and each all-gather's
shape (its count). `--shapes` builds a published configuration on the meta
device (no storage, nothing traced) and prints, per mesh and part, how many
weights the tensor-parallel rules shard, each one all-gather per layer call
on the mesh path, and the largest one's elements.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def inventory(sd, mesh, latents, context2, guidance_scale: float = 7.0) -> dict:
    import torch
    from torch.distributed.tensor import DTensor
    from torch.fx.experimental.proxy_tensor import make_fx

    from perceptor_tpu_torch.parallel.partition import (
        gathered_params, is_sharded, shard_for_sampling)
    from perceptor_tpu_torch.parallel.plan import activate, plan_for_mesh
    from perceptor_tpu_torch.utils import hlo

    sharded, placed = shard_for_sampling(mesh, sd.params, latents)
    pairs = torch.as_tensor(sd.schedule_indices(2), device=sd.device)
    from_idx, to_idx = pairs[0, 0].expand(1), pairs[0, 1].expand(1)
    spec = placed.placements

    def step(local):
        x = DTensor.from_local(local, mesh, spec, run_check=False).full_tensor()
        with gathered_params(sd.serving_modules(), sharded), activate(plan_for_mesh(mesh)):
            return sd.cfg_predictions(x, from_idx, context2, guidance_scale).step(to_idx)

    with torch.no_grad():
        graph = make_fx(step)(placed.to_local())
    ops = hlo.collective_inventory(graph)
    return {
        "collective_counts": hlo.collective_counts(graph),
        "max_gather_elements": hlo.max_gather_elements(graph),
        "bytes_sent": hlo.program_ici_bytes(graph),
        "all_gather_shapes": {str(shape): n for shape, n in Counter(
            op.shapes[0] for op in ops if op.op == "all-gather").items()},
        "sharded_tensors": sum(is_sharded(t) for part in sharded.values()
                               for t in part.values()),
    }


def sharded_weights(model: str, mesh) -> dict:
    """Per part of `model`'s UNet, VAE and text encoder built on the meta
    device: (weights the rules shard on `mesh`, the largest one's elements)."""
    import torch

    from perceptor_tpu_torch.models.stable_diffusion import config as sd_config
    from perceptor_tpu_torch.models.stable_diffusion.text_encoder import CLIPTextEncoder
    from perceptor_tpu_torch.models.stable_diffusion.unet import UNet
    from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL
    from perceptor_tpu_torch.parallel import SD_TENSOR_PARALLEL_RULES, partition_params

    configs = sd_config.MODEL_CONFIGS[model]
    out = {}
    for part, cls, cfg in zip(("unet", "vae", "text_encoder"),
                              (UNet, AutoencoderKL, CLIPTextEncoder), configs):
        with torch.device("meta"):
            module = cls(cfg)
        shapes = {name: p for name, p in module.named_parameters()}
        specs = partition_params(shapes, SD_TENSOR_PARALLEL_RULES, mesh)
        split = [shapes[name].numel() for name, spec in specs.items()
                 if any(axis is not None for axis in spec)]
        out[part] = {"sharded": len(split), "of": len(shapes), "largest": max(split, default=0)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="tiny")
    parser.add_argument("--size", type=int, default=16)
    parser.add_argument("--axes", nargs="*", default=["tensor=2", "context=2"])
    parser.add_argument("--shapes", default=None, help="a published SD configuration")
    args = parser.parse_args(argv)
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from perceptor_tpu_torch import parallel
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    if args.shapes is not None:
        for axis in args.axes:
            name, n = axis.split("=")
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(n))
            try:
                mesh = parallel.create_mesh(data=1, **{name: int(n)})
                print(json.dumps({"model": args.shapes, "mesh": axis,
                                  **sharded_weights(args.shapes, mesh)}), flush=True)
            finally:
                dist.destroy_process_group()
        return 0
    sd = StableDiffusion(args.model, fp16=False, device="cpu")
    gen = torch.Generator().manual_seed(0)
    down = sd.vae_config.downscale
    latents = torch.randn((1, sd.vae_config.latent_channels, args.size // down,
                           args.size // down), generator=gen)
    context2 = torch.randn((2, sd.text_config.context_length, sd.unet_config.context_dim),
                           generator=gen)
    for axis in args.axes:
        name, n = axis.split("=")
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(n))
        try:
            mesh = parallel.create_mesh(data=1, **{name: int(n)})
            print(json.dumps({"model": args.model, "size": args.size, "mesh": axis,
                              **inventory(sd, mesh, latents, context2)}), flush=True)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
