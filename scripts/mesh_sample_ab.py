#!/usr/bin/env python3
"""The `sample(mesh=)` path of one tree of the port on the card: that
tree's `chip_smoke.phase_mesh_sample` (a one-rank NCCL world; ms an image
plain and on two meshes, the guided step, bits and launches), then two
more `sample(mesh=)` calls under torch.profiler's CPU activity, each with
its wall ms and the 10 host ops of most self CPU time.

    python scripts/mesh_sample_ab.py ROOT

ROOT is a tree of the repo; to compare a change with its parent, unpack
the parent (`git archive HEAD | tar -x -C build/parent`) and run both in
one call: `python scripts/mesh_sample_ab.py build/parent; python
scripts/mesh_sample_ab.py .`. Prints the card's name and power limit."""

import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from perceptor_tpu_torch import guided_step, parallel  # noqa: E402
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion  # noqa: E402
from perceptor_tpu_torch.ops import flash_attention_kernel as fa  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    print("TREE", root, cs.nvidia_smi(), flush=True)
    fa.build_library()
    step = guided_step.build("sd-v1-512", device="cuda", seed=0)
    sd = StableDiffusion(cs.MODEL, device="cuda", seed=0)
    cs.phase_mesh_sample(fa, sd, step)
    mesh = parallel.create_mesh(data=-1)
    gen = torch.Generator(device="cuda")
    for label in ("call1", "call2"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t1 = time.perf_counter()
            sd.sample([cs.PROMPT], n_steps=cs.MESH_STEPS, size=(cs.IMAGE_SIZE,) * 2,
                      guidance_scale=cs.CFG_SCALE, generator=gen.manual_seed(0), mesh=mesh)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:10]
        print("PROFILE", label, round(wall, 2), [
            (e.key[:50], round(e.self_cpu_time_total / 1e3, 2), e.count) for e in ops],
            flush=True)
    cs.phase_parallel_collectives(fa)
    print("PROBE OK", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
