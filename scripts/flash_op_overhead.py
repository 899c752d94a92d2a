#!/usr/bin/env python3
"""The cost of the flash kernels' registered ops (`torch.library.custom_op`)
against an `autograd.Function` over the same CUDA implementations, and the
guided step's ms of a given tree of the port.

    python scripts/flash_op_overhead.py ops             # this tree's ops
    python scripts/flash_op_overhead.py step [--root DIR] [--steps N]

`ops`: at (1, 1, 1024, 64) and the guided step's (1, 8, 4096, 40) site,
bf16, forward and backward (`torch.autograd.grad` of the output's sum)
through `flash_forward` (the registered ops) and through a local
`autograd.Function` that calls the same CUDA implementations, the results
bitwise compared; host microseconds and device ms a call over 200 calls
between CUDA events, in the order op, Function, op, Function; then the
forward alone, 500 calls each. `step`: `guided_step.build("sd-v1-512")`
from the tree at `--root` (this one by default), 3 warm-up steps, then
`--steps` steps from its initial inputs, each between CUDA events. One JSON line each, with the
card's name and power limit."""

import argparse
import json
import os
import subprocess
import sys
import time


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def ops():
    import torch

    from perceptor_tpu_torch.ops import flash_attention_kernel as fa

    class Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            o, lse = fa._flash_fwd_cuda(q, k, v, scale)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.scale = scale
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            if do.stride(3) != 1 or any(s * do.element_size() % 16 for s in do.stride()[:3]):
                do = do.contiguous()
            delta = (o.float() * do.float()).sum(dim=-1)
            dq = fa._flash_dq_cuda(q, k, v, do, lse, delta, ctx.scale)
            dk, dv = fa._flash_dkv_cuda(q, k, v, do, lse, delta, ctx.scale)
            return dq, dk, dv, None

    fa.build_library()
    out = {"mode": "ops", "smi": _smi()}
    for label, shape in (("small", (1, 1, 1024, 64)), ("guided_4096_40", (1, 8, 4096, 40))):
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v = (torch.randn(shape, device="cuda", dtype=torch.bfloat16, generator=g)
                   for _ in range(3))
        scale = shape[-1] ** -0.5

        def through(attend):
            def call():
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = attend(*leaves)
                return (o, *torch.autograd.grad(o.float().sum(), leaves))
            return call

        op = through(lambda a, b, c: fa.flash_forward(a, b, c, scale)[0])
        function = through(lambda a, b, c: Function.apply(a, b, c, scale))
        record = {"bitwise": all(torch.equal(x, y) for x, y in zip(op(), function()))}
        for name, fn, n in (("op", op, 200), ("function", function, 200), ("op_again", op, 200),
                            ("function_again", function, 200),
                            ("fwd_op", lambda: fa.flash_forward(q, k, v, scale), 500),
                            ("fwd_function", lambda: fa._flash_fwd_cuda(q, k, v, scale), 500)):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            record[name] = {"host_us_per_call": (time.perf_counter() - t0) / n * 1e6,
                            "device_ms_per_call": start.elapsed_time(end) / n}
        out[label] = record
    print(json.dumps(out), flush=True)


def step(root, steps):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from perceptor_tpu_torch import guided_step
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa

    fa.build_library()
    built = guided_step.build("sd-v1-512", device="cuda", seed=0)
    latents, context = built.initial_inputs()
    for _ in range(3):
        built.guided_denoise_step(latents, context)
    torch.cuda.synchronize()
    ms = []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        built.guided_denoise_step(latents, context)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    print(json.dumps({"mode": "step", "root": root, "smi": _smi(), "ms_per_step": ms,
                      "median_ms": sorted(ms)[len(ms) // 2]}), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("mode", choices=("ops", "step"))
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()
    if args.mode == "ops":
        sys.path.insert(0, args.root)
        ops()
    else:
        step(args.root, args.steps)
