#!/usr/bin/env python3
"""Time DP = 64 instantiations of the port's two bf16 flash backward kernels
at the 512px ADM UNet's site, (1, 8, 1024, 64), against what the port ships
there. (The forward at d = 64 runs unpadded on csrc/flash_wgmma.cu.)

    python3 scripts/flash_d64_trial.py

Needs one CUDA card and nvcc. The shipped dispatch sends head_dim 64 to the
DP = 80 instantiations of dq and dk/dv (16 of 80 shared-memory columns are
zero padding). The variant is a copy of perceptor_tpu_torch/csrc/ whose two
dispatch functions get a line for d <= 64 with the same tiles (4 warps,
64 x 64), built into build/ beside the shipped library. For each kernel it
prints one JSON line: ms per launch of the shipped and the variant kernel,
timed in turns (shipped, variant, variant, shipped) with CUDA events on
head-interleaved inputs as the ADM AttentionBlock passes them; the
variant's max |err| against the fp32 plain version; and both kernels'
registers, local bytes, shared bytes and blocks per SM.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

KERNELS = ("dq", "dkv")


def variant_sources() -> Path:
    """A copy of csrc/ with a `d <= 64` line before each backward `d <= 80` one."""
    src = REPO / "perceptor_tpu_torch" / "csrc"
    dst = REPO / "build" / "d64_trial"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    mma = dst / "flash_mma.cu"
    text = mma.read_text()
    line = re.compile(r"( *)(if \(a\.D <= )80(\) return launch_(?:dq|dkv)<)80(, [^>]*>\(a\);)")
    text, n = line.subn(r"\g<1>\g<2>64\g<3>64\g<4>\n\g<0>", text)
    if n != 2:
        raise RuntimeError(f"expected two backward d <= 80 dispatch lines, found {n}")
    mma.write_text(text)
    return dst


@contextlib.contextmanager
def using(fa, lib):
    saved = fa._library()
    fa._lib = lib
    try:
        yield
    finally:
        fa._lib = saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_d64_trial: CUDA is not available", file=sys.stderr)
        return 1
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa

    fa._library()  # build the shipped library first
    lib = fa.load_library(fa.build_library(variant_sources()))
    site, b, h, s, d, _ = chip_smoke.ADM_SITES[0]
    q, k, v, do = chip_smoke.adm_site_inputs(b, h, s, d, seed=100)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_forward(q, k, v, scale)
    delta = (o.float() * do.float()).sum(-1)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    runs = {
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, scale),
               lambda: fa.flash_dq_plain(qf, kf, vf, dof, lse, delta, scale)),
        "dkv": (lambda: torch.cat(fa.flash_dkv(q, k, v, do, lse, delta, scale)),
                lambda: torch.cat(fa.flash_dkv_plain(qf, kf, vf, dof, lse, delta, scale))),
    }
    for kernel in KERNELS:
        run, plain = runs[kernel]
        ref = plain()
        with using(fa, lib):
            err = float((run().float() - ref).abs().max())
            variant_info = fa.kernel_info(kernel, d, torch.bfloat16)
        shipped_info = fa.kernel_info(kernel, d, torch.bfloat16)
        times = {"shipped": [], "variant": []}
        for turn in ("shipped", "variant", "variant", "shipped"):
            if turn == "shipped":
                times[turn].append(chip_smoke.time_ms(run, reps=200))
            else:
                with using(fa, lib):
                    times[turn].append(chip_smoke.time_ms(run, reps=200))
        tol = chip_smoke.KERNEL_RTOL * float(ref.abs().max())
        print(json.dumps({
            "kernel": kernel, "site": site, "shape": [b, h, s, d], "ms": times,
            "max_abs_err": err, "tol": tol, "ok": err <= tol,
            "variant_info": variant_info, "shipped_info": shipped_info,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
