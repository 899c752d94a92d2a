#!/usr/bin/env python3
"""Time tile variants of the port's bf16 flash dq kernel at the guided step's
d = 40 and d = 80 sites, against the tiles the port ships.

    python3 scripts/flash_dq_tile_trial.py

Needs one CUDA card and nvcc. Each variant is a copy of
perceptor_tpu_torch/csrc/ in which the dq dispatch line of one head_dim
launches other template arguments, built into build/ beside the shipped
library.
For each variant it prints one JSON line: ms per launch of the shipped and
the variant kernel, timed in turns (shipped, variant, variant, shipped) with
CUDA events; the variant's max |err| against the fp32 plain version; and
both kernels' registers, local bytes, shared bytes and blocks per SM. The
shipped tiles are `_TILES` in perceptor_tpu_torch/ops/flash_attention_kernel.py.
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

# (name, largest head_dim of the dispatch line, (DP, RW, CW, BK)): tiles of
# 16 RW query rows and BK keys
VARIANTS = (
    ("d48_64x64", 48, (48, 4, 1, 64)),
    ("d48_64x32", 48, (48, 4, 1, 32)),
    ("d48_128x32", 48, (48, 8, 1, 32)),
    ("d80_32x64", 80, (80, 2, 1, 64)),
    ("d80_64x32", 80, (80, 4, 1, 32)),
)
SITE_BY_BOUND = {48: chip_smoke.SITES[0], 80: chip_smoke.SITES[1]}


def variant_sources(name, bound, template) -> Path:
    """A copy of csrc/ with the dq dispatch line for `bound` changed."""
    src = REPO / "perceptor_tpu_torch" / "csrc"
    dst = REPO / "build" / "dq_tile_trial" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    mma = dst / "flash_mma.cu"
    text = mma.read_text()
    line = re.compile(rf"(if \(a\.D <= {bound}\) return launch_dq<)[^>]*(>\(a\);)")
    text, n = line.subn(rf"\g<1>{', '.join(map(str, template))}\g<2>", text)
    if n != 1:
        raise RuntimeError(f"no dq dispatch line for d <= {bound} in flash_mma.cu")
    mma.write_text(text)
    return dst


@contextlib.contextmanager
def using(fa, library, bound, blocks):
    """Route the wrappers through the library at `library` with dq's tile
    pair for `bound`."""
    import torch

    from perceptor_tpu_torch.ops import cuda_library

    key = (torch.bfloat16, "dq")
    saved_tiles = fa._TILES[key]
    cuda_library.load_library(library)
    fa._TILES[key] = tuple(sorted({**dict(saved_tiles), bound: blocks}.items()))
    try:
        yield
    finally:
        cuda_library.load_library(cuda_library.library_path())
        fa._TILES[key] = saved_tiles


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_dq_tile_trial: CUDA is not available", file=sys.stderr)
        return 1
    from perceptor_tpu_torch.ops import cuda_library
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa

    cuda_library.load_library()  # build the shipped library first
    for name, bound, template in VARIANTS:
        _, rw, _, bk = template
        lib = cuda_library.build_library(variant_sources(name, bound, template))
        site, b, h, s, d, _ = SITE_BY_BOUND[bound]
        q, k, v, do = chip_smoke.site_inputs(b, h, s, d, seed=100)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_forward(q, k, v, scale)
        delta = (o.float() * do.float()).sum(-1)
        run = lambda: fa.flash_dq(q, k, v, do, lse, delta, scale)  # noqa: E731
        ref = fa.flash_dq_plain(q.float(), k.float(), v.float(), do.float(), lse, delta, scale)
        times = {"shipped": [], "variant": []}
        with using(fa, lib, bound, (16 * rw, bk)):
            err = float((run().float() - ref).abs().max())
            variant_info = fa.kernel_info("dq", d, torch.bfloat16)
        shipped_info = fa.kernel_info("dq", d, torch.bfloat16)
        for turn in ("shipped", "variant", "variant", "shipped"):
            if turn == "shipped":
                times[turn].append(chip_smoke.time_ms(run))
            else:
                with using(fa, lib, bound, (16 * rw, bk)):
                    times[turn].append(chip_smoke.time_ms(run))
        tol = chip_smoke.KERNEL_RTOL * float(ref.abs().max())
        print(json.dumps({
            "variant": name, "site": site, "template": list(template),
            "ms": times, "max_abs_err": err, "tol": tol, "ok": err <= tol,
            "variant_info": variant_info, "shipped_info": shipped_info,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
