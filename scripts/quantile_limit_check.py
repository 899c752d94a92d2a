#!/usr/bin/env python3
"""Where does `torch.quantile` refuse its input?

    python3 scripts/quantile_limit_check.py [cpu|cuda]

`predictions/base.py quantile_threshold` (the dynamic thresholds) calls
`torch.quantile` once over a (N, C * H * W) batch. Some builds refuse an
input of more than 2**24 elements. This prints, for the device given
(default: cuda), whether each of a few shapes is taken: one JSON line with
the torch version, the device and {shape: "ok" or the error}.
"""

from __future__ import annotations

import json
import sys

import torch

LIMIT = 1 << 24
SHAPES = (
    (1, LIMIT), (1, LIMIT + 1),  # one row at and above 2**24 elements
    (2, 3 * 2048 * 2048),  # a batch of two 2048px images: each row below, the sum above
    (2, LIMIT // 2), (3, LIMIT // 2),  # a batch whose sum is at and above it
)


def main(argv) -> int:
    device = torch.device(argv[1] if len(argv) > 1 else "cuda")
    results = {}
    for shape in SHAPES:
        xs = torch.rand(shape, device=device)
        try:
            out = torch.quantile(xs, 0.95, dim=1)
            results[str(shape)] = "ok" if bool(torch.isfinite(out).all()) else "not finite"
        except RuntimeError as error:
            results[str(shape)] = str(error).splitlines()[0]
        del xs
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print(json.dumps({"torch": torch.__version__, "device": name, "quantile": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
