"""PyTorch/CUDA port of perceptor_tpu.

The JAX package (`perceptor_tpu`) is the reference; this package keeps its
module paths so each counterpart is found at the same place
(`perceptor_tpu_torch/ops/attention.py` <-> `perceptor_tpu/ops/attention.py`).
It imports torch and numpy only, never jax or perceptor_tpu. The
flash-attention kernels are CUDA C++ for Hopper (`csrc/`), built at first
use; every other op is plain PyTorch.

As in the JAX package, `core`, `ops`, `schedules`, `transforms` and `utils`
are imported with the package and the heavier layers (`drawers`, `losses`,
`models`, `parallel`, `engine`, `predictions`) on first attribute access.
"""

__version__ = "0.1.0"

from perceptor_tpu_torch import core
from perceptor_tpu_torch import ops
from perceptor_tpu_torch import schedules
from perceptor_tpu_torch import transforms
from perceptor_tpu_torch import utils

__all__ = [
    "core",
    "ops",
    "schedules",
    "transforms",
    "utils",
    "drawers",
    "losses",
    "models",
    "parallel",
    "engine",
]


def __getattr__(name):
    if name in ("drawers", "losses", "models", "parallel", "engine", "predictions"):
        import importlib

        module = importlib.import_module(f"perceptor_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'perceptor_tpu_torch' has no attribute {name!r}")
