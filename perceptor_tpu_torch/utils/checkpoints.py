"""Checkpoint resolution and loading (counterpart of
perceptor_tpu/utils/checkpoints.py), local only: nothing is downloaded.

Checkpoints are searched in the JAX package's cache directories (`models/`,
`~/.cache/perceptor_tpu`, `$PERCEPTOR_TPU_CACHE`), so a file that package
finds, the port finds too. `load_state_dict` reads numpy archives (.npz),
network-snapshot pickles (.pkl), safetensors (through `native_io`, no
package needed) and torch pickles (.pt, .pth, .ckpt, .bin) into
{name: CPU tensor} with JAX's keys and values: torch tensors widened to
fp32, as JAX's loader widens them. A non-numeric entry (the `params-v1`
sentinel) stays a numpy array.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

CACHE_DIRS = (
    "models",
    os.path.expanduser("~/.cache/perceptor_tpu"),
    os.environ.get("PERCEPTOR_TPU_CACHE", ""),
)

_SUFFIXES = (".safetensors", ".npz", ".pt", ".pth", ".ckpt", ".bin", ".pkl")


def find_checkpoint(*names: str) -> Optional[str]:
    """The first existing checkpoint among candidate basenames: a name that
    is a path as it stands, else each cache directory in order, with the
    name's own suffix or each of `_SUFFIXES`."""
    for name in names:
        if not name:
            continue
        if os.path.exists(name):
            return name
        for cache_dir in CACHE_DIRS:
            if not cache_dir:
                continue
            candidates: Iterable[str] = (
                [os.path.join(cache_dir, name)]
                if os.path.splitext(name)[1]
                else [os.path.join(cache_dir, name + sfx) for sfx in _SUFFIXES]
            )
            for path in candidates:
                if os.path.exists(path):
                    return path
    return None


def _value(value):
    """A loaded value as JAX's loader gives it, in torch: tensors fp32 on
    the CPU, numeric arrays as tensors, anything else a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().float()
    array = np.asarray(value)
    if array.dtype.kind in "biuf":
        return torch.from_numpy(array if array.flags.writeable else array.copy())
    return array


_SNAPSHOT_KEYS = ("G_ema", "G", "generator", "model_ema", "net")


def _module_state_dict(obj) -> Optional[Dict]:
    """The state dict of a pickled module-like object (one with a callable
    `.state_dict()`), or None when `obj` is not one."""
    state_dict = getattr(obj, "state_dict", None)
    if not callable(state_dict):
        return None
    return {key: _value(value) for key, value in state_dict().items()}


def load_network_snapshot(path: str) -> Dict:
    """A network-snapshot pickle ({'G_ema': <module>, ...}, StyleGAN-XL's
    distribution format) -> the generator's flat state dict, the first of
    `_SNAPSHOT_KEYS` present. The pickle rebuilds its module classes, so
    their modules must be importable. `dill` reads it where installed, else
    the stdlib `pickle` (dill-written files are plain pickles unless they
    needed dill's own features). Unpickling runs the file's code: load
    only snapshots you trust."""
    try:
        import dill as pickler
    except ImportError:
        import pickle as pickler
    with open(path, "rb") as f:
        obj = pickler.load(f)
    if isinstance(obj, dict):
        for key in _SNAPSHOT_KEYS:
            if key in obj:
                obj = obj[key]
                break
    sd = _module_state_dict(obj)
    if sd is not None:
        return sd
    if isinstance(obj, dict):  # already a raw state dict
        return {k: _value(v) for k, v in obj.items()}
    raise ValueError(
        f"{path}: pickle holds {type(obj).__name__}, expected a module with "
        f".state_dict() or a dict (keys tried: {_SNAPSHOT_KEYS})")


def load_state_dict(path: str) -> Dict:
    """A checkpoint -> a flat {name: CPU tensor} dict."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: _value(data[k]) for k in data.files}
    if path.endswith(".pkl"):
        return load_network_snapshot(path)
    if path.endswith(".safetensors"):
        from perceptor_tpu_torch.utils import native_io

        return {k: _value(v) for k, v in native_io.load_safetensors(path).items()}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {key: _value(value) for key, value in obj.items()}


# -- native pre-converted artifacts ------------------------------------------

NATIVE_FORMAT_KEY = "__perceptor_tpu_format__"
_NATIVE_FORMAT = "params-v1"


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def flatten_params(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested param tree -> a flat {'a/b/c': numpy array} dict."""
    out: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_params(value, path))
        else:
            out[path] = _numpy(value)
    return out


def unflatten_params(flat: Dict) -> Dict:
    """The inverse of `flatten_params`."""
    out: Dict = {}
    for path, value in flat.items():
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def save_params(path: str, params: Dict) -> None:
    """Write a pre-converted native-params artifact (.npz): the wrapper's
    own nested param tree flattened with '/' separators, plus the format
    sentinel; the same file as the JAX package's `save_params`."""
    flat = flatten_params(params)
    flat[NATIVE_FORMAT_KEY] = np.asarray(_NATIVE_FORMAT)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **flat)


def native_params(state_dict: Dict) -> Optional[Dict]:
    """The nested param tree if `state_dict` is a native pre-converted
    artifact (see `save_params`), else None."""
    if NATIVE_FORMAT_KEY not in state_dict:
        return None
    return unflatten_params({k: v for k, v in state_dict.items() if k != NATIVE_FORMAT_KEY})
