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
from typing import Callable, Dict, Iterable, Optional

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
    name's own suffix or each of `PORT_SUFFIX` (the port's own artifacts)
    and `_SUFFIXES`."""
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
                else [os.path.join(cache_dir, name + sfx) for sfx in (PORT_SUFFIX, *_SUFFIXES)]
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


# -- the port's own artifacts and the discovery loader ----------------------

# The port's converter writes `<canonical basename>.torch.pt`: torch.save of
# {PORT_FORMAT_KEY: PORT_FORMAT, "modules": {name: state_dict}} in the
# modules' own names and dtypes. The JAX package's `find_checkpoint` tries a
# name as it stands or with one of `_SUFFIXES`, so it never finds this file
# in the cache directories the two packages share.
PORT_SUFFIX = ".torch.pt"
PORT_FORMAT_KEY = "__perceptor_tpu_torch_format__"
PORT_FORMAT = "state-dicts-v1"


def save_port_artifact(path: str, modules: Dict[str, torch.nn.Module]) -> str:
    """Write the state dicts of `modules` as a port artifact at `path`
    (`PORT_SUFFIX` appended when missing); returns the path written."""
    if not path.endswith(PORT_SUFFIX):
        path += PORT_SUFFIX
    torch.save({PORT_FORMAT_KEY: PORT_FORMAT,
                "modules": {name: m.state_dict() for name, m in modules.items()}}, path)
    return path


def _port_artifact(path: str) -> Optional[Dict]:
    if not path.endswith(PORT_SUFFIX):
        return None
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and obj.get(PORT_FORMAT_KEY) == PORT_FORMAT):
        raise ValueError(f"{path} is not a {PORT_FORMAT} artifact of the port")
    return obj["modules"]


def strip_prefix(state_dict: Dict, prefix: str) -> Dict:
    """The entries under `prefix`, with it removed."""
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _exact(state_dict: Dict, modules: Dict[str, torch.nn.Module]) -> Optional[Dict]:
    """`state_dict` split by module when its keys are exactly the modules'
    (a single module's own keys, or `<name>.<key>` for several), else None."""
    if len(modules) == 1:
        (name, module), = modules.items()
        return {name: state_dict} if set(state_dict) == set(module.state_dict()) else None
    wanted = {f"{name}.{key}" for name, m in modules.items() for key in m.state_dict()}
    if set(state_dict) != wanted:
        return None
    return {name: {key[len(name) + 1:]: value for key, value in state_dict.items()
                   if key.startswith(name + ".")} for name in modules}


def load_found(path: str, modules: Dict[str, torch.nn.Module],
               from_jax: Optional[Callable[[Dict], Dict[str, Dict]]] = None,
               from_upstream: Optional[Callable[[Dict], None]] = None) -> str:
    """Load the checkpoint `find_checkpoint` found into `modules` ({name:
    module}) and return the route taken:

    - "port": an artifact of the port's converter, loaded as it stands;
    - "params-v1": the JAX package's pre-converted artifact
      (`native_params`), through `from_jax(params) -> {name: state_dict}`;
    - "exact": a state dict whose keys are exactly the modules';
    - "upstream": anything else, handed to `from_upstream(state_dict)`, the
      wrapper's loader of the upstream layout (its key maps).

    Every module load is `strict`; each module keeps its storage dtypes."""
    states = _port_artifact(path)
    route = "port"
    if states is None:
        state_dict = load_state_dict(path)
        native = native_params(state_dict)
        if native is not None:
            if from_jax is None:
                raise ValueError(f"{path}: this wrapper reads no params-v1 artifact")
            states, route = from_jax(native), "params-v1"
        else:
            states, route = _exact(state_dict, modules), "exact"
            if states is None:
                if from_upstream is None:
                    raise ValueError(f"{path}: its keys are not the module's and this "
                                     "wrapper has no key map")
                from_upstream(state_dict)
                return "upstream"
    for name, module in modules.items():
        module.load_state_dict(states[name], strict=True)
    return route
