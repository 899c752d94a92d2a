"""Serving artifacts through `torch.export` (counterpart of
perceptor_tpu/utils/serving.py, which uses `jax.export`).

A program is traced once, serialized with `torch.export.save` (a `.pt2`
archive), and loaded in the serving process with no model code: the loaded
`.module()` runs the recorded graph. Tracing is non-strict
(`torch.export.export(strict=False)`), which follows Python as it runs and
so traces `torch.autograd.grad` inside a program (the guided samplers);
Python loops are unrolled into the graph (there is no stable scan), so an
artifact's size grows with its step count.

Weights are not baked in: each exported function takes the wrapper's
tensors as a dict argument and applies its modules through
`torch.func.functional_call`, so one artifact serves any finetune of the
same architecture. A tensor that the function reaches through a closure
instead (a schedule table, a resize matrix) becomes a constant of the
artifact.

The flash kernels are registered ops (`perceptor_tpu_torch::flash_fwd`,
`::flash_dq`, `::flash_dkv`): they stay nodes of the graph, and the
process that loads an artifact holding them must `import
perceptor_tpu_torch` first, which registers them.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Dict, Optional, Sequence

import torch

_SUFFIX = ".pt2"


def module_params(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A module's parameters and buffers by name: the weights argument of
    an exported program."""
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


class _Bound(torch.nn.Module):
    """`fn` as a module, over `modules` as its children."""

    def __init__(self, modules: Dict[str, torch.nn.Module], fn: Callable):
        super().__init__()
        self.parts = torch.nn.ModuleDict(modules)
        self._fn = (fn,)  # not registered as a child when `fn` is a module

    def forward(self, *args):
        return self._fn[0](*args)


def functional(modules: Dict[str, torch.nn.Module], params: Dict[str, Dict[str, torch.Tensor]],
               fn: Callable, *args):
    """`fn(*args)` with each module of `modules` holding the tensors
    `params[name]` in place of its own (`torch.func.functional_call`, so the
    module objects `fn` reaches are the ones rebound). Every parameter and
    buffer must be given: a tensor left out would be baked into an
    exported program."""
    flat = {f"parts.{name}.{key}": value
            for name, tensors in params.items() for key, value in tensors.items()}
    bound = _Bound(modules, fn)
    missing = set(module_params(bound)) - set(flat)
    if missing:
        raise ValueError(f"params lack {sorted(missing)[:5]} (of {len(missing)})")
    return torch.func.functional_call(bound, flat, args)


def _walk(obj, path, modules, tensors, seen, depth):
    """Record the modules and tensors reachable from `obj`'s attributes
    (into containers and the port's own objects, not into modules)."""
    if id(obj) in seen or depth > 6:
        return
    if isinstance(obj, torch.nn.Module):
        seen.add(id(obj))
        modules[path] = obj
        return
    if isinstance(obj, torch.Tensor):
        seen.add(id(obj))
        tensors[path] = obj
        return
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    elif type(obj).__module__.startswith("perceptor_tpu_torch") and hasattr(obj, "__dict__"):
        items = vars(obj).items()
    else:
        return
    seen.add(id(obj))
    for key, value in items:
        _walk(value, f"{path}.{key}" if path else str(key), modules, tensors, seen, depth + 1)


def object_params(obj) -> Dict[str, Dict[str, torch.Tensor]]:
    """The tensors an object of the port reaches through its attributes (a
    loss: its model's modules, its prompt bank): {"modules": {module path:
    {name: tensor}}, "tensors": {attribute path: tensor}}. `call_with`
    rebinds them."""
    modules, tensors = {}, {}
    _walk(obj, "", modules, tensors, set(), 0)
    return {"modules": {path: module_params(m) for path, m in modules.items()},
            "tensors": tensors}


def _attribute_owner(obj, path):
    *parents, last = path.split(".")
    for key in parents:
        obj = obj[int(key) if isinstance(obj, (list, tuple)) else key] \
            if isinstance(obj, (dict, list, tuple)) else getattr(obj, key)
    return obj, last


def call_with(obj, params: Dict[str, Dict[str, torch.Tensor]], fn: Callable, *args):
    """`fn(*args)` with the tensors that `object_params(obj)` lists replaced
    by `params`: module tensors through `torch.func.functional_call`, plain
    tensor attributes set for the call and restored after it."""
    modules, tensors = {}, {}
    _walk(obj, "", modules, tensors, set(), 0)
    if set(params["tensors"]) != set(tensors) or set(params["modules"]) != set(modules):
        raise ValueError("params do not match the object's tensors")
    saved = []
    try:
        for path, value in params["tensors"].items():
            owner, key = _attribute_owner(obj, path)
            if isinstance(owner, dict):
                saved.append((owner, key, owner[key]))
                owner[key] = value
            elif isinstance(owner, list):
                saved.append((owner, int(key), owner[int(key)]))
                owner[int(key)] = value
            else:
                saved.append((owner, key, getattr(owner, key)))
                setattr(owner, key, value)
        keys = {path: f"m{i}" for i, path in enumerate(modules)}
        return functional({keys[p]: m for p, m in modules.items()},
                          {keys[p]: t for p, t in params["modules"].items()}, fn, *args)
    finally:
        for owner, key, value in reversed(saved):
            if isinstance(owner, (dict, list)):
                owner[key] = value
            else:
                setattr(owner, key, value)


def _platform(args) -> Optional[str]:
    for leaf in torch.utils._pytree.tree_leaves(args):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
    return None


def _fake_on(args, device: str):
    """The example arguments as fake tensors on `device` (shapes, dtypes
    and strides kept): the arguments of a cross-platform trace."""
    def fake(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return torch.empty_strided(leaf.shape, leaf.stride(), dtype=leaf.dtype, device=device)
    return torch.utils._pytree.tree_map(fake, args)


def export_program(fn: Callable, *example_args, platforms: Optional[Sequence[str]] = None,
                   grad: bool = False):
    """Trace `fn` at `example_args` and return the
    `torch.export.ExportedProgram`. The trace runs with gradients off
    unless `grad` (a program that takes gradients inside, as the guided
    samplers do): a program whose grad mode never changes holds no
    grad-mode regions, which `torch.export.load` may refuse.

    `platforms=None` exports for the device of the example arguments.
    `platforms=("cuda",)` with CPU arguments traces under
    `FakeTensorMode`, with the arguments as fake CUDA tensors; a program
    that cannot be traced that way (its closures hold CPU tensors, or the
    torch build has no CUDA) raises `NotImplementedError`. Do not trace a
    program that runs the autograd engine this way on a CPU-only build:
    the engine aborts the process on a fake CUDA device
    (`engine.export_guided_sample` refuses first)."""
    with torch.set_grad_enabled(grad):
        return _export(_Bound({}, fn), example_args, platforms, grad)


def _trace(program, args, grad: bool):
    """`torch.export.export(strict=False)`; a program that takes gradients
    is traced below autograd instead (`pre_dispatch=False`): traced above
    it, as `torch.export.export` does, the tensors that autograd saves for
    the backward are unpacked as objects the tracer cannot follow, and the
    program would hold them as constants."""
    if not grad:
        return torch.export.export(program, tuple(args), strict=False)
    from torch.export._trace import _export as export_below_autograd

    return export_below_autograd(program, tuple(args), strict=False, pre_dispatch=False)


def _export(program, example_args, platforms, grad):
    if platforms is None or tuple(platforms) == (_platform(example_args),):
        return _trace(program, example_args, grad)
    if tuple(platforms) != ("cuda",):
        raise NotImplementedError(f"export for {tuple(platforms)} from "
                                  f"{_platform(example_args)} arguments")
    from torch._subclasses.fake_tensor import FakeTensorMode

    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            return _trace(program, _fake_on(example_args, "cuda"), grad)
    except Exception as e:  # the trace met a real CPU tensor or a CUDA-only path
        raise NotImplementedError(
            f"this program cannot be traced for CUDA on a host without it: {e}") from e


def serialize_program(fn: Callable, *example_args, platforms=None, grad: bool = False) -> bytes:
    """`export_program` then `torch.export.save`, as bytes. The example
    arguments, which `torch.export.save` would store beside the graph (the
    weights among them), are left out."""
    program = export_program(fn, *example_args, platforms=platforms, grad=grad)
    program.example_inputs = None
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def load_program(blob: bytes) -> Callable:
    """An artifact's bytes -> a callable of the exported signature (the
    program's `.module()`). Import `perceptor_tpu_torch` before calling, so
    the flash ops the graph holds are registered."""
    return torch.export.load(io.BytesIO(blob)).module()


def input_specs(blob: bytes):
    """The (shape, dtype) of each flattened input the artifact expects, in
    order (weights first where the signature starts with them)."""
    program = torch.export.load(io.BytesIO(blob))
    specs = []
    for spec in program.graph_signature.input_specs:
        if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
            node = next(n for n in program.graph.nodes if n.name == spec.arg.name)
            value = node.meta.get("val")
            if isinstance(value, torch.Tensor):
                specs.append((tuple(value.shape), value.dtype))
            else:
                specs.append((None, type(value)))
    return specs


def save_programs(directory: str, programs: Dict[str, bytes]) -> None:
    """Write `{name: artifact bytes}` as `<directory>/<name>.pt2`."""
    os.makedirs(directory, exist_ok=True)
    for name, blob in programs.items():
        with open(os.path.join(directory, name + _SUFFIX), "wb") as f:
            f.write(blob)


def load_programs(directory: str) -> Dict[str, bytes]:
    """Read every `*.pt2` in `directory` back to bytes."""
    out = {}
    for entry in sorted(os.listdir(directory)):
        if entry.endswith(_SUFFIX):
            with open(os.path.join(directory, entry), "rb") as f:
                out[entry[: -len(_SUFFIX)]] = f.read()
    return out
