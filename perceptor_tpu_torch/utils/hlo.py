"""The collective inventory of a traced program (counterpart of
perceptor_tpu/utils/hlo.py, which reads compiled HLO).

A silent sharding regression, a lost placement that makes every step
gather a full activation, passes every numeric parity test and shows only
in the program's collectives. These functions read them from a traced
torch program: a `torch.export.ExportedProgram`, a `torch.fx.GraphModule`
(`make_fx`, `torch.export`), or the text of its `print_readable()`. Each
`torch.ops._c10d_functional` node is one collective, under JAX's canonical
names:

    all_gather_into_tensor -> all-gather       all_reduce -> all-reduce
    reduce_scatter_tensor  -> reduce-scatter   all_to_all_single -> all-to-all

and an `all_to_all_single` whose split sizes are one-hot (every rank sends
its whole tensor to one peer: the ring's and the pipeline's
`parallel.collectives.shift`) -> collective-permute.

Shapes are the node's output on this rank, as in an SPMD program's HLO. The
bytes of `ici_bytes` / `program_ici_bytes` are those that NCCL moves over
NVLink (or gloo over the host) with bandwidth-optimal ring algorithms, the
same accounting JAX applies to ICI; no TPU link is involved.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

_CANONICAL = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_DTYPES = {
    "float32": "f32", "bfloat16": "bf16", "float16": "f16", "float64": "f64",
    "int64": "s64", "int32": "s32", "int16": "s16", "int8": "s8", "uint8": "u8",
    "bool": "pred",
}

# `name: "f32[2, 8, 512, 64]" = torch.ops._c10d_functional.all_gather_into_tensor.default(x, 2, '0')`
_LINE_RE = re.compile(
    r'(?:"(\w+)\[([0-9, ]*)\]"\s*)?=\s*torch\.ops\._c10d_functional\.(\w+)\.default\((.*)\)')
_LIST_RE = re.compile(r"\[([0-9, ]*)\]")


def _dtype_bytes(dtype: str) -> int:
    """HLO-style element type -> bytes (pred is 1 byte)."""
    if dtype == "pred":
        return 1
    digits = "".join(c for c in dtype if c.isdigit())
    return max(1, int(digits) // 8) if digits else 4


def _one_hot(sizes) -> bool:
    return sizes is not None and sum(1 for s in sizes if s) <= 1


@dataclasses.dataclass
class CollectiveOp:
    """One collective node of a traced program."""

    op: str  # canonical name, e.g. "all-gather"
    shapes: Tuple[Tuple[int, ...], ...]  # output shape(s)
    line: str
    dtypes: Tuple[str, ...] = ()  # element type per shape, aligned
    # ranks per group, where the node says (an all-reduce names its group only)
    group_size: Optional[int] = None

    @property
    def elements(self) -> int:
        """Largest output shape's element count."""
        best = 0
        for shape in self.shapes:
            n = 1
            for d in shape:
                n *= d
            best = max(best, n)
        return best

    @property
    def output_bytes(self) -> int:
        """Largest output shape's byte size."""
        best = 0
        dtypes = self.dtypes or ("f32",) * len(self.shapes)
        for shape, dtype in zip(self.shapes, dtypes):
            n = _dtype_bytes(dtype)
            for d in shape:
                n *= d
            best = max(best, n)
        return best

    def ici_bytes(self, default_group: Optional[int] = None) -> int:
        """Bytes one rank sends for one execution, under ring algorithms
        (JAX's accounting: all-gather out*(n-1)/n, reduce-scatter
        out*(n-1), all-reduce 2*out*(n-1)/n, all-to-all out*(n-1)/n, a
        permute one block)."""
        if self.op == "collective-permute":
            return self.output_bytes
        n = self.group_size or default_group
        if not n or n <= 1:
            return 0
        out = self.output_bytes
        if self.op == "all-gather":
            return out * (n - 1) // n
        if self.op == "reduce-scatter":
            return out * (n - 1)
        if self.op == "all-reduce":
            return 2 * out * (n - 1) // n
        if self.op == "all-to-all":
            return out * (n - 1) // n
        return out


def _from_node(node) -> Optional[CollectiveOp]:
    target = node.target
    if getattr(target, "namespace", None) != "_c10d_functional":
        return None
    name = target._schema.name.split("::")[-1]
    if name not in _CANONICAL:
        return None
    op, groups = _CANONICAL[name], None
    args = node.args
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        groups = int(args[1] if name == "all_gather_into_tensor" else args[2])
    elif name == "all_to_all_single":
        out_splits, in_splits = args[1], args[2]
        if out_splits:
            groups = len(out_splits)
        if out_splits and _one_hot(out_splits) and _one_hot(in_splits):
            op = "collective-permute"
    val = node.meta.get("val")
    shapes, dtypes = (), ()
    if val is not None and hasattr(val, "shape"):
        shapes = (tuple(int(d) for d in val.shape),)
        dtypes = (_DTYPES.get(str(val.dtype).replace("torch.", ""), "f32"),)
    return CollectiveOp(op, shapes, node.format_node(), dtypes, groups)


def _from_line(line: str) -> Optional[CollectiveOp]:
    m = _LINE_RE.search(line)
    if m is None or m.group(3) not in _CANONICAL:
        return None
    dtype, dims, name, args = m.groups()
    op, groups = _CANONICAL[name], None
    lists = [[int(x) for x in body.split(",") if x.strip()] for body in _LIST_RE.findall(args)]
    parts = [a.strip() for a in re.sub(r"\[[^\]]*\]", "L", args).split(",")]
    if name == "all_gather_into_tensor" and len(parts) > 1:
        groups = int(parts[1])
    elif name == "reduce_scatter_tensor" and len(parts) > 2:
        groups = int(parts[2])
    elif name == "all_to_all_single" and len(lists) >= 2:
        groups = len(lists[0]) or None
        if lists[0] and _one_hot(lists[0]) and _one_hot(lists[1]):
            op = "collective-permute"
    shapes = (tuple(int(d) for d in dims.split(",") if d.strip()),) if dims is not None else ()
    return CollectiveOp(op, shapes, line.strip(), (dtype,) if dtype else (), groups)


def collective_inventory(program) -> List[CollectiveOp]:
    """All collective nodes of `program`: an ExportedProgram, a
    GraphModule, or the text of `print_readable()`."""
    if isinstance(program, str):
        return [op for op in map(_from_line, program.splitlines()) if op is not None]
    graph_module = getattr(program, "graph_module", program)
    out = []
    for module in graph_module.modules():
        graph = getattr(module, "graph", None)
        if graph is None:
            continue
        out.extend(op for op in map(_from_node, graph.nodes) if op is not None)
    return out


def collective_counts(program) -> Dict[str, int]:
    """{op name: count} over the program."""
    counts: Dict[str, int] = {}
    for op in collective_inventory(program):
        counts[op.op] = counts.get(op.op, 0) + 1
    return counts


def max_gather_elements(program) -> int:
    """Largest all-gather output in the program (0 when none): a
    re-gathered activation shows here as an activation-sized number."""
    return max((op.elements for op in collective_inventory(program) if op.op == "all-gather"),
               default=0)


def program_ici_bytes(program, default_group: Optional[int] = None) -> Dict[str, int]:
    """Bytes one rank sends per execution of the program, by op kind plus
    a "total" key (each collective node counted once, so trace one step,
    not a loop, to budget per-step bytes)."""
    out: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
    total = 0
    for op in collective_inventory(program):
        b = op.ici_bytes(default_group)
        out[op.op] = out.get(op.op, 0) + b
        total += b
    out["total"] = total
    return out
