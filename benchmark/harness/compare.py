"""The measures of the comparison with the reference, and the verdict.

Every measure is a worst case over what was compared, in float64; a shape
that differs from the reference's, or a value that is not finite, reads
infinite.
"""

from __future__ import annotations

import math

import torch


def _pair(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double().to(torch.as_tensor(a).device)
    if a.shape != b.shape:
        return None
    return a, b


def rel_err(a, b) -> float:
    """Largest over the leading (batch) index of |a - b| / |b|, L2 norms."""
    pair = _pair(a, b)
    if pair is None:
        return math.inf
    a, b = (t.reshape(t.shape[0], -1) if t.ndim > 1 else t.reshape(1, -1) for t in pair)
    err = torch.linalg.norm(a - b, dim=1) / torch.clamp(torch.linalg.norm(b, dim=1), min=1e-30)
    value = float(err.max())
    return value if math.isfinite(value) else math.inf


def max_err(a, b) -> float:
    """Largest |a - b| over every element."""
    pair = _pair(a, b)
    if pair is None:
        return math.inf
    value = float((pair[0] - pair[1]).abs().max())
    return value if math.isfinite(value) else math.inf


def verdict(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit; a limit without a value
    reads infinite."""
    return {name: {"value": float(values.get(name, math.inf)), "limit": limit}
            for name, limit in limits.items()}


def correct(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
