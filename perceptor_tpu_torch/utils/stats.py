"""Training statistics (counterpart of perceptor_tpu/utils/stats.py).

StyleGAN3's `torch_utils/training_stats.py` keeps global per-name counters
`[num, sum, sum_of_squares]`; the JAX package made the counters data, and
so does the port:

- a stats **bag** is a plain `{name: Moments}` dict; `report(bag, name,
  values)` returns a new bag, so a step can carry its statistics without
  global state;
- the moments are float64 tensors on the values' device (no host
  read-back while reporting): the std is sqrt(E[x^2] - E[x]^2), which in
  fp32 sums loses about six digits where the mean is ten times the std
  (the JAX package keeps fp32 sums, the upstream's `_reduce_dtype`);
- `all_reduce(bag, group=None)` sums a bag over the processes of a
  `torch.distributed` group when one is initialized (JAX's `axis_sum` over
  a mesh axis), and is the identity otherwise;
- the host-side `Collector` keeps the upstream ergonomics and delta
  semantics (regex filter, `update()` windows, `keep_previous`,
  `num`/`mean`/`std`/`as_dict`) over float64 accumulation on the host.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Moments:
    """`[num, sum, sum_of_squares]` of one statistic, float64 tensors; the
    windows' differences are taken on the host in `Collector`."""

    count: torch.Tensor
    total: torch.Tensor
    total_sq: torch.Tensor

    @classmethod
    def zero(cls, device=None) -> "Moments":
        z = torch.zeros((), dtype=torch.float64, device=device)
        return cls(count=z, total=z, total_sq=z)

    def add(self, values) -> "Moments":
        """Accumulate any number of scalars (any shape; flattened)."""
        v = torch.as_tensor(values, dtype=torch.float32, device=self.count.device)
        v = v.reshape(-1).double()  # the values as fp32, as JAX's; their sums in float64
        return Moments(
            count=self.count + v.numel(),
            total=self.total + v.sum(),
            total_sq=self.total_sq + v.square().sum(),
        )

    def merge(self, other: "Moments") -> "Moments":
        return Moments(
            count=self.count + other.count,
            total=self.total + other.total,
            total_sq=self.total_sq + other.total_sq,
        )


def zeros(names, device=None) -> dict:
    """A fresh bag holding `names`."""
    return {name: Moments.zero(device) for name in names}


def _device_of(values):
    return values.device if isinstance(values, torch.Tensor) else None


def report(bag: dict, name: str, values) -> dict:
    """`values` accumulated under `name`; returns a new bag."""
    out = dict(bag)
    out[name] = bag.get(name, Moments.zero(_device_of(values))).add(values)
    return out


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def report0(bag: dict, name: str, values) -> dict:
    """`report` on process 0 only; other processes keep the name present
    so every bag has the same names."""
    if _rank() != 0:
        out = dict(bag)
        out.setdefault(name, Moments.zero(_device_of(values)))
        return out
    return report(bag, name, values)


def merge(a: dict, b: dict) -> dict:
    """Union of two bags (the moments of shared names add)."""
    out = dict(a)
    for name, m in b.items():
        out[name] = out[name].merge(m) if name in out else m
    return out


def all_reduce(bag: dict, group=None) -> dict:
    """The bag summed over the processes of `group` (the default group when
    None) when `torch.distributed` is initialized, else the bag itself.
    Every process must hold the same names (in any order)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return bag
    names = sorted(bag)
    if not names:
        return bag
    stacked = torch.stack([
        torch.stack([bag[n].count, bag[n].total, bag[n].total_sq]) for n in names])
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
    return {n: Moments(*row.unbind()) for n, row in zip(names, stacked)}


def _np_moments(m: Moments) -> np.ndarray:
    values = torch.stack([m.count, m.total, m.total_sq]).detach().cpu()
    return values.numpy().astype(np.float64)


class Collector:
    """Host-side view over bags reported between two `update()` calls:
    `update(bag)` snapshots the cumulative counters and exposes the delta
    since the previous `update()` through `num`/`mean`/`std`/`as_dict`;
    with `keep_previous` (the default) a statistic that received nothing
    this window keeps its previous values. The bag is passed explicitly;
    it is read back to the host once per `update()`."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._cumulative: dict = {}
        self._moments: dict = {}

    def names(self):
        return [name for name in self._cumulative if self._regex.fullmatch(name)]

    def _totals(self, bags) -> dict:
        totals: dict = {}
        for bag in bags:
            for name, m in bag.items():
                if self._regex.fullmatch(name):
                    totals[name] = totals.get(name, 0.0) + _np_moments(m)
        return totals

    def update(self, *bags: dict) -> None:
        """Fold bags of cumulative totals in: each name's window is its
        total minus the total at the previous `update()`."""
        if not self._keep_previous:
            self._moments.clear()
        for name, cumulative in self._totals(bags).items():
            delta = cumulative - self._cumulative.get(name, np.zeros(3, np.float64))
            self._cumulative[name] = cumulative
            if delta[0] != 0:
                self._moments[name] = delta

    def add(self, *bags: dict) -> None:
        """Fold bags in as window deltas directly (a fresh bag per window,
        e.g. one that started from `zeros`)."""
        if not self._keep_previous:
            self._moments.clear()
        for name, delta in self._totals(bags).items():
            self._cumulative[name] = self._cumulative.get(name, np.zeros(3, np.float64)) + delta
            if delta[0] != 0:
                self._moments[name] = delta

    def _get_delta(self, name) -> np.ndarray:
        assert self._regex.fullmatch(name)
        return self._moments.get(name, np.zeros(3, np.float64))

    def num(self, name) -> int:
        return int(self._get_delta(name)[0])

    def mean(self, name) -> float:
        delta = self._get_delta(name)
        if int(delta[0]) == 0:
            return float("nan")
        return float(delta[1] / delta[0])

    def std(self, name) -> float:
        """Population std over the window."""
        delta = self._get_delta(name)
        if int(delta[0]) == 0 or not np.isfinite(delta[1]):
            return float("nan")
        if int(delta[0]) == 1:
            return 0.0
        mean = delta[1] / delta[0]
        raw_var = delta[2] / delta[0]
        return float(np.sqrt(max(raw_var - mean * mean, 0.0)))

    def as_dict(self) -> dict:
        return {name: {"num": self.num(name), "mean": self.mean(name), "std": self.std(name)}
                for name in self.names()}

    def __getitem__(self, name) -> float:
        return self.mean(name)
