"""Spherical-distance loss pieces (counterpart of
perceptor_tpu/losses/prompt_bank.py:24-31)."""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True), min=eps)


def spherical_distance_squared(encodings_a, encodings_b) -> torch.Tensor:
    """Pairwise (arcsin(|a-b|/2))^2 * 2, shape (len(a), len(b))."""
    diff_norm = torch.linalg.norm(encodings_a[:, None] - encodings_b[None, :], dim=2)
    return torch.square(torch.arcsin(torch.clamp(diff_norm / 2, 0.0, 1.0))) * 2
