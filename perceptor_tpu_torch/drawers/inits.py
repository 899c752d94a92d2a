"""Raw drawer init helpers: Perlin fractal noise and linear gradients (a
copy of perceptor_tpu/drawers/inits.py).

Host-side numpy, used at init time only, with explicit seeds: the arrays
equal the JAX package's for the same shape and seed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _interpolant(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def generate_perlin_noise_2d(
    shape: Tuple[int, int],
    res: Tuple[int, int],
    rng: np.random.Generator,
    tileable=(False, False),
) -> np.ndarray:
    delta = (res[0] / shape[0], res[1] / shape[1])
    d = (shape[0] // res[0], shape[1] // res[1])
    grid = (
        np.mgrid[0 : res[0] : delta[0], 0 : res[1] : delta[1]].transpose(1, 2, 0) % 1
    )
    angles = 2 * np.pi * rng.random((res[0] + 1, res[1] + 1))
    gradients = np.dstack((np.cos(angles), np.sin(angles)))
    if tileable[0]:
        gradients[-1, :] = gradients[0, :]
    if tileable[1]:
        gradients[:, -1] = gradients[:, 0]
    gradients = gradients.repeat(d[0], 0).repeat(d[1], 1)
    g00 = gradients[: -d[0], : -d[1]]
    g10 = gradients[d[0] :, : -d[1]]
    g01 = gradients[: -d[0], d[1] :]
    g11 = gradients[d[0] :, d[1] :]
    n00 = np.sum(np.dstack((grid[:, :, 0], grid[:, :, 1])) * g00, 2)
    n10 = np.sum(np.dstack((grid[:, :, 0] - 1, grid[:, :, 1])) * g10, 2)
    n01 = np.sum(np.dstack((grid[:, :, 0], grid[:, :, 1] - 1)) * g01, 2)
    n11 = np.sum(np.dstack((grid[:, :, 0] - 1, grid[:, :, 1] - 1)) * g11, 2)
    t = _interpolant(grid)
    n0 = n00 * (1 - t[:, :, 0]) + t[:, :, 0] * n10
    n1 = n01 * (1 - t[:, :, 0]) + t[:, :, 0] * n11
    return np.sqrt(2) * ((1 - t[:, :, 1]) * n0 + t[:, :, 1] * n1)


def generate_fractal_noise_2d(
    shape, res, rng, octaves=1, persistence=0.5, lacunarity=2, tileable=(False, False)
) -> np.ndarray:
    noise = np.zeros(shape)
    frequency = 1
    amplitude = 1.0
    for _ in range(octaves):
        noise += amplitude * generate_perlin_noise_2d(
            shape, (frequency * res[0], frequency * res[1]), rng, tileable
        )
        frequency *= lacunarity
        amplitude *= persistence
    return noise


def _normalize(data):
    return (data - np.min(data)) / (np.max(data) - np.min(data))


def _contrast_noise(n):
    # contrast curve, reference fractal.py:102-108
    n = 0.9998 * n + 0.0001
    n1 = n / (1 - n)
    n2 = np.power(n1, -2)
    return 1 / (1 + n2)


def fractal(shape, seed: Optional[int] = None) -> np.ndarray:
    """Octaved-Perlin fractal init (reference fractal.py:110-138)."""
    n, c, h, w = shape
    rng = np.random.default_rng(seed)
    if w > 1024 or h > 1024:
        side, octaves = 2048, 6
    elif w > 512 or h > 512:
        side, octaves = 1024, 5
    elif w > 256 or h > 256:
        side, octaves = 512, 4
    else:
        side, octaves = 256, 3
    return np.stack(
        [
            np.stack(
                [
                    _contrast_noise(
                        _normalize(
                            generate_fractal_noise_2d(
                                (side, side), (32, 32), rng, octaves
                            )
                        )
                    )[:h, :w]
                    for _ in range(c)
                ]
            )
            for _ in range(n)
        ]
    ).astype(np.float32)


def _gradient_2d(start, stop, width, height, is_horizontal):
    if is_horizontal:
        return np.tile(np.linspace(start, stop, width), (height, 1))
    return np.tile(np.linspace(start, stop, height), (width, 1)).T


def gradient(shape, seed: Optional[int] = None) -> np.ndarray:
    """Random 3-channel linear gradient init (reference gradient.py:23-50)."""
    n, c, h, w = shape
    if c != 3:
        raise ValueError("Only 3 channel images are supported.")
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n):
        starts = (0, 0, rng.integers(0, 255))
        stops = (rng.integers(1, 255), rng.integers(2, 255), rng.integers(3, 128))
        horizontals = (True, False, False)
        channels = [
            _gradient_2d(s0, s1, w, h, hz) / 255
            for s0, s1, hz in zip(starts, stops, horizontals)
        ]
        batches.append(np.stack(channels))
    return np.stack(batches).astype(np.float32)
