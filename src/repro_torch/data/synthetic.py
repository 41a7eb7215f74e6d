"""Synthetic operators for the examples and the card checks, numpy only.

``synthetic_leadfield`` is the reference's MEG stand-in
(``benchmarks/common.py``): the port keeps its own copy, since it imports
nothing of the JAX package or its benchmarks.
"""
from __future__ import annotations

import numpy as np


def synthetic_leadfield(m: int, n: int, seed: int = 0) -> np.ndarray:
    """A MEG-like gain matrix ``(m, n)`` f32: sensors on a spherical cap,
    dipoles in a shell with random orientations, 1/r² falloff, max |g| = 1."""
    rng = np.random.default_rng(seed)
    phi, theta = rng.uniform(0, 2 * np.pi, m), rng.uniform(0, 0.45 * np.pi, m)
    sensors = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], 1)
    r = rng.uniform(0.5, 0.85, n) ** (1 / 3) * 0.85
    sp, st = rng.uniform(0, 2 * np.pi, n), np.arccos(rng.uniform(-1, 1, n))
    sources = r[:, None] * np.stack([np.sin(st) * np.cos(sp), np.sin(st) * np.sin(sp), np.cos(st)], 1)
    moments = rng.standard_normal((n, 3))
    moments /= np.linalg.norm(moments, axis=1, keepdims=True)
    diff = sensors[:, None, :] - sources[None, :, :]
    gain = np.einsum("mns,ns->mn", diff, moments) / (np.linalg.norm(diff, axis=-1) ** 3 + 1e-3)
    return (gain / np.abs(gain).max()).astype(np.float32)
