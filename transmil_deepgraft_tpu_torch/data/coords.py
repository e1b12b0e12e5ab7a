"""The coordinate padding contract (counterpart of ``data/coords.py``):
real coords are shifted to a per-axis minimum of 0, then zero-padded, so
that pad rows coincide with the bag's minimum; and the square-grid
fallback for bags without coordinates."""

from __future__ import annotations

import math

import numpy as np


def normalize_pad_coords(coords: np.ndarray, target: int) -> np.ndarray:
    """(n, 2) real coords -> (target, 2) float32: per-axis min subtracted,
    zero rows appended (or the first ``target`` rows kept if n > target)."""
    c = np.asarray(coords, np.float32)
    if len(c):
        c = c - c.min(axis=0)
    if c.shape[0] >= target:
        return c[:target]
    return np.concatenate([c, np.zeros((target - c.shape[0], 2), np.float32)], axis=0)


def grid_coords(n: int, batch: int = 1) -> np.ndarray:
    """Row-major (x, y) positions on the ``ceil(sqrt(n))`` square grid, the
    fallback coord-aware heads use for bags without coordinates.
    (batch, n, 2) float32."""
    side = max(int(math.ceil(math.sqrt(max(n, 1)))), 1)
    idx = np.arange(n)
    xy = np.stack([idx % side, idx // side], axis=-1).astype(np.float32)
    return np.broadcast_to(xy[None], (batch, n, 2)).copy()
