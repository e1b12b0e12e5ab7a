"""The coordinate padding contract (counterpart of ``data/coords.py``):
real coords are shifted to a per-axis minimum of 0, then zero-padded, so
that pad rows coincide with the bag's minimum."""

from __future__ import annotations

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
