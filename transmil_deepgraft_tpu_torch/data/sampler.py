"""Inverse-class-frequency weighted sampling (a copy of the JAX
package's ``data/sampler.py``; numpy only).

Equivalent of the reference's ``ImbalancedDatasetSampler`` usage for feature
training/val loaders (``code/datasets/data_interface.py:217-231,263-277``):
each epoch draws len(dataset) indices with replacement, with per-sample weight
proportional to 1 / class frequency.
"""

from __future__ import annotations

import numpy as np


class ImbalancedSampler:
    def __init__(self, labels: list[int], n_classes: int) -> None:
        labels_arr = np.asarray(labels)
        counts = np.bincount(labels_arr, minlength=n_classes).astype(np.float64)
        counts[counts == 0] = 1.0
        per_class = len(labels_arr) / counts
        per_class /= per_class.sum()
        self.weights = per_class[labels_arr]
        self.weights /= self.weights.sum()
        self.n = len(labels_arr)

    def sample_epoch(self, rng: np.random.Generator) -> np.ndarray:
        return rng.choice(self.n, size=self.n, replace=True, p=self.weights)
