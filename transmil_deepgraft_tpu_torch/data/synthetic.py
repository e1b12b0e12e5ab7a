"""Synthetic feature-bag dataset for tests and benchmarks (a copy of the JAX
package's ``data/synthetic.py``; numpy only).

Equivalent of the reference's ``CustomImageDataset`` harness
(``code/sustainability_test.py:29-49``): random bags of configurable
bag_size/feature_size with random labels, enabling every model and the full
train/eval loop to run without data. Labels get a small class-dependent mean
shift so learning curves are non-trivial in tests.
"""

from __future__ import annotations

import numpy as np


class SyntheticBagDataset:
    def __init__(
        self,
        n_slides: int = 32,
        bag_size: int = 512,
        feature_size: int = 2048,
        n_classes: int = 2,
        seed: int = 0,
        signal: float = 0.5,
        variable_bags: bool = True,
        n_patients: int | None = None,
    ) -> None:
        rng = np.random.default_rng(seed)
        self.n_classes = n_classes
        self.feature_size = feature_size
        self._bags: list[np.ndarray] = []
        self.labels: list[int] = []
        self._names: list[str] = []
        self._patients: list[str] = []
        self._coords: list[np.ndarray] = []
        n_patients = n_patients or max(1, n_slides // 2)
        for i in range(n_slides):
            label = int(rng.integers(n_classes))
            n = int(bag_size if not variable_bags else rng.integers(bag_size // 2, bag_size + 1))
            feats = rng.standard_normal((n, feature_size), dtype=np.float32)
            # class signal on a random subset of instances (MIL assumption)
            witness = rng.random(n) < 0.2
            direction = np.zeros(feature_size, np.float32)
            direction[label :: n_classes] = signal
            feats[witness] += direction
            side = int(np.ceil(np.sqrt(n)))
            coords = np.stack(np.unravel_index(np.arange(n), (side, side)), axis=1).astype(np.int32)
            self._bags.append(feats)
            self.labels.append(label)
            self._names.append(f"slide_{i:04d}")
            self._patients.append(f"patient_{i % n_patients:04d}")
            self._coords.append(coords)

    def __len__(self) -> int:
        return len(self._bags)

    def get_labels(self) -> list[int]:
        return list(self.labels)

    def __getitem__(self, index: int):
        return (
            self._bags[index],
            self.labels[index],
            (self._names[index], self._coords[index], self._patients[index]),
        )
