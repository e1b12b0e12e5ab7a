"""Spatial feature volumes for the CTMIL and spatial-ResNet heads (port of
``data/local_features.py``).

The reference's ``LocalFeatureBagLoader``
(``datasets/local_feature_dataloader.py:28-493``): a slide's
``window x window`` crop of its tile grid, each tile's feature vector
scattered at its (x, y) grid position -> a (window, window, D) volume (NHWC).
The crop is drawn from the numpy ``Generator`` in train mode and centred
otherwise; the draws are JAX's, so a seed gives the same volumes byte for
byte.
"""

from __future__ import annotations

import numpy as np

from transmil_deepgraft_tpu_torch.data.feature_bags import FeatureBagDataset


class LocalFeatureBagDataset(FeatureBagDataset):
    def __init__(self, *args, window: int = 50, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.window = window

    def get_item(self, index: int, rng: np.random.Generator):
        feats, coords = self._load(index)
        coords = np.asarray(coords, np.int64)
        w = self.window
        x_max = int(coords[:, 0].max()) if len(coords) else 0
        y_max = int(coords[:, 1].max()) if len(coords) else 0
        if self.mode in ("train", "fine_tune"):
            x0 = int(rng.integers(0, max(x_max - w + 2, 1)))
            y0 = int(rng.integers(0, max(y_max - w + 2, 1)))
        else:
            x0 = max((x_max + 1 - w) // 2, 0)
            y0 = max((y_max + 1 - w) // 2, 0)

        volume = np.zeros((w, w, feats.shape[1]), np.float32)
        inside = ((coords[:, 0] >= x0) & (coords[:, 0] < x0 + w)
                  & (coords[:, 1] >= y0) & (coords[:, 1] < y0 + w))
        sel = np.nonzero(inside)[0]
        volume[coords[sel, 1] - y0, coords[sel, 0] - x0] = feats[sel]
        return volume, self.labels[index], (self.names[index], coords[sel], self.patients[index])
