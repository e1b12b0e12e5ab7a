"""Camelyon16: fold CSVs + per-slide ``.pt`` feature tensors (port of
``data/camelyon.py``; the reference's ``CamelData``,
``datasets/camel_data.py:10-56``).

``fold{F}.csv`` has train/train_label, val/val_label, test/test_label
columns of slide ids after an index column; the features of a slide are
``<data_dir>/<slide_id>.pt``. Slides are their own patients. The CSV is
read with the standard library's ``csv`` module, as ``pandas.read_csv(...,
index_col=0)`` reads it for slide ids that are not numbers: a column's
empty and NA cells are dropped, labels are read as numbers.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from transmil_deepgraft_tpu_torch.data.coords import normalize_pad_coords
from transmil_deepgraft_tpu_torch.data.feature_bags import load_bag_file

# the cells pandas.read_csv reads as missing by default
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})


def read_fold_columns(path: str | Path) -> dict[str, list[str]]:
    """The columns of a fold CSV after its index column, each without its
    missing cells."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0][1:]
    columns: dict[str, list[str]] = {name: [] for name in header}
    for row in rows[1:]:
        for name, cell in zip(header, row[1:]):
            if cell not in NA_VALUES:
                columns[name].append(cell)
    return columns


class CamelyonDataset:
    def __init__(
        self,
        data_dir: str | Path,
        csv_dir: str | Path,
        mode: str,
        fold: int = 0,
        *,
        max_bag_size: int = 0,  # 0: full bags (the reference's)
        shuffle: bool = False,
    ) -> None:
        self.data_dir = Path(data_dir)
        self.mode = "val" if mode == "fine_tune" else mode
        self.max_bag_size = max_bag_size
        self.shuffle = shuffle
        columns = read_fold_columns(Path(csv_dir) / f"fold{fold}.csv")
        col = {"train": "train", "val": "val", "test": "test"}[self.mode]
        self.names = list(columns[col])
        self.labels = [int(float(v)) for v in columns[f"{col}_label"]]

    def __len__(self) -> int:
        return len(self.names)

    def get_labels(self) -> list[int]:
        return list(self.labels)

    def get_item(self, index: int, rng: np.random.Generator):
        name = self.names[index]
        feats, coords = load_bag_file(self.data_dir / f"{name}.pt")
        if self.shuffle:
            order = rng.permutation(feats.shape[0])
            feats, coords = feats[order], coords[order]
        if self.max_bag_size and self.mode == "train":
            idx = rng.permutation(feats.shape[0])[:self.max_bag_size]
            feats, coords = feats[idx], coords[idx]
            if feats.shape[0] < self.max_bag_size:
                pad = np.zeros((self.max_bag_size - feats.shape[0], feats.shape[1]), np.float32)
                feats = np.concatenate([feats, pad])
                # coords stay row-aligned with the padded bag (data/coords.py)
                coords = normalize_pad_coords(coords, feats.shape[0])
        return feats, self.labels[index], (name, coords, name)
