"""Raw-tile JPEG datasets: image bags (MIL) and per-tile items (port of
``data/jpg_bags.py``).

The reference's ``JPGMILDataloader`` (``datasets/jpg_dataloader.py:27-360``)
and ``JPGBagLoader`` (``datasets/classic_jpg_dataloader.py:28-542``): slides
are folders ``<cohort>/BLOCKS/<slide>/*.jpg|png``, tile grid coords come
from the ``(x-y)`` file-name suffix, tiles are ImageNet-normalized, and a
train bag is a random subsample of ``max_bag_size`` tiles zero-padded to
that size. :class:`JPGTileDataset` is the classic path's per-tile view
(labels from the slide, the stain-augmentation stack), which the
``tiles`` variant of ``data/datamodule`` gives the classic tile classifiers.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from transmil_deepgraft_tpu_torch.data.coords import normalize_pad_coords
from transmil_deepgraft_tpu_torch.data.tiles import _load_tile, parse_coords
from transmil_deepgraft_tpu_torch.data.transforms import imagenet_normalize, train_augment

TILE_SUFFIXES = (".jpg", ".jpeg", ".png")


class JPGMILDataset:
    """Image-bag MIL dataset: one item = all tiles of a slide."""

    def __init__(
        self,
        file_path: str | Path,
        label_path: str | Path,
        mode: str,
        n_classes: int,
        *,
        slide_patient_path: str | Path | None = None,
        max_bag_size: int = 1000,
        tile_size: int = 224,
        slides: Optional[list[str]] = None,
    ) -> None:
        self.root = Path(file_path)
        self.mode = mode
        self.n_classes = n_classes
        self.max_bag_size = max_bag_size
        self.tile_size = tile_size

        self.slide_patient = None
        if slide_patient_path:
            with open(slide_patient_path) as f:
                self.slide_patient = json.load(f)

        with open(label_path) as f:
            label_json = json.load(f)
        entries = (
            list(label_json.get("train", [])) + list(label_json.get("test_mixin", []))
            if mode == "fine_tune"
            else label_json[mode]
        )
        self.slide_dirs: list[Path] = []
        self.labels: list[int] = []
        self.names: list[str] = []
        self.patients: list[str] = []
        for rel, label in entries:
            name = Path(rel).stem
            if slides is not None and name not in slides:
                continue
            candidates = [self.root / "BLOCKS" / name, self.root / name, Path(rel)]
            d = next((c for c in candidates if c.is_dir()), None)
            if d is None:
                continue
            self.slide_dirs.append(d)
            self.labels.append(int(label))
            self.names.append(name)
            self.patients.append(
                self.slide_patient.get(name, name) if self.slide_patient else name
            )

    def __len__(self) -> int:
        return len(self.slide_dirs)

    def get_labels(self) -> list[int]:
        return list(self.labels)

    def tiles_of(self, index: int) -> list[Path]:
        return sorted(p for p in self.slide_dirs[index].iterdir()
                      if p.suffix.lower() in TILE_SUFFIXES)

    def get_item(self, index: int, rng: np.random.Generator):
        tiles = self.tiles_of(index)
        coords = np.array([parse_coords(p.name) for p in tiles], np.int32)
        train = self.mode in ("train", "fine_tune")
        if train and len(tiles) > self.max_bag_size:
            keep = rng.permutation(len(tiles))[:self.max_bag_size]
            tiles = [tiles[i] for i in keep]
            coords = coords[keep]
        # the bag is made at its padded size, so the zero pad costs no copy
        size = self.tile_size
        rows = max(len(tiles), self.max_bag_size) if train else len(tiles)
        imgs = np.zeros((rows, size, size, 3), np.float32)
        for i, p in enumerate(tiles):
            imgs[i] = imagenet_normalize(_load_tile(p, size))
        if rows > len(tiles):
            # coords stay row-aligned with the padded bag (data/coords.py)
            coords = normalize_pad_coords(coords, rows)
        return imgs, self.labels[index], (self.names[index], coords, self.patients[index])


class JPGTileDataset:
    """Classic per-tile dataset: one item = one (augmented) tile, with its
    slide's label (ref ``classic_jpg_dataloader.py:68-125``)."""

    def __init__(self, bag_dataset: JPGMILDataset, augment: bool = True) -> None:
        self.bags = bag_dataset
        self.augment = augment and bag_dataset.mode in ("train", "fine_tune")
        self.index: list[tuple[int, Path]] = [
            (si, tile) for si in range(len(bag_dataset)) for tile in bag_dataset.tiles_of(si)]

    def __len__(self) -> int:
        return len(self.index)

    def get_labels(self) -> list[int]:
        return [self.bags.labels[si] for si, _ in self.index]

    def get_item(self, i: int, rng: np.random.Generator):
        si, tile_path = self.index[i]
        img = _load_tile(tile_path, self.bags.tile_size)
        if self.augment:
            img = train_augment(img, rng)
        coords = np.array(parse_coords(tile_path.name), np.int32)
        return (imagenet_normalize(img), self.bags.labels[si],
                (self.bags.names[si], coords, self.bags.patients[si]))
