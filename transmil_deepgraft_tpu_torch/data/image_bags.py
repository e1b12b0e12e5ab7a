"""Legacy raw-image bags: per-slide .hdf5/.h5, .npy or .zarr tile stacks
(port of ``data/image_bags.py``).

The reference's three legacy image-bag loaders behind one reader
(``HDF5MILDataloader``, ``datasets/custom_dataloader.py:32-271``;
``NpyMILDataloader``; ``ZarrMILDataloader``):

- label JSON ``{mode: [[path, label], ...]}``; the slide stem plus a storage
  suffix under ``file_path``; missing files are skipped;
- HDF5 (read by ``utils/h5``) stores one uint8 dataset per tile, or one
  ``images`` dataset; ``.npy``/``.zarr`` an ``(N, H, W, 3)`` uint8 array;
- a bag is a random permutation -> up to ``bag_size`` tiles -> black zero
  pad; train bags draw from the caller's rng, eval bags from a per-slide
  seed;
- train: ONE slide-consistent augmentation draw applied to every tile of
  the bag (the reference's ``iaa.to_deterministic()``), pad tiles left
  black;
- normalization ``(img/255 - 0.5) / 0.5`` -> [-1, 1] (``RangeNormalization``);
- an LRU slide cache (``cache_size``, ref ``data_cache_size=10``).
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np

from transmil_deepgraft_tpu_torch.data.feature_bags import (
    load_label_entries,
    load_slide_patient,
    scan_label_entries,
)
from transmil_deepgraft_tpu_torch.data.transforms import train_augment
from transmil_deepgraft_tpu_torch.utils import h5

_SUFFIXES = (".hdf5", ".h5", ".npy", ".zarr")


def load_image_bag(path: str | Path) -> np.ndarray:
    """A (N, H, W, 3) uint8 tile stack from any supported storage."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".hdf5", ".h5"):
        datasets = h5.read(path)
        if "images" in datasets:  # the consolidated layout
            return np.asarray(datasets["images"], np.uint8)
        if not datasets:
            raise ValueError(f"empty image-bag container: {path}")
        return np.stack([np.asarray(datasets[k], np.uint8) for k in sorted(datasets)])
    if suffix == ".npy":
        return np.load(path).astype(np.uint8)
    if suffix == ".zarr":
        try:
            import zarr
        except ImportError as e:
            raise ImportError(
                "reading .zarr image bags requires the optional 'zarr' package") from e
        return np.asarray(zarr.open(str(path), mode="r")[:], np.uint8)
    raise ValueError(f"unsupported image-bag storage: {path}")


def range_normalize(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (ref RangeNormalization)."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


class ImageBagDataset:
    # black pad tiles normalize to -1; the data module pads eval batches with
    # this value, so that no pad row becomes a mid-grey tile
    pad_value = -1.0

    def __init__(
        self,
        file_path: str | Path,
        label_path: str | Path,
        mode: str,
        n_classes: int,
        *,
        slide_patient_path: str | Path | None = None,
        bag_size: int = 1024,
        augment: bool = True,
        cache_size: int = 10,
    ) -> None:
        self.file_path = Path(file_path)
        self.mode = mode
        self.n_classes = n_classes
        self.bag_size = bag_size
        self.augment = augment
        self.cache_size = cache_size
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.slide_patient = load_slide_patient(slide_patient_path)

        def resolve(rel: str, name: str) -> Path | None:
            return next((c for c in (self.file_path / f"{name}{s}" for s in _SUFFIXES)
                         if c.exists()), None)

        (self.files, self.labels, self.names, self.patients,
         self.missing) = scan_label_entries(
            load_label_entries(label_path, mode), self.slide_patient, resolve)

    def __len__(self) -> int:
        return len(self.files)

    def get_labels(self) -> list[int]:
        return list(self.labels)

    def _load(self, index: int) -> np.ndarray:
        if index in self._cache:
            self._cache.move_to_end(index)
            return self._cache[index]
        bag = load_image_bag(self.files[index])
        self._cache[index] = bag
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return bag

    def get_item(self, index: int,
                 rng: np.random.Generator) -> tuple[np.ndarray, int, tuple[str, np.ndarray, str]]:
        tiles = self._load(index)
        n = tiles.shape[0]
        train = self.mode in ("train", "fine_tune")
        if train:
            idx = rng.permutation(n)[:self.bag_size]
        else:
            idx = np.random.RandomState(0).permutation(n)[:self.bag_size]
        bag = tiles[idx]
        if train and self.augment:
            # every tile gets an identically seeded rng (the reference's
            # iaa.to_deterministic bag-wide); before the pad, which stays black
            tile_seed = int(rng.integers(2**31))
            bag = np.stack([train_augment(t, np.random.default_rng(tile_seed)) for t in bag])
        if bag.shape[0] < self.bag_size:
            pad = np.zeros((self.bag_size - bag.shape[0], *bag.shape[1:]), np.uint8)
            bag = np.concatenate([bag, pad], axis=0)
        # image bags carry no grid coordinates: zero placeholders over the
        # padded bag keep per-tile exports aligned with the rows the model sees
        coords = np.zeros((bag.shape[0], 2), np.int32)
        return range_normalize(bag), self.labels[index], (self.names[index], coords,
                                                          self.patients[index])

    def __getitem__(self, index: int):
        return self.get_item(index, np.random.default_rng())
