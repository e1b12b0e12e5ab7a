"""On-the-fly whole-slide tiling (port of ``data/wsi.py``; the reference's
MONAI pipeline, ``datasets/monai_loader.py:1-180``: ``LoadImaged(WSIReader)``
+ ``(Rand)GridPatchd`` + a datalist JSON).

Grid patches are cut on the host from any PIL-readable image; a saturation
threshold drops background patches. OpenSlide is used for pyramidal slides
when it is installed (it is imported only when a slide is opened).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from transmil_deepgraft_tpu_torch.data.transforms import imagenet_normalize


class PILSlideReader:
    """Whole-image reader over PIL (sufficient for exported region PNGs/JPEGs
    and non-pyramidal TIFFs)."""

    def __init__(self, path: str | Path) -> None:
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None  # trusted local data
        self._img = Image.open(path).convert("RGB")
        self.dimensions = self._img.size  # (W, H)

    def read_region(self, xy: tuple[int, int], size: tuple[int, int]) -> np.ndarray:
        x, y = xy
        w, h = size
        return np.asarray(self._img.crop((x, y, x + w, y + h)), np.uint8)


def open_slide(path: str | Path):
    """OpenSlide if importable, else the PIL reader."""
    try:
        import openslide

        class _OS:
            def __init__(self, p):
                self._s = openslide.OpenSlide(str(p))
                self.dimensions = self._s.dimensions

            def read_region(self, xy, size):
                return np.asarray(self._s.read_region(xy, 0, size).convert("RGB"), np.uint8)

        return _OS(path)
    except ImportError:
        return PILSlideReader(path)


def tissue_fraction(patch: np.ndarray, sat_threshold: float = 0.07) -> float:
    """Fraction of pixels whose HSV saturation exceeds the threshold (cheap
    background filter; the MONAI pipeline's foreground selection)."""
    rgb = patch.astype(np.float32) / 255.0
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    sat = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-6), 0.0)
    return float((sat > sat_threshold).mean())


def grid_patches(
    reader,
    patch_size: int = 224,
    stride: Optional[int] = None,
    min_tissue: float = 0.1,
    max_patches: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[tuple[np.ndarray, tuple[int, int]]]:
    """Yield (patch, (grid_x, grid_y)) over the slide grid (GridPatchd); with
    ``rng`` set and ``max_patches`` > 0, sample a random subset (RandGridPatchd)."""
    stride = stride or patch_size
    w, h = reader.dimensions
    xs = range(0, w - patch_size + 1, stride)
    ys = range(0, h - patch_size + 1, stride)
    positions = [(x, y) for y in ys for x in xs]
    if rng is not None and max_patches and len(positions) > max_patches:
        positions = [positions[i] for i in rng.permutation(len(positions))[:max_patches]]
    count = 0
    for x, y in positions:
        patch = reader.read_region((x, y), (patch_size, patch_size))
        if min_tissue and tissue_fraction(patch) < min_tissue:
            continue
        yield patch, (x // stride, y // stride)
        count += 1
        if max_patches and rng is None and count >= max_patches:
            return


class WSIDataset:
    """Datalist-JSON driven slide dataset (the ``monai_test.json`` format:
    ``{"training": [{"image": path, "label": l}, ...]}``); items are (bag of
    normalized patches, label, (name, coords, patient))."""

    def __init__(
        self,
        datalist_path: str | Path,
        section: str = "training",
        *,
        patch_size: int = 224,
        max_patches: int = 1000,
        min_tissue: float = 0.1,
        root: str | Path | None = None,
    ) -> None:
        with open(datalist_path) as f:
            datalist = json.load(f)
        self.items = datalist[section]
        self.patch_size = patch_size
        self.max_patches = max_patches
        self.min_tissue = min_tissue
        self.root = Path(root) if root else Path(datalist_path).parent

    def __len__(self) -> int:
        return len(self.items)

    def get_labels(self) -> list[int]:
        return [int(i["label"]) for i in self.items]

    def get_item(self, index: int, rng: np.random.Generator):
        item = self.items[index]
        path = self.root / item["image"]
        reader = open_slide(path)
        patches, coords = [], []
        for patch, xy in grid_patches(
            reader, self.patch_size, min_tissue=self.min_tissue,
            max_patches=self.max_patches, rng=rng,
        ):
            patches.append(imagenet_normalize(patch))
            coords.append(xy)
        if not patches:  # fully background slide: keep one patch so shapes hold
            patch = reader.read_region((0, 0), (self.patch_size, self.patch_size))
            patches = [imagenet_normalize(patch)]
            coords = [(0, 0)]
        name = Path(item["image"]).stem
        return (
            np.stack(patches),
            int(item["label"]),
            (name, np.asarray(coords, np.int32), item.get("patient", name)),
        )
