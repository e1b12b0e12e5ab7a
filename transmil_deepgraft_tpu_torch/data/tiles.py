"""Tile files on disk: names, pixels, normalization (the port's copy of the
file helpers of ``data/jpg_bags.py``; the normalization is
``data/transforms.py``'s).

Slides are folders of tile images named with the reference's ``(x-y)`` grid
suffix (``tile_(12-7).jpg``). Tiles decode to raw uint8 RGB; ImageNet
normalization happens on the device for the slide path (4x fewer bytes cross
to the card) and on the host here for calibration tiles.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from transmil_deepgraft_tpu_torch.data.transforms import (  # noqa: F401  (re-exported)
    IMAGENET_MEAN,
    IMAGENET_STD,
    imagenet_normalize,
)

COORD_RE = re.compile(r"\((\d+)-(\d+)\)")


def parse_coords(filename: str) -> tuple[int, int]:
    """Tile grid coords from the ``(x-y)`` filename convention; (0, 0) when
    the name has none."""
    m = COORD_RE.search(filename)
    return (int(m.group(1)), int(m.group(2))) if m else (0, 0)


def _load_tile(path: str | Path, size: int = 224) -> np.ndarray:
    """One tile file -> (size, size, 3) uint8 RGB with PIL; resized (PIL's
    default filter) only when the stored size differs."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size))
    return np.asarray(img, np.uint8)
