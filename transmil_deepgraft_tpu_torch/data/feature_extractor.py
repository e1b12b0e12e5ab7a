"""Offline feature extraction: tiles -> backbone embeddings -> per-slide HDF5
(port of ``data/feature_extractor.py``).

The reference's ``datasets/feature_extractor.py:64-237``: every slide of a
cohort's ``BLOCKS`` folders goes through a frozen backbone in batches of
100 tiles, coords come from the tile names, and each slide is written as
``<out_dir>/<slide>.h5`` holding ``features`` (float32) and ``coords``
(int32), which ``FeatureBagDataset`` reads back; ``n_augment`` adds
stain-augmented copies ``<slide>_aug{i}.h5`` (ref ``:198-234``).

Three routes for the backbone: its float32 module, or with
``quantize='int8'`` the post-training-quantized ResNet50
(``models/resnet_int8``, calibrated on up to 64 tiles across up to 8
slides), whose bottleneck stages run the int8 stage and entry kernels on
the card; ``'int8_fused'`` is the same network through
``apply_qresnet50_fused``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from transmil_deepgraft_tpu_torch.data import native_tiles as nt
from transmil_deepgraft_tpu_torch.data.jpg_bags import JPGMILDataset
from transmil_deepgraft_tpu_torch.data.tiles import _load_tile, parse_coords
from transmil_deepgraft_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    imagenet_normalize,
    train_augment,
)
from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.utils import h5

# tiles per step of each int8_fused segment (s1, e2, i2, e3, i3, e4, i4); each
# must divide the batch size
FUSED_T_CFG = (1, 1, 2, 1, 2, 1, 2)


def decode_batch(paths: list[Path], tile_size: int, use_native: bool,
                 augment_rng: Optional[np.random.Generator]) -> np.ndarray:
    """One batch of tile files -> raw (n, s, s, 3) uint8 from the native
    loader (normalized on the device), or ImageNet-normalized float32 from
    PIL (after ``train_augment`` when ``augment_rng`` is given); a batch the
    native loader fails on decodes with PIL."""
    if use_native:
        batch, n_ok = nt.load_tiles_u8(paths, tile_size)
        if n_ok == len(paths):
            return batch
        return np.stack([imagenet_normalize(_load_tile(p, tile_size)) for p in paths])
    imgs = []
    for p in paths:
        img = _load_tile(p, tile_size)
        if augment_rng is not None:
            img = train_augment(img, augment_rng)
        imgs.append(imagenet_normalize(img))
    return np.stack(imgs)


def extract_slide_features(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    tile_paths: list[Path],
    *,
    device: torch.device,
    batch_size: int = 100,
    tile_size: int = 224,
    augment_rng: Optional[np.random.Generator] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Embed all tiles of one slide: (features (N, D) float32, coords (N, 2)
    int32). Batches are ``batch_size`` tiles, the last zero-padded, and
    ``embed_fn`` maps a normalized (batch, s, s, 3) float32 tensor on
    ``device`` to its features.

    All-JPEG batches decode with the native loader, when it is available,
    as raw uint8 normalized on the device; otherwise, and for stain-augmented
    copies, with PIL. The next batch decodes on a host thread while this one
    embeds."""
    use_native = (augment_rng is None and nt.available()
                  and all(str(p).lower().endswith((".jpg", ".jpeg")) for p in tile_paths))
    coords = np.array([parse_coords(p.name) for p in tile_paths], np.int32)
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    chunks = [tile_paths[i:i + batch_size] for i in range(0, len(tile_paths), batch_size)]
    feats: list[np.ndarray] = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(decode_batch, chunks[0], tile_size, use_native, augment_rng)
        for ci in range(len(chunks)):
            batch = fut.result()
            if ci + 1 < len(chunks):  # decode the next batch during this embed
                fut = pool.submit(decode_batch, chunks[ci + 1], tile_size, use_native,
                                  augment_rng)
            n = batch.shape[0]
            if n < batch_size:  # one shape for every batch, as the JAX program
                batch = np.concatenate(
                    [batch, np.zeros((batch_size - n, *batch.shape[1:]), batch.dtype)])
            x = torch.from_numpy(batch).to(device)
            if x.dtype == torch.uint8:
                x = (x.float() / 255.0 - mean) / std
            with torch.inference_mode():
                feats.append(embed_fn(x)[:n].float().cpu().numpy())
    return np.concatenate(feats), coords


def _calibration_tiles(dataset: JPGMILDataset, batch_size: int) -> np.ndarray:
    """At least 64 tiles drawn across up to 8 slides, at the dataset's tile
    size (clip ranges measured at one size do not transfer to another):
    calibration coverage halves the worst int8 AUC shift (JAX
    ``feature_extractor.py:129-150``)."""
    n_slides = min(8, len(dataset))
    per_slide = max(8, 64 // max(1, n_slides))
    paths = []
    for s in range(n_slides):
        paths += dataset.tiles_of(s)[:per_slide]
    paths = paths[:64] or dataset.tiles_of(0)[:batch_size]
    size = getattr(dataset, "tile_size", 224)
    return np.stack([imagenet_normalize(_load_tile(p, size)) for p in paths])


def extract_cohort(
    backbone: nn.Module,
    dataset: JPGMILDataset,
    out_dir: str | Path,
    *,
    batch_size: int = 100,
    n_augment: int = 0,
    seed: int = 0,
    quantize: Optional[str] = None,
    device: str | torch.device | None = None,
) -> list[Path]:
    """Extract every slide of ``dataset`` to ``<out_dir>/<slide>.h5`` (and
    ``<slide>_aug{i}.h5`` for ``i < n_augment``, the augmentation draws from
    ``np.random.default_rng((seed, slide index, i))``) with the weights of
    ``backbone``, on ``device`` (None = CUDA). ``quantize``: None (the
    float32 module), 'int8' or 'int8_fused' (ResNet50 backbones)."""
    from transmil_deepgraft_tpu_torch.utils.jax_params import variables_from_module

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    truncate = getattr(backbone, "truncate_after", 4)
    if quantize == "int8_fused":
        # fail before calibration: every batch is padded to batch_size, so
        # each segment's tiles per step must divide it
        if truncate != 4:
            raise ValueError("int8_fused supports the full 4-stage net only")
        for t in FUSED_T_CFG:
            if t and batch_size % t:
                raise ValueError(
                    f"int8_fused: t={t} does not divide batch_size={batch_size}; "
                    f"use a batch size divisible by {max(t for t in FUSED_T_CFG if t)}")
    if quantize in ("int8", "int8_fused"):
        from transmil_deepgraft_tpu_torch.models.resnet_int8 import (
            apply_qresnet50,
            apply_qresnet50_fused,
            build_qresnet50,
            prepare_qresnet50_fused,
        )

        calib = _calibration_tiles(dataset, batch_size)
        q = build_qresnet50(variables_from_module(backbone), calib, truncate_after=truncate,
                            device=dev)
        if quantize == "int8_fused":
            prep = prepare_qresnet50_fused(q)
            embed_fn = lambda x: apply_qresnet50_fused(prep, x, t_cfg=FUSED_T_CFG)  # noqa: E731
        else:
            embed_fn = lambda x: apply_qresnet50(q, x)  # noqa: E731
    elif quantize is None:
        embed_fn = backbone.to(dev).eval()
    else:
        raise ValueError(f"quantize must be None, 'int8' or 'int8_fused', got {quantize!r}")

    written: list[Path] = []
    for i in range(len(dataset)):
        name = dataset.names[i]
        tiles = dataset.tiles_of(i)
        variants: list[tuple[str, Optional[np.random.Generator]]] = [(name, None)]
        variants += [(f"{name}_aug{a}", np.random.default_rng((seed, i, a)))
                     for a in range(n_augment)]
        for vname, rng in variants:
            feats, coords = extract_slide_features(
                embed_fn, tiles, device=dev, batch_size=batch_size, augment_rng=rng,
                tile_size=getattr(dataset, "tile_size", 224))
            written.append(h5.write(out_dir / f"{vname}.h5", {"features": feats, "coords": coords}))
    return written
