"""Per-slide precomputed-feature bags, the main training source (port of
``data/feature_bags.py``; ref ``FeatureBagLoader``,
``code/datasets/feature_dataloader.py``).

- a label JSON ``{train/val/test/test_mixin: [[relpath, label], ...]}``
  whose ``FEATURES_RETCCL_2048`` path segment is replaced by the configured
  extractor; ``fine_tune`` mode reads train + test_mixin;
- a slide -> patient map JSON; slides absent from it are skipped;
- per-slide files: ``.h5``/``.hdf5`` (``features`` (N, D), ``coords``
  (N, 2)), ``.npy`` (features) or ``.pt`` (a features tensor). h5py and
  zarr are imported only when such a file is read.

Sampling, with every draw from an explicit ``numpy.random.Generator`` (the
same draws as the JAX package, so the same seed gives the same bags):
- train/fine_tune: permutation -> first ``max_bag_size`` -> optional bag
  mixup -> zero pad to ``max_bag_size`` -> shuffle again;
- val/test: a 10% draw with replacement, seeded to 0 for every slide.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from transmil_deepgraft_tpu_torch.data.coords import normalize_pad_coords

DEFAULT_FEATURE_TEMPLATE = "FEATURES_RETCCL_2048"


def load_bag_file(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(features float32, coords) of one slide file: .h5/.hdf5 (keys
    ``features``/``coords``), .npy, .pt or .zarr."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".h5", ".hdf5", ""):
        import h5py

        with h5py.File(path, "r") as f:
            feats = np.asarray(f["features"][:], dtype=np.float32)
            coords = (
                np.asarray(f["coords"][:]) if "coords" in f else np.zeros((len(feats), 2), np.int32)
            )
        return feats, coords
    if suffix == ".npy":
        feats = np.load(path).astype(np.float32)
        return feats, np.zeros((len(feats), 2), np.int32)
    if suffix == ".pt":
        import torch

        feats = torch.load(path, map_location="cpu", weights_only=True)
        feats = np.asarray(feats, dtype=np.float32)
        return feats, np.zeros((len(feats), 2), np.int32)
    if suffix == ".zarr":
        import zarr

        g = zarr.open(str(path), mode="r")
        key = "features" if "features" in g else "data"
        feats = np.asarray(g[key][:], np.float32)
        coords = (
            np.asarray(g["coords"][:]) if "coords" in g else np.zeros((len(feats), 2), np.int32)
        )
        return feats, coords
    raise ValueError(f"unsupported bag file type: {path}")


def load_slide_patient(path: str | Path | None) -> dict | None:
    """Slide -> patient map; ``None`` makes every slide its own patient."""
    if path is None:
        return None
    with open(path) as f:
        return json.load(f)


def load_label_entries(label_path: str | Path, mode: str) -> list:
    """The label JSON's ``[[path, label], ...]`` of a stage; ``fine_tune``
    is train + test_mixin."""
    with open(label_path) as f:
        label_json = json.load(f)
    if mode == "fine_tune":
        return list(label_json.get("train", [])) + list(label_json.get("test_mixin", []))
    return label_json[mode]


def scan_label_entries(
    entries, slide_patient: dict | None, resolve
) -> tuple[list[Path], list[int], list[str], list[str], list[str]]:
    """Entries -> parallel (files, labels, names, patients, missing).

    Entries absent from ``slide_patient`` are dropped, unresolvable paths go
    to ``missing``, and with no patient map the slide name is the patient.
    ``resolve(rel, name)`` returns the file on disk or None."""
    files: list[Path] = []
    labels: list[int] = []
    names: list[str] = []
    patients: list[str] = []
    missing: list[str] = []
    for rel, label in entries:
        name = Path(rel).stem
        if slide_patient is not None and name not in slide_patient:
            continue
        found = resolve(rel, name)
        if found is None:
            missing.append(str(rel))
            continue
        files.append(found)
        labels.append(int(label))
        names.append(name)
        patients.append(slide_patient[name] if slide_patient is not None else name)
    return files, labels, names, patients, missing


def _resolve_bag_path(path: Path) -> Path | None:
    """The path itself, ``.h5`` for an extension-less entry, then the path
    with ``.h5``/``.pt``/``.npy`` appended: the first that is a file."""
    cands = [path]
    if not path.suffix:
        cands.append(path.with_suffix(".h5"))
    cands += [Path(str(path) + ext) for ext in (".h5", ".pt", ".npy")]
    for cand in cands:
        if cand.exists() and cand.is_file():
            return cand
    return None


class FeatureBagDataset:
    def __init__(
        self,
        file_path: str | Path,
        label_path: str | Path,
        mode: str,
        n_classes: int,
        *,
        slide_patient_path: str | Path | None = None,
        max_bag_size: int = 1000,
        mixup: bool = False,
        feature_extractor: str | None = None,
        slides: list[str] | None = None,
        cache: bool = False,
        eval_draw_fraction: float = 0.1,
        mixed_res_dirs: list[str | Path] | None = None,
    ) -> None:
        self.file_path = Path(file_path)
        self.mode = mode
        self.n_classes = n_classes
        self.max_bag_size = max_bag_size
        self.mixup = mixup
        self.eval_draw_fraction = eval_draw_fraction
        self.cache = cache
        self._bag_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

        self.slide_patient = load_slide_patient(slide_patient_path)

        entries = load_label_entries(label_path, mode)
        if feature_extractor:
            entries = [
                (rel.replace(DEFAULT_FEATURE_TEMPLATE, feature_extractor), label)
                for rel, label in entries
            ]
        if slides is not None:
            entries = [e for e in entries if Path(e[0]).stem in slides]

        (self.files, self.labels, self.names, self.patients,
         self.missing) = scan_label_entries(
            entries, self.slide_patient,
            lambda rel, name: _resolve_bag_path(self.file_path / rel),
        )
        self.mixed_res_missing: list[str] = []
        # other resolutions (ref feature_dataloader_mixed): each root adds a
        # resolved train slide once more, with its label and patient
        if mixed_res_dirs and mode in ("train", "fine_tune"):
            resolved = set(self.names)
            extra_entries = [e for e in entries if Path(e[0]).stem in resolved]
            extras_by_name: dict[str, list[tuple]] = {}
            for extra_root in mixed_res_dirs:
                files, labels, names, patients, miss = scan_label_entries(
                    extra_entries, self.slide_patient,
                    lambda rel, name, root=Path(extra_root): _resolve_bag_path(root / rel),
                )
                for item in zip(files, labels, names, patients):
                    extras_by_name.setdefault(item[2], []).append(item)
                self.mixed_res_missing += [str(Path(extra_root) / m) for m in miss]
            # slide-major, as the reference's loop: the primary file, then
            # each extra root's
            merged: list[tuple] = []
            for item in zip(self.files, self.labels, self.names, self.patients):
                merged.append(item)
                merged += extras_by_name.get(item[2], [])
            if merged:
                self.files, self.labels, self.names, self.patients = (
                    list(seq) for seq in zip(*merged)
                )

    def __len__(self) -> int:
        return len(self.files)

    def get_labels(self) -> list[int]:
        return list(self.labels)

    def _load(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        if self.cache and index in self._bag_cache:
            return self._bag_cache[index]
        bag = load_bag_file(self.files[index])
        if self.cache:
            self._bag_cache[index] = bag
        return bag

    def _mixup_bag(self, bag: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Bag mixup (ref ``feature_dataloader.py:303-330``): convex
        combinations of random tile pairs, appended up to ``max_bag_size``."""
        n = bag.shape[0]
        a = rng.random(n, dtype=np.float32)[:, None]
        x = bag[rng.integers(0, n, n)]
        y = bag[rng.integers(0, n, n)]
        temp = a * x + (1.0 - a) * y
        if n < self.max_bag_size:
            extra = temp[rng.permutation(n)[: self.max_bag_size - n]]
            return np.concatenate([bag, extra], axis=0)
        return temp

    def get_item(self, index: int, rng: np.random.Generator) -> tuple[np.ndarray, int, tuple[str, np.ndarray, str]]:
        feats, coords = self._load(index)
        label = self.labels[index]
        name = self.names[index]
        patient = self.patients[index]
        n = feats.shape[0]

        if self.mode in ("train", "fine_tune"):
            idx = rng.permutation(n)[: self.max_bag_size]
            bag = feats[idx]
            coords = coords[idx]
            if self.mixup:
                bag = self._mixup_bag(bag, rng)
            if bag.shape[0] < self.max_bag_size:
                pad = np.zeros((self.max_bag_size - bag.shape[0], bag.shape[1]), np.float32)
                bag = np.concatenate([bag, pad], axis=0)
            # coords stay row-aligned through the reshuffle (no extra draw)
            coords = normalize_pad_coords(coords, bag.shape[0])
            perm = rng.permutation(bag.shape[0])
            return bag[perm], label, (name, coords[perm], patient)

        # val/test: a 10% draw with replacement, seeded to 0 (ref :420-431)
        draw = np.random.RandomState(0).choice(n, math.ceil(n * self.eval_draw_fraction))
        return feats[draw], label, (name, coords[draw], patient)

    def __getitem__(self, index: int):
        return self.get_item(index, np.random.default_rng())
