"""Feature-file tooling: integrity checks and HDF5 consolidation (port of
``data/tools.py``).

The reference's ``datasets/feature_file_checker.py:15-81`` and
``datasets/utils/{move_to_hdf5, merge_hdf5}.py``: check that every slide of a
label JSON has a readable feature file with consistent shapes, and rewrite
per-slide files of any supported kind as a directory of HDF5 files (written
by ``utils/h5``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from transmil_deepgraft_tpu_torch.data.feature_bags import load_bag_file
from transmil_deepgraft_tpu_torch.utils import h5


@dataclass
class CheckReport:
    ok: list[str] = field(default_factory=list)
    missing: list[str] = field(default_factory=list)
    corrupt: list[tuple[str, str]] = field(default_factory=list)
    empty: list[str] = field(default_factory=list)
    dims: dict[int, int] = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "ok": len(self.ok),
            "missing": len(self.missing),
            "corrupt": len(self.corrupt),
            "empty": len(self.empty),
            "feature_dims": self.dims,
        }


def check_feature_files(
    file_path: str | Path, label_path: str | Path,
    splits: tuple[str, ...] = ("train", "val", "test"),
) -> CheckReport:
    """Check every file the label JSON names (ref ``feature_file_checker.py``):
    it exists, reads, is not empty, has as many coords as feature rows and
    finite features; tallies the feature widths of the cohort."""
    root = Path(file_path)
    with open(label_path) as f:
        label_json = json.load(f)
    report = CheckReport()
    for split in splits:
        for rel, _ in label_json.get(split, []):
            candidates = [root / rel, Path(str(root / rel) + ".h5")]
            path = next((c for c in candidates if c.exists()), None)
            if path is None:
                report.missing.append(rel)
                continue
            try:
                feats, coords = load_bag_file(path)
            except Exception as e:  # any unreadable file is reported, not raised
                report.corrupt.append((rel, f"{type(e).__name__}: {e}"))
                continue
            if feats.shape[0] == 0:
                report.empty.append(rel)
                continue
            if coords.shape[0] != feats.shape[0]:
                report.corrupt.append(
                    (rel, f"coords rows {coords.shape[0]} != features {feats.shape[0]}"))
                continue
            if not np.isfinite(feats).all():
                report.corrupt.append((rel, "non-finite features"))
                continue
            report.dims[feats.shape[1]] = report.dims.get(feats.shape[1], 0) + 1
            report.ok.append(rel)
    return report


def merge_to_hdf5_dir(sources: list[str | Path], out_dir: str | Path,
                      overwrite: bool = False) -> list[Path]:
    """Rewrite per-slide files of any supported kind (.pt/.npy/.zarr/.h5) as
    ``<out_dir>/<stem>.h5`` with ``features`` and ``coords`` (ref
    move_to_hdf5/merge_hdf5); an existing file is kept unless ``overwrite``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for src in map(Path, sources):
        dst = out_dir / (src.stem.replace(".zarr", "") + ".h5")
        if dst.exists() and not overwrite:
            written.append(dst)
            continue
        feats, coords = load_bag_file(src)
        written.append(h5.write(dst, {"features": feats, "coords": coords}))
    return written
