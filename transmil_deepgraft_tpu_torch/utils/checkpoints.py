"""Checkpoints with metric-keyed retention (port of ``utils/checkpoints.py``).

As the reference's three ModelCheckpoint callbacks + save_last: keep the top
3 by val_loss (min), the top 1 by val_auc (max), the top 3 by val_accuracy
(max), plus ``last``. A checkpoint is a ``torch.save`` file: the model's state
dict for the metric-keyed ones, the full train state (model, optimizer, loop
counters) for ``last.ckpt``. Filenames embed the epoch and the monitored
metrics, like the reference's. :func:`read_checkpoint` reads these files and
the JAX Trainer's flax-msgpack ones.
"""

from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from transmil_deepgraft_tpu_torch.utils.flax_msgpack import read_flax_msgpack

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save writes a zip archive

def save_checkpoint(path: str | Path, obj: Any) -> None:
    """Atomic save: the file lands in a ``.tmp`` sibling first and is swapped
    in afterwards, so an interrupted write never leaves a truncated file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def read_checkpoint(path: str | Path) -> dict:
    """A checkpoint as a dict: a ``torch.save`` file of the port (tensors on
    the CPU), or the JAX Trainer's flax msgpack tree (numpy leaves)."""
    data = Path(path).read_bytes()
    if data[:4] == _ZIP_MAGIC:
        return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    return read_flax_msgpack(data)


@dataclass
class Monitor:
    name: str
    mode: str  # 'min' | 'max'
    top_k: int
    kept: list[tuple[float, str]] = field(default_factory=list)  # (value, filename)

    def better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def consider(self, value: float, filename: str) -> tuple[bool, str | None]:
        """Returns (keep, evicted_filename)."""
        if len(self.kept) < self.top_k:
            self.kept.append((value, filename))
            self._sort()
            return True, None
        worst_value, worst_file = self.kept[-1]
        if self.better(value, worst_value):
            self.kept[-1] = (value, filename)
            self._sort()
            return True, worst_file
        return False, None

    def _sort(self) -> None:
        self.kept.sort(key=lambda t: t[0], reverse=(self.mode == "max"))


class CheckpointManager:
    """Multi-monitor top-k retention over ``torch.save`` files."""

    DEFAULT_MONITORS = (
        ("val_loss", "min", 3),
        ("val_auc", "max", 1),
        ("val_accuracy", "max", 3),
    )

    def __init__(self, directory: str | Path, monitors=DEFAULT_MONITORS) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitors = {name: Monitor(name, mode, k) for name, mode, k in monitors}

    def last_path(self) -> Path:
        return self.dir / "last.ckpt"

    def save_last(self, obj: Any) -> None:
        save_checkpoint(self.last_path(), obj)

    def save_epoch(self, obj: Any, epoch: int, metrics: dict[str, float],
                   last_obj: Any = None) -> list[str]:
        """Save ``last`` (``last_obj``, default ``obj``) and any checkpoint a
        monitor keeps; returns the names saved."""
        self.save_last(last_obj if last_obj is not None else obj)
        (self.dir / "last.json").write_text(json.dumps({"epoch": epoch, **metrics}))
        saved = ["last.ckpt"]

        parts = [f"epoch={epoch:02d}"] + [f"{k}={metrics[k]:.4f}" for k in self.monitors if k in metrics]
        filename = "-".join(parts) + ".ckpt"
        wanted = False
        evicted: list[str] = []
        for name, mon in self.monitors.items():
            if name not in metrics:
                continue
            keep, evict = mon.consider(float(metrics[name]), filename)
            wanted = wanted or keep
            if evict:
                evicted.append(evict)
        if wanted:
            save_checkpoint(self.dir / filename, obj)
            saved.append(filename)
        for f in evicted:
            still_referenced = any(f == kf for mon in self.monitors.values() for _, kf in mon.kept)
            target = self.dir / f
            if not still_referenced and target.exists():
                target.unlink()
        return saved
