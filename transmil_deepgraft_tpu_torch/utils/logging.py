"""CSV / JSONL metric loggers (port of ``utils/logging.py``, without the
TensorBoard writer): every row goes to ``metrics.jsonl`` and ``metrics.csv``
under the run directory."""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str | Path) -> None:
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.dir / "metrics.csv"
        self._jsonl_path = self.dir / "metrics.jsonl"
        self._fields: list[str] = []
        if self._csv_path.exists():  # resuming into an existing run dir
            with open(self._csv_path) as f:
                header = f.readline().strip()
            if header:
                self._fields = header.split(",")

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        record = {"step": step, "time": time.time(), **{k: _scalar(v) for k, v in metrics.items()}}
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        new_fields = [k for k in record if k not in self._fields]
        if new_fields:
            self._fields += new_fields
            rows = []
            if self._csv_path.exists():
                with open(self._csv_path) as f:
                    rows = list(csv.DictReader(f))
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields, restval="", extrasaction="ignore")
                w.writeheader()
                for r in rows:
                    w.writerow(r)
                w.writerow(record)
        else:
            with open(self._csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields, restval="",
                               extrasaction="ignore").writerow(record)


def _scalar(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
