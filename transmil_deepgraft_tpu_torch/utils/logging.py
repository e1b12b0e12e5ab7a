"""CSV / JSONL metric loggers (port of ``utils/logging.py``): every row goes
to ``metrics.jsonl`` and ``metrics.csv`` under the run directory, and with
``use_tensorboard`` each numeric value as a scalar event under
``<log_dir>/tb`` (tag = the metric's name, step = the row's step), the
events JAX's ``tensorboardX.SummaryWriter`` writes; without tensorboardX
they are silently off, as in JAX. The port writes them through
tensorboardX's file writer itself and flushes each row: the
``SummaryWriter`` queues events for a thread that reaches the disk only
every 120 s or at ``close()``, which JAX's logger never calls."""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str | Path, use_tensorboard: bool = False) -> None:
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
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX.event_file_writer import EventsWriter
                from tensorboardX.proto.event_pb2 import Event
                from tensorboardX.summary import scalar

                (self.dir / "tb").mkdir(exist_ok=True)
                self._tb = EventsWriter(str(self.dir / "tb" / "events"))
                self._event, self._scalar = Event, scalar
            except Exception:  # no tensorboardX (or no writer): off, as in JAX
                self._tb = None

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
        if self._tb is not None:
            for k, v in metrics.items():
                s = _scalar(v)
                if isinstance(s, (int, float)):
                    self._tb.write_event(self._event(wall_time=time.time(), step=step,
                                                     summary=self._scalar(k, s)))
            self._tb.flush()


def _scalar(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
