"""Profiling: torch.profiler traces + per-step timing (port of
``utils/profiling.py``).

``trace()`` wraps a region in a ``torch.profiler`` trace (CPU and, where
there is a card, CUDA activities) and writes it as a Chrome trace
(``trace.json``, for Perfetto or chrome://tracing) into ``log_dir``;
``StepTimer`` collects per-step wall times with percentile summaries. On a
card it synchronizes the device before it stops the clock, so a step is the
work and not its launch.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path = "logs/profile"):
    """torch.profiler trace of the region -> ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _sync()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@dataclass
class StepTimer:
    """``with timer: step()`` appends the step's seconds; where there is a
    card, the current device is synchronized before the clock starts and
    before it stops."""

    times: list[float] = field(default_factory=list)
    _t0: float = 0.0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
            "total_s": float(arr.sum()),
        }
