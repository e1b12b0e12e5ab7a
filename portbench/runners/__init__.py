"""Runners: the code that drives one kind of entry point of the port.

A traffic file names its runner (``"runner": "slide"``); the runner sets the
cell up from its configuration, runs the measured window, reads the device's
memory peak, frees the program's state and compares a sample of what the
window produced with the plain reference.

``Cell.side`` selects what stands in the program's place for the
comparison: ``program`` (the benchmark's own runs), ``control`` (the
reference at the next lower precision, read by ``portbench/probe.py`` and
the control test, never by ``run.py``). ``Cell.plant`` names a fault planted
in the timed path (the fault tests).
"""

from __future__ import annotations

import gc
import importlib
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool = False
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    side: str = "program"
    plant: Optional[str] = None

    def limit(self, number: str) -> float:
        return float(self.config["limits"][self.traffic["runner"]][number])


@dataclass
class Outcome:
    metrics: dict  # end-to-end metric -> value (setup_s apart)
    window_start: float  # perf_counter when set-up ended (0: no window)
    attempted: int
    failed: int
    checks: dict  # compared number -> (value, limit)
    work: dict = field(default_factory=dict)  # what the window did, for the readers
    trace: object = None
    memory_peak_bytes: int = 0
    log: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


def run(cell: Cell) -> Outcome:
    # float32 as every configuration states it: TF32 off (PyTorch's default
    # lets cuDNN take TF32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    module = importlib.import_module(f"portbench.runners.{cell.traffic['runner']}")
    return module.run(cell)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def tensors(tree: dict, device: torch.device) -> dict:
    """A nested dict of numpy leaves as torch tensors on ``device``."""
    return {k: tensors(v, device) if isinstance(v, dict) else torch.from_numpy(v).to(device)
            for k, v in tree.items()}


def scratch_dir() -> tempfile.TemporaryDirectory:
    """A directory under TMPDIR for files the program writes in set-up."""
    return tempfile.TemporaryDirectory(prefix="portbench-")
