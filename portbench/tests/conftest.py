"""Shared pieces of the harness's tests: the repository root on the path, a
fixture that skips without a card, and cells cut to a size a CPU test can run.

Run them from the repository's root:

    python -m pytest portbench/tests -q            # the CPU tests
    python -m pytest portbench/tests -q -m cuda    # the card's (on the chip)
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cell cut to a few tiles or rows (CPU tests: the plain versions run)
TINY = {
    "slide-mixed": (
        {"tile_hw": 32, "chunk": 4, "calib_tiles": 4},
        {"sizes": {"dist": "loguniform", "low": 5, "high": 14, "count": 4}, "pool_tiles": 64,
         "check_tiles": 20}),
    "train-b64x200": ({"training": {"batch_size": 4, "bag_size": 20}}, {"pool_bags": 32}),
}


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys replaced; nested sections merge, a size
    spec is replaced whole."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        spec = "dist" in v if isinstance(v, dict) else True
        if isinstance(v, dict) and isinstance(out.get(k), dict) and not spec:
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


def tiny_cell(name: str, **kw):
    """The cell ``name`` with its configuration and traffic cut by TINY, on
    the CPU."""
    from portbench import runners, harness

    _, config, traffic = harness.cell_parts(name)
    c, t = TINY[name]
    args = {"seed": 2 ** 31 + 11, "seconds": 0.5, "device": torch.device("cpu"), **kw}
    return runners.Cell(name=name, config=merge(config, c), traffic=merge(traffic, t), **args)


@pytest.fixture
def tiny():
    """``tiny(name, **cell fields)``: a cell cut by TINY."""
    return tiny_cell


@pytest.fixture
def cut():
    """``cut(base, over)``: a configuration or traffic with keys replaced."""
    return merge


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")
    return torch.device("cuda")
