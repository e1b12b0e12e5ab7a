"""Sustainability / energy telemetry (port of ``utils/sustainability.py``;
ref ImpactTracker + codecarbon, ``code/sustainability_{train,test}.py``).

Energy is accounted as wall seconds x card watts x cards / 3.6e6 kWh, with
kgCO2 from a grid intensity. The watts are the card's power limit as
``nvidia-smi --query-gpu=power.limit`` reports it (700 W on an H100 80GB HBM3
at its maximum; a card may be capped lower), or the caller's ``chip_watts``;
without a card there is no default and the caller passes them.
``EnergyTracker`` wraps any loop; ``benchmark_models`` is the reference's
synthetic-bag model sweep (``sustainability_test.py:180-245``), writing
per-model kWh CSVs; on a card it synchronizes the device inside the tracker,
so it times the work, not its launch.
"""

from __future__ import annotations

import csv
import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

DEFAULT_KGCO2_PER_KWH = 0.4  # world-average-ish grid intensity

# Regional grid carbon intensities, gCO2eq/kWh (approximate 2022-2023 annual
# figures, Ember/IEA yearbook order of magnitude; override per deployment):
# the reference's per-region comparison (``code/mortality_cost.ipynb`` cells
# 2-3, ``map_co2.ipynb``, ``co2_plot.py:37-43``) without its private CSV.
REGION_GCO2_PER_KWH: dict[str, float] = {
    "World": 436.0,
    "Poland": 633.0,
    "India": 713.0,
    "China": 582.0,
    "Australia": 549.0,
    "Japan": 462.0,
    "United States": 367.0,
    "Germany": 385.0,
    "Italy": 331.0,
    "Netherlands": 268.0,
    "United Kingdom": 238.0,
    "Spain": 174.0,
    "Austria": 158.0,
    "Belgium": 139.0,
    "Canada": 126.0,
    "France": 56.0,
    "Sweden": 41.0,
    "Norway": 30.0,
}

# Mortality cost of carbon (Bressler, Nature Communications 12, 4467 (2021)):
# projected 2020-2100 excess deaths per tonne of CO2 emitted.
MORTALITY_DEATHS_PER_TCO2 = 2.26e-4


# nvidia-smi can stall for a while on a busy machine: each query is given
# this many seconds, and a stalled one is asked again, this many times.
SMI_TIMEOUT_S = 20
SMI_ATTEMPTS = 3
_card_watts_cache: dict[int, float] = {}


def card_watts(device: Optional[str | torch.device] = None) -> float:
    """The power limit of the card (``nvidia-smi --query-gpu=power.limit``,
    watts), read once a process and card. A query that stalls is asked again
    (``SMI_ATTEMPTS`` of ``SMI_TIMEOUT_S`` seconds). Raises without a card or
    without ``nvidia-smi``: pass ``chip_watts`` then."""
    if not torch.cuda.is_available():
        raise ValueError("no CUDA card to read the power limit of: pass chip_watts")
    index = torch.device(device).index if device is not None else None
    index = torch.cuda.current_device() if index is None else index
    if index in _card_watts_cache:
        return _card_watts_cache[index]
    cmd = ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
           "--format=csv,noheader,nounits"]
    for attempt in range(SMI_ATTEMPTS):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=SMI_TIMEOUT_S, check=True).stdout
            watts = float(out.strip().splitlines()[0])
            break
        except subprocess.TimeoutExpired as e:
            if attempt + 1 == SMI_ATTEMPTS:
                raise ValueError(f"could not read the card's power limit ({e}): "
                                 "pass chip_watts") from e
        except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
            raise ValueError(f"could not read the card's power limit ({e}): pass chip_watts") from e
    _card_watts_cache[index] = watts
    return watts


@dataclass
class EnergyReport:
    seconds: float
    kwh: float
    kg_co2: float
    steps: int = 0

    def as_dict(self) -> dict:
        return vars(self)


@dataclass
class EnergyTracker:
    """``with tracker: loop`` accumulates wall seconds; ``report()`` turns
    them into kWh and kgCO2. ``chip_watts`` None reads the card's power
    limit (:func:`card_watts`)."""

    chip_watts: Optional[float] = None
    kgco2_per_kwh: float = DEFAULT_KGCO2_PER_KWH
    n_chips: int = 1
    _t0: float = field(default=0.0, init=False)
    _elapsed: float = field(default=0.0, init=False)
    steps: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        if self.chip_watts is None:
            self.chip_watts = card_watts()

    def __enter__(self) -> "EnergyTracker":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._elapsed += time.perf_counter() - self._t0

    def step(self, n: int = 1) -> None:
        self.steps += n

    def report(self) -> EnergyReport:
        kwh = self._elapsed * self.chip_watts * self.n_chips / 3.6e6
        return EnergyReport(seconds=self._elapsed, kwh=kwh, kg_co2=kwh * self.kgco2_per_kwh,
                            steps=self.steps)


def regional_impact(kwh: float, regions: dict[str, float] | None = None) -> list[dict]:
    """Per-region CO2 and mortality cost of ``kwh`` of compute (the
    reference's ``mortality_cost.ipynb`` / ``map_co2.ipynb``): one row per
    region, cleanest first."""
    regions = REGION_GCO2_PER_KWH if regions is None else regions
    if not regions:
        raise ValueError("empty region table")
    rows = []
    for region, gco2 in sorted(regions.items(), key=lambda kv: kv[1]):
        kg = kwh * gco2 / 1000.0
        rows.append({"region": region, "gco2_per_kwh": gco2, "kg_co2": kg,
                     "deaths": kg / 1000.0 * MORTALITY_DEATHS_PER_TCO2})
    return rows


def write_regional_impact(kwh: float, out_path: str | Path,
                          regions: dict[str, float] | None = None,
                          rows: list[dict] | None = None) -> Path:
    """``regional_impact`` to CSV (+ a ``.json`` sidecar with the input kWh).
    Pass precomputed ``rows`` to keep CSV and plot the same."""
    rows = regional_impact(kwh, regions) if rows is None else rows
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    out_path.with_suffix(".json").write_text(json.dumps({"kwh": kwh, "rows": rows}, indent=2))
    return out_path


def plot_regional_impact(rows: list[dict], out_path: str | Path) -> Path:
    """Bar chart of per-region kgCO2 (the map_co2 comparison, without geodata)."""
    from transmil_deepgraft_tpu_torch.utils.plots import pyplot

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(range(len(rows)), [r["kg_co2"] for r in rows], color="#4c72b0")
    ax.set_xticks(range(len(rows)))
    ax.set_xticklabels([r["region"] for r in rows], rotation=60, ha="right", fontsize=8)
    ax.set_ylabel("kg CO2eq")
    ax.set_title("Same compute, by grid region")
    out_path = Path(out_path)
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return out_path


def _logits(out):
    """The logits of a head's output: a tuple's second element (JAX
    ``benchmark_models``' rule)."""
    return out[1] if isinstance(out, tuple) else out


def benchmark_models(
    out_dir: str | Path,
    model_names: tuple[str, ...] = ("TransMIL", "AttMIL", "TransformerMIL", "CLAM_SB"),
    bag_sizes: tuple[int, ...] = (600, 800, 1000),
    in_features: int = 2048,
    n_classes: int = 2,
    reps: int = 10,
    mode: str = "inference",
    chip_watts: Optional[float] = None,
    device: Optional[str | torch.device] = None,
) -> Path:
    """Per-model inference/training energy sweep over synthetic bags; writes
    ``{out_dir}/sustainability_{mode}.csv`` (the reference's kWh CSVs).
    Inference is the eval forward under ``inference_mode`` (TransMIL's
    K1/K2 on the card); training is an Adam step (lr 1e-4) on a
    cross-entropy loss through the deterministic forward, as JAX's. One
    call of each warms up before the tracked ``reps``."""
    from transmil_deepgraft_tpu_torch.device import resolve_device
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.train.losses import cross_entropy
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer

    dev = resolve_device(device)
    watts = chip_watts if chip_watts is not None else card_watts(dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    rng = np.random.default_rng(0)
    for name in model_names:
        for bag in bag_sizes:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = create_model(name, n_classes=n_classes, in_features=in_features,
                                     device=dev).eval()
            x = torch.from_numpy(rng.standard_normal((1, bag, in_features),
                                                     dtype=np.float32)).to(dev)
            if mode == "inference":
                with torch.inference_mode():
                    model(x)  # warm-up
                    sync()
                    with EnergyTracker(chip_watts=watts) as tracker:
                        for _ in range(reps):
                            model(x)
                            tracker.step()
                        sync()
            else:
                tx = create_optimizer("adam", lr=1e-4, weight_decay=0.0)
                tx.init(model)
                labels = torch.zeros(1, n_classes, device=dev)
                labels[:, 0] = 1.0

                def step() -> None:
                    for p in model.parameters():
                        p.grad = None
                    cross_entropy(_logits(model(x)), labels).backward()
                    tx.step()

                step()  # warm-up
                sync()
                with EnergyTracker(chip_watts=watts) as tracker:
                    for _ in range(reps):
                        step()
                        tracker.step()
                    sync()
            rep = tracker.report()
            rows.append({"model": name, "bag_size": bag, "mode": mode, "reps": reps,
                         "seconds": round(rep.seconds, 4), "kwh": rep.kwh,
                         "kg_co2": rep.kg_co2})

    path = out_dir / f"sustainability_{mode}.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    (out_dir / f"sustainability_{mode}.json").write_text(json.dumps(rows, indent=2))
    return path


def plot_sweep(csv_path: str | Path, out_path: str | Path | None = None) -> Path:
    """Energy-sweep bar chart (the reference's co2_plot.py): kWh per model/bag."""
    import pandas as pd

    from transmil_deepgraft_tpu_torch.utils.plots import pyplot

    plt = pyplot()
    csv_path = Path(csv_path)
    df = pd.read_csv(csv_path)
    pivot = df.pivot_table(index="model", columns="bag_size", values="kwh")
    fig, ax = plt.subplots(figsize=(6, 4))
    pivot.plot.bar(ax=ax)
    ax.set_ylabel("kWh per run")
    ax.set_title(f"Energy sweep ({df['mode'].iloc[0]}, {int(df['reps'].iloc[0])} reps)")
    out_path = Path(out_path) if out_path else csv_path.with_suffix(".png")
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return out_path
