"""Sustainability CLI (port of ``cli/sustainability.py``):
``python -m transmil_deepgraft_tpu_torch.cli.sustainability``.

The reference's ``sustainability_{train,test}.py`` benchmark: sweep the
model zoo over synthetic bags, measuring per-model inference/training energy
(wall time x the card's power limit, or ``--chip_watts``), and write kWh/CO2
CSVs; ``--regions`` adds the per-region CO2/mortality comparison of the
sweep's total kWh. Runs on the card unless ``--device cpu`` (which needs
``--chip_watts``).
"""

from __future__ import annotations

import argparse
import json


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="energy benchmark sweep (PyTorch port)")
    p.add_argument("--out_dir", default="logs/sustainability")
    p.add_argument("--models", nargs="+", default=["TransMIL", "AttMIL", "TransformerMIL", "CLAM_SB"])
    p.add_argument("--bag_sizes", nargs="+", type=int, default=[600, 800, 1000])
    p.add_argument("--in_features", type=int, default=2048)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--mode", default="inference", choices=["inference", "train"])
    p.add_argument("--chip_watts", type=float, default=None,
                   help="watts a card (default: the card's power limit from nvidia-smi)")
    p.add_argument("--regions", action="store_true",
                   help="also write the per-region CO2/mortality comparison "
                        "(the reference's mortality_cost/map_co2 analysis) "
                        "for the sweep's total kWh")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p


def main(argv: list[str] | None = None) -> str:
    import csv
    from pathlib import Path

    from transmil_deepgraft_tpu_torch.utils.sustainability import (
        benchmark_models, plot_regional_impact, regional_impact, write_regional_impact)

    args = make_parser().parse_args(argv)
    path = benchmark_models(
        args.out_dir,
        model_names=tuple(args.models),
        bag_sizes=tuple(args.bag_sizes),
        in_features=args.in_features,
        reps=args.reps,
        mode=args.mode,
        chip_watts=args.chip_watts,
        device=args.device,
    )
    out = {"csv": str(path)}
    if args.regions:
        with open(path) as f:
            total_kwh = sum(float(r["kwh"]) for r in csv.DictReader(f))
        rows = regional_impact(total_kwh)
        rpath = Path(args.out_dir) / f"regional_impact_{args.mode}.csv"
        write_regional_impact(total_kwh, rpath, rows=rows)
        plot_regional_impact(rows, rpath.with_suffix(".png"))
        out["regional_csv"] = str(rpath)
    print(json.dumps(out))
    return str(path)


if __name__ == "__main__":
    main()
