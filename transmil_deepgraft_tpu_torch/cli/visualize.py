"""Visualization CLI (port of ``cli/visualize.py``):
``python -m transmil_deepgraft_tpu_torch.cli.visualize``.

The reference's ``code/visualize_mil.py`` driver: build the config's model
(``cli.train.build``), load a checkpoint (the port's or the JAX Trainer's),
select slides (every test slide, or the patients of a top-k CSV the test
stage wrote, ref ``visualize_mil.py:236-241``), run the attention + GradCAM
heatmaps of each (pixel CAMs through the backbone for an ``ImageMILModel``,
``--cam_method``) and write JPEGs, top-k CSVs and ``heatmap_index.json``.
``--track_energy`` writes ``heatmap_energy.json`` (wall time x the card's
power limit). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TransMIL attention/GradCAM heatmaps (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True, help="checkpoint file (last.ckpt or metric-named)")
    p.add_argument("--log_dir", default=None, help="run dir holding top-k CSVs")
    p.add_argument("--target_label", type=int, default=1)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--topk_csv", default=None, help="restrict to patients in this CSV")
    p.add_argument("--max_slides", type=int, default=0)
    p.add_argument("--track_energy", action="store_true",
                   help="wrap the heatmap loop in the kWh/CO2 tracker and write "
                        "heatmap_energy.json (ref gradcam_sus.py ImpactTracker run)")
    p.add_argument("--cam_method", default="gradcam",
                   help="CAM algorithm for image pipelines (visualize.cam.CAM_METHODS)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def main(argv: list[str] | None = None) -> list[dict]:
    from transmil_deepgraft_tpu_torch.cli.train import build
    from transmil_deepgraft_tpu_torch.models.backbones import ImageMILModel
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml
    from transmil_deepgraft_tpu_torch.visualize.heatmap import ImageVisualizer, Visualizer

    args = make_parser().parse_args(argv)
    cfg = finalize_config(read_yaml(args.config), config_path=args.config, stage="test")
    trainer = build(cfg, log_dir=args.log_dir, device=args.device)
    trainer.load_checkpoint(args.ckpt)

    out_dir = Path(args.out_dir or (Path(trainer.cfg.log_dir) / "heatmaps"))
    if isinstance(trainer.model, ImageMILModel):
        # raw tiles: pixel-level CAM through the backbone (ref
        # visualize_feature.py / visualize_classic.py drivers)
        viz = ImageVisualizer(trainer.model.backbone, trainer.model.head, out_dir,
                              target_class=args.target_label, cam_method=args.cam_method)
    else:
        viz = Visualizer(trainer.model, out_dir, target_class=args.target_label)

    keep_patients = None
    if args.topk_csv:
        import pandas as pd

        keep_patients = set(pd.read_csv(args.topk_csv)["Patient"].astype(str))

    results = []
    ds = trainer.dm.dataset("test")
    rng = np.random.default_rng(0)
    tracker = None
    if args.track_energy:
        from transmil_deepgraft_tpu_torch.utils.sustainability import EnergyTracker

        tracker = EnergyTracker().__enter__()
    for i in range(len(ds)):
        bag, label, (name, coords, patient) = (ds.get_item(i, rng) if hasattr(ds, "get_item")
                                               else ds[i])
        if keep_patients is not None and str(patient) not in keep_patients:
            continue
        res = viz.run_slide(np.asarray(bag), np.asarray(coords), name)
        results.append({"slide": name, "patient": patient, "label": int(label),
                        "logits": res["logits"].tolist(),
                        "paths": [str(p) for p in res["paths"]]})
        if args.max_slides and len(results) >= args.max_slides:
            break

    out_dir.mkdir(parents=True, exist_ok=True)
    if tracker is not None:
        tracker.step(len(results))
        tracker.__exit__()
        (out_dir / "heatmap_energy.json").write_text(
            json.dumps(tracker.report().as_dict(), indent=2))
    (out_dir / "heatmap_index.json").write_text(json.dumps(results, indent=2))
    print(json.dumps({"slides": len(results), "out_dir": str(out_dir)}))
    return results


if __name__ == "__main__":
    main()
