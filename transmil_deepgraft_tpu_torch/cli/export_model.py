"""Export a trained MIL head, or a whole slide pipeline, as a serving
bundle (port of ``cli/export_model.py``).

``python -m transmil_deepgraft_tpu_torch.cli.export_model --model TransMIL \
    --ckpt logs/.../epoch=12-....ckpt --out transmil_head.tdx``

With ``--backbone_ckpt`` it writes a slide bundle (raw tiles -> slide
probabilities): the int8 ResNet50 calibrated on ``--calib_tiles`` (on the
card, or ``--device cpu``), else the float ResNet50 served in bf16. The
port's bundles hold weights, not compiled programs: ``--platforms`` and
``--symbolic`` are accepted at their defaults only. ``--model`` takes every
ported head (TransMIL, TransformerMIL, AttMIL, Chowder, RoFormerMIL,
AttTrans/MonaiMILModel, CLAM_SB/MB, DTFD, MDMIL, DSMIL, and the spatial
CTMIL and ``resnet50``, whose bundles serve a bag as a 1 x n grid, as JAX's
do, with their BatchNorm statistics): its widths and depths come from the
weights, its other knobs are the head's defaults, as in the JAX CLI.

Checkpoints: torch state dicts (``.pth``/``.pt``, Lightning ``.ckpt``, the
port's trainer checkpoints) or flax msgpack trees (the JAX trainer's
checkpoints, raw variable trees).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

DEFAULT_PLATFORMS, DEFAULT_SYMBOLIC = "tpu,cpu", "auto"


def make_parser() -> argparse.ArgumentParser:
    from transmil_deepgraft_tpu_torch.serving import DEFAULT_SERVING_BUCKETS

    p = argparse.ArgumentParser(description="export a serving bundle (.tdx)")
    p.add_argument("--model", required=True,
                   help="head: TransMIL/TransformerMIL/AttMIL/Chowder/RoFormerMIL/AttTrans/"
                        "CLAM_SB/CLAM_MB/DTFD/MDMIL/DSMIL/CTMIL/resnet50 (models.create_model)")
    p.add_argument("--ckpt", required=True,
                   help="trainer .ckpt, flax msgpack tree, or torch .pth")
    p.add_argument("--out", required=True, help="output bundle path (.tdx)")
    p.add_argument("--n_classes", type=int, default=2,
                   help="checked against the classifier's weights")
    p.add_argument("--in_features", type=int, default=2048)
    p.add_argument("--out_features", type=int, default=512,
                   help="the head's width (the port reads it from the weights)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--buckets", default=",".join(map(str, DEFAULT_SERVING_BUCKETS)),
                   help="comma-separated bag-length buckets")
    p.add_argument("--platforms", default=DEFAULT_PLATFORMS,
                   help="lowering targets of the JAX package's bundles; the port's hold no "
                        "programs and take only the default")
    p.add_argument("--symbolic", choices=["auto", "always", "never"], default=DEFAULT_SYMBOLIC,
                   help="the JAX package's length-polymorphic export; the port takes only "
                        "the default")
    p.add_argument("--backbone_ckpt", default=None,
                   help="ResNet50 weights (torch .pth or flax msgpack): exports a SLIDE "
                        "bundle (raw tiles -> probs) instead of a head bundle")
    p.add_argument("--calib_tiles", default=None,
                   help=".npy of (N, H, W, 3) float32 normalized calibration tiles for the "
                        "int8 backbone; omit for bf16")
    p.add_argument("--chunk", type=int, default=128,
                   help="slide bundles: tiles per backbone call")
    p.add_argument("--tile_hw", type=int, default=224)
    p.add_argument("--device", default=None,
                   help="slide bundles: where the int8 calibration runs (default: cuda)")
    return p


def main(argv: list[str] | None = None) -> dict:
    import numpy as np

    from transmil_deepgraft_tpu_torch.models import MODEL_REGISTRY
    from transmil_deepgraft_tpu_torch.serving import export_serving_bundle, export_slide_bundle
    from transmil_deepgraft_tpu_torch.utils.torch_weights import (
        load_backbone_variables, load_head_params)

    args = make_parser().parse_args(argv)
    if args.platforms != DEFAULT_PLATFORMS or args.symbolic != DEFAULT_SYMBOLIC:
        raise SystemExit("--platforms and --symbolic choose the programs of a JAX bundle; the "
                         "port's bundles hold weights, not programs")
    if args.model not in MODEL_REGISTRY:
        # JAX's create_model raises KeyError: the classic per-tile models are
        # not bag heads (ROADMAP C13), and neither package exports them
        raise SystemExit(f"--model {args.model}: unknown model, not a bag head; the port "
                         f"exports {sorted(MODEL_REGISTRY)}")
    params = load_head_params(args.ckpt, args.in_features, args.model)
    buckets = [int(b) for b in args.buckets.split(",")]
    if args.backbone_ckpt:
        # slide bundles serve one slide per call
        if args.batch != 1:
            raise SystemExit("--batch is not supported with --backbone_ckpt "
                             "(slide bundles serve one slide per call)")
        calib = np.load(args.calib_tiles) if args.calib_tiles else None
        meta = export_slide_bundle(
            load_backbone_variables(args.backbone_ckpt), params, args.out,
            model_name=args.model, in_features=args.in_features, n_classes=args.n_classes,
            calib_tiles=calib, chunk=args.chunk, tile_hw=args.tile_hw, head_buckets=buckets,
            device=args.device,
        )
    else:
        meta = export_serving_bundle(
            params, args.out, model_name=args.model, in_features=args.in_features,
            n_classes=args.n_classes, batch=args.batch, buckets=buckets,
        )
    size = Path(args.out).stat().st_size
    print(json.dumps({**meta, "path": args.out, "bytes": size}))
    return meta


if __name__ == "__main__":
    main()
