"""Feature-extraction CLI (port of ``cli/extract_features.py``):
``python -m transmil_deepgraft_tpu_torch.cli.extract_features``.

The reference's ``datasets/feature_extractor.py`` script: embed every slide
of a cohort (``<data_dir>/BLOCKS/<slide>/*.jpg``, the slides of one split of
the label JSON) through a frozen backbone into per-slide HDF5 ``{features,
coords}`` files (and N stain-augmented copies), then optionally pack them
into a native bag store (``<out_dir>/cohort.bags``). Prints one JSON line,
``{"slides", "files", "dim", "out"}``.

Runs on the card unless ``--device cpu``. ``--backbone`` is any tile
backbone of ``models/backbones`` (retccl, resnet50, resnet18, simple,
efficientnet, vit, dino, uni2_h); ``--ckpt`` converts a .pth in the
reference's names for it (for uni2_h, timm's: MahmoodLab/UNI2-h's
``pytorch_model.bin``, not in the repository; it runs in float32 here, the
bf16 route is ``cli.infer``'s). ``--quantize int8`` / ``int8_fused`` run the int8 ResNet50
(the ResNet50 family only, as in JAX), whose stages are the int8 stage and
entry kernels on the card.
"""

from __future__ import annotations

import argparse
import json


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="offline tile -> feature extraction")
    p.add_argument("--data_dir", required=True, help="cohort root (BLOCKS/<slide>/*.jpg)")
    p.add_argument("--label_file", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--backbone", default="retccl",
                   choices=["retccl", "resnet50", "resnet18", "simple", "efficientnet", "vit",
                            "dino", "uni2_h"])
    p.add_argument("--ckpt", default=None,
                   help="torch .pth/.ckpt to convert (e.g. retccl_best_ckpt.pth)")
    p.add_argument("--mode", default="test", help="label-JSON split to extract")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--augment", type=int, default=0, help="N augmented copies per slide")
    p.add_argument("--bagstore", action="store_true", help="also pack a native bag store")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int8_fused"],
                   help="int8: the post-training-quantized ResNet50 (its stages run the int8 "
                        "kernels on the card)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def main(argv: list[str] | None = None) -> list[str]:
    import torch

    from transmil_deepgraft_tpu_torch.data.feature_extractor import extract_cohort
    from transmil_deepgraft_tpu_torch.data.jpg_bags import JPGMILDataset
    from transmil_deepgraft_tpu_torch.device import resolve_device
    from transmil_deepgraft_tpu_torch.models.backbones import create_backbone

    args = make_parser().parse_args(argv)
    if args.quantize and args.backbone not in ("retccl", "resnet50"):
        raise SystemExit(f"--quantize {args.quantize} quantizes the ResNet50 family "
                         f"(retccl, resnet50), not {args.backbone!r}")
    dev = resolve_device(args.device)
    with torch.random.fork_rng(devices=[]):  # JAX initializes from key(0)
        torch.manual_seed(0)
        backbone, dim = create_backbone(args.backbone)
    if args.ckpt:
        # converted by backbone, as cli.train converts Model.backbone_weights
        # (JAX's extract CLI converts every checkpoint as a ResNet, ROADMAP C15)
        from transmil_deepgraft_tpu_torch.models.backbones import load_backbone_variables
        from transmil_deepgraft_tpu_torch.utils.torch_weights import (
            convert_backbone_state_dict,
            load_torch_checkpoint,
        )

        load_backbone_variables(backbone, convert_backbone_state_dict(
            load_torch_checkpoint(args.ckpt), args.backbone))

    ds = JPGMILDataset(args.data_dir, args.label_file, args.mode, n_classes=2)
    written = extract_cohort(backbone, ds, args.out_dir, batch_size=args.batch_size,
                             n_augment=args.augment, quantize=args.quantize, device=dev)
    if args.bagstore:
        from transmil_deepgraft_tpu_torch.data.bagstore import convert_h5_dir

        convert_h5_dir(args.out_dir, f"{args.out_dir}/cohort.bags")
    print(json.dumps({"slides": len(ds), "files": len(written), "dim": dim, "out": args.out_dir}))
    return [str(p) for p in written]


if __name__ == "__main__":
    main()
