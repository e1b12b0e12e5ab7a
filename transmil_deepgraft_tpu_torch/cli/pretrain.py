"""SimCLR pretraining CLI (port of ``cli/pretrain.py``):
``python -m transmil_deepgraft_tpu_torch.cli.pretrain``.

Drives ``train/simclr.fit_simclr`` over a directory of tile images: two
stain-augmented views a tile, NT-Xent, AdamW + cosine annealing, per-epoch
ranking metrics, ``simclr_last.ckpt`` every epoch. Runs on the card unless
``--device cpu``. Prints the JAX CLI's JSON line.

  python -m transmil_deepgraft_tpu_torch.cli.pretrain --tiles_dir BLOCKS/ \\
      --epochs 100 --batch_size 128 --lr 5e-4 --temperature 0.07
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SimCLR pretraining over tile images (PyTorch port)")
    p.add_argument("--tiles_dir", required=True,
                   help="directory (searched recursively) of jpg/png tiles")
    p.add_argument("--tile_size", type=int, default=224)
    p.add_argument("--max_tiles", type=int, default=0, help="0 = use all")
    p.add_argument("--backbone", default="resnet18", choices=["resnet18", "resnet50"])
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", default="logs/simclr")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p


def main(argv: list[str] | None = None) -> dict:
    import torch

    from transmil_deepgraft_tpu_torch.device import resolve_device
    from transmil_deepgraft_tpu_torch.inference import decode_tile_paths
    from transmil_deepgraft_tpu_torch.models.resnet import resnet18, resnet50
    from transmil_deepgraft_tpu_torch.train.simclr import fit_simclr

    args = make_parser().parse_args(argv)
    root = Path(args.tiles_dir)
    paths = sorted(p for pat in ("*.jpg", "*.jpeg", "*.png") for p in root.rglob(pat))
    if not paths:
        raise SystemExit(f"no tiles under {root}")
    if args.max_tiles:
        paths = paths[:args.max_tiles]
    images = decode_tile_paths(paths, size=args.tile_size)

    dev = resolve_device(args.device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        backbone = (resnet18 if args.backbone == "resnet18" else resnet50)(num_classes=0).to(dev)
    _, history = fit_simclr(
        images,
        backbone=backbone,
        hidden_dim=args.hidden_dim,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        temperature=args.temperature,
        seed=args.seed,
        log_dir=args.log_dir,
    )
    out = {
        "tiles": len(paths),
        "epochs": args.epochs,
        "final_loss": history[-1]["train_loss"],
        "final_acc_top5": history[-1]["acc_top5"],
        "ckpt": str(Path(args.log_dir) / "simclr_last.ckpt"),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
