"""Slide inference CLI (port of ``cli/infer.py``):
``python -m transmil_deepgraft_tpu_torch.cli.infer``.

A folder of slide tile folders streams from disk through the int8 (or bf16)
ResNet50, or with ``--backbone uni2_h`` the UNI2-h ViT-H/14 in bf16 (float32
residual stream, LayerNorm and LayerScale; ``models/vit.uni2_h``), and a MIL
head (``--model``: any ported head with attention scores)
of ``inference.SlideInferencePipeline`` on the card (``--device cpu`` for
the CPU) and writes each slide's probabilities plus its top-k tiles by
attention. A coord-aware head (RoFormerMIL) gets the tiles' real (x-y)
coordinates from their file names, as in the JAX CLI.

Checkpoints: torch state dicts (``.pth``/``.pt``, Lightning ``.ckpt``, the
port's trainer checkpoints) converted by ``utils/torch_weights``, or flax
msgpack variable trees. UNI2-h's ``--backbone_ckpt`` is a state dict in
timm's names (MahmoodLab/UNI2-h's ``pytorch_model.bin``, not in the
repository: ``cls_token``, ``reg_token``, ``pos_embed``, ``patch_embed.proj``,
``blocks.{i}.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1,
mlp.fc2, ls2.gamma}``, ``norm``); its head takes 1536-d features.

``--n_chips k`` embeds tile-parallel over k processes, one card each
(``SlideInferencePipeline(mesh=)``). Outside a launcher the command starts
the k processes itself (``torch.multiprocessing``, a free local port), so it
stays one command, as JAX's is; under torchrun ``WORLD_SIZE`` must be k.
With ``--device cpu`` the k processes are gloo ranks on the CPU. Rank 0
writes the CSVs and ``predictions.json``."""

from __future__ import annotations

import argparse
import csv
import json
import os
import socket
from pathlib import Path

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="slide inference (tiles -> probabilities)")
    p.add_argument("--tiles_root", required=True,
                   help="root holding <slide>/<tile_(x-y)>.jpg folders")
    p.add_argument("--backbone", choices=["retccl", "uni2_h"], default="retccl",
                   help="tile encoder: the RetCCL ResNet50 (int8 or bf16) or UNI2-h (bf16)")
    p.add_argument("--backbone_ckpt", required=True,
                   help="ResNet50/RetCCL weights: flax msgpack or torch .pth; uni2_h: a "
                        "timm-named state dict (UNI2-h's pytorch_model.bin)")
    p.add_argument("--head_ckpt", required=True,
                   help="head weights: flax msgpack or torch .pth")
    p.add_argument("--model", default="TransMIL",
                   help="head name: a ported bag head with per-tile attention (TransMIL, "
                        "AttMIL, Chowder, RoFormerMIL, AttTrans, CLAM_SB, CLAM_MB, MDMIL, DSMIL, "
                        "...)")
    p.add_argument("--n_classes", type=int, default=2,
                   help="the head's classes (the port reads them from the weights)")
    p.add_argument("--in_features", type=int, default=None,
                   help="the head's input width (default: the backbone's, 2048 or 1536)")
    p.add_argument("--out_features", type=int, default=512,
                   help="the head's width (the port reads it from the weights)")
    p.add_argument("--quantize", choices=["bf16", "int8", "int8_fused"], default=None,
                   help="the backbone's precision (default: int8 for retccl, bf16 for uni2_h, "
                        "which takes bf16 alone)")
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--tile_size", type=int, default=224)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--out_dir", default="inference_out")
    p.add_argument("--n_chips", type=int, default=1,
                   help="processes (one card each) for a tile-parallel embed")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def main(argv: list[str] | None = None) -> list[dict]:
    from transmil_deepgraft_tpu_torch.data import native_tiles
    from transmil_deepgraft_tpu_torch.data.tiles import imagenet_normalize, parse_coords
    from transmil_deepgraft_tpu_torch.device import resolve_device
    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline, decode_tile_paths
    from transmil_deepgraft_tpu_torch.models import MODEL_REGISTRY
    from transmil_deepgraft_tpu_torch.models.backbones import BACKBONE_DIMS, uni2_h_from_timm
    from transmil_deepgraft_tpu_torch.serving import head_from_params
    from transmil_deepgraft_tpu_torch.utils.torch_weights import (
        load_backbone_variables, load_head_params, load_torch_checkpoint)

    args = make_parser().parse_args(argv)
    vit = args.backbone == "uni2_h"
    if args.quantize is None:
        args.quantize = "bf16" if vit else "int8"
    if vit and args.quantize != "bf16":
        raise SystemExit(f"--quantize {args.quantize} quantizes the ResNet50 family; "
                         "--backbone uni2_h runs in bf16")
    if args.in_features is None:
        args.in_features = BACKBONE_DIMS[args.backbone]
    if args.model not in MODEL_REGISTRY:
        # JAX's create_model raises KeyError: the classic per-tile models are
        # not bag heads (ROADMAP C13), and neither package serves them
        raise SystemExit(f"--model {args.model}: unknown model, not a bag head; the port "
                         f"serves {sorted(MODEL_REGISTRY)}")
    if not MODEL_REGISTRY[args.model].gives_attention:
        raise SystemExit(f"--model {args.model} gives no per-tile attention for the top-k "
                         "tiles (JAX's cli.infer cannot run it either); serve it from a slide "
                         "bundle: cli.export_model --backbone_ckpt, then cli.serve")
    mesh, rank = None, 0
    if args.n_chips > 1:
        import torch

        on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
        cards = torch.cuda.device_count() if not on_cpu and torch.cuda.is_available() else 0
        if not on_cpu and cards < args.n_chips:
            raise SystemExit(f"--n_chips {args.n_chips} > available devices {cards}")
        if "WORLD_SIZE" not in os.environ:  # no launcher: start the processes here
            return _spawn(argv, args.n_chips, Path(args.out_dir))
        if int(os.environ["WORLD_SIZE"]) != args.n_chips:
            raise SystemExit(f"--n_chips {args.n_chips} under a launcher of WORLD_SIZE "
                             f"{os.environ['WORLD_SIZE']}: they must be equal")
        from transmil_deepgraft_tpu_torch.parallel.mesh import (
            init_multihost, make_mesh, rank_device)

        rank, _ = init_multihost(backend="gloo" if on_cpu else None)
        if not on_cpu:
            args.device = str(rank_device())
        mesh = make_mesh(dp=args.n_chips, device_type="cpu" if on_cpu else "cuda")
    device = resolve_device(args.device)  # before any weights are read
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    bb_vars = encoder = None
    if vit:
        encoder = uni2_h_from_timm(load_torch_checkpoint(args.backbone_ckpt))
    else:
        bb_vars = load_backbone_variables(args.backbone_ckpt)
    head = head_from_params(args.model,
                            load_head_params(args.head_ckpt, args.in_features, args.model),
                            args.in_features, device=device)

    root = Path(args.tiles_root)
    slides = sorted(d for d in root.iterdir() if d.is_dir())
    if not slides:
        raise SystemExit(f"no slide folders under {root}")

    pipeline = None
    results = []
    for slide_dir in slides:
        tile_paths = sorted(slide_dir.glob("*.jpg")) + sorted(slide_dir.glob("*.png"))
        if not tile_paths:
            continue
        if pipeline is None:
            # int8 calibration on the first slide's first 64 tiles (the only
            # tiles decoded up front; slides stream from disk)
            calib = None
            if args.quantize != "bf16":
                calib = imagenet_normalize(
                    decode_tile_paths(tile_paths[:min(64, len(tile_paths))], args.tile_size))
            pipeline = SlideInferencePipeline(
                bb_vars, head, backbone=encoder, calib_tiles=calib, chunk=args.chunk,
                fused_backbone=args.quantize == "int8_fused", device=device, mesh=mesh,
            )
        coords = None
        if pipeline.coord_aware:  # the real (x-y) file-name coords
            coords = np.asarray([parse_coords(p.name) for p in tile_paths], np.float32)
        probs, attn = pipeline.predict_slide_paths_with_attention(
            tile_paths, coords, tile_size=args.tile_size
        )
        order = np.argsort(attn)[::-1][:args.topk]
        topk_csv = out_dir / f"{slide_dir.name}_topk_tiles.csv"
        if rank == 0:
            with open(topk_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["tile", "x", "y", "attention"])
                for i in order:
                    x, y = parse_coords(tile_paths[i].name)
                    w.writerow([tile_paths[i].name, x, y, float(attn[i])])
        results.append(
            {
                "slide": slide_dir.name,
                "n_tiles": len(tile_paths),
                "probs": [float(p) for p in probs],
                "pred": int(np.argmax(probs)),
                "topk_csv": str(topk_csv),
            }
        )

    if rank == 0:
        (out_dir / "predictions.json").write_text(json.dumps(results, indent=2))
        decoder = "native libjpeg" if native_tiles.available() else "PIL"
        print(json.dumps({"slides": len(results), "out_dir": str(out_dir), "decoder": decoder,
                          "processes": args.n_chips}))
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return results


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv: list[str] | None, world: int, port: int) -> None:
    """One spawned process: torchrun's environment, then :func:`main`."""
    import torch

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if "OMP_NUM_THREADS" not in os.environ:  # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    main(argv)


def _spawn(argv: list[str] | None, world: int, out_dir: Path) -> list[dict]:
    """Start ``world`` processes of this command on a free local port, wait
    for all of them, and return rank 0's results."""
    import sys

    import torch.multiprocessing as mp

    # by the module's own name, so that the spawned processes import it even
    # when this one runs it as __main__
    from transmil_deepgraft_tpu_torch.cli.infer import _rank_main as target

    argv = sys.argv[1:] if argv is None else list(argv)
    mp.spawn(target, args=(argv, world, _free_port()), nprocs=world, join=True)
    return json.loads((out_dir / "predictions.json").read_text())


if __name__ == "__main__":
    main()
