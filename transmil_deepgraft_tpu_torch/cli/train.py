"""Training CLI (port of ``cli/train.py``):
``python -m transmil_deepgraft_tpu_torch.cli.train --stage train --config <yaml>``.

The argparse surface and the dispatch of the JAX CLI (ref
``code/train.py``): read the YAML (the JAX package's configs parse as they
are), apply the config surgery (task from the file name, ``in_features`` per
extractor, the log-path tree), build the data module, model, optimizer and
Trainer, and run the stage:

- ``train``: fit, then test (``--resume_training`` resumes ``last.ckpt``);
  with ``Data.cross_val``, k-fold training and the fold ensemble;
- ``fine_tune``: the checkpoint of ``--epoch`` (or ``last.ckpt``), then
  ``General.ft_epochs`` epochs over train + test_mixin;
- ``test`` / ``val``: every ``checkpoints/*.ckpt`` of the log dir (the
  port's, or the JAX Trainer's msgpack ones), evaluated with result CSVs.

Runs on the card unless ``--device cpu``. Every bag head trains but MDMIL
(JAX's Trainer fails on it, ROADMAP C9): TransMIL, TransformerMIL, AttMIL,
Chowder, RoFormerMIL (with the bags' tile coordinates), AttTrans/
MonaiMILModel, CLAM_SB/MB (on the bag loss, as JAX's), DSMIL, DTFD (batch 1,
``create_dtfd_optimizer``), and CTMIL and ``resnet50`` on the spatial
variant's feature volumes. ``General.precision`` 16 or ``16-mixed`` trains a
bfloat16-compute TransMIL, and the other heads in float32, as the JAX
package's ``create_model`` does. ``Data.variant: images`` trains a head
behind a frozen tile backbone (``Model.backbone``: retccl, resnet50,
resnet18, simple, vit/dino, efficientnet or inception;
``Model.backbone_weights`` a .pth in the reference's names or a flax msgpack
file)
on JPEG tile folders, ``image_bags`` on legacy HDF5/npy tile stacks, and
``Data.dataset_name: camelyon`` reads Camelyon16's fold CSVs.
``Data.variant: tiles`` is the classic per-tile pipeline: the classifier of
``Model.backbone`` (vit, resnet18, efficientnet, inception, ...) over single
tiles, its BatchNorm trained, eval aggregated tile -> slide -> patient. As
in JAX, ``Model.name`` must still be a bag head (which that route builds and
drops): the classic configs, whose ``Model.name`` is the network, raise
JAX's KeyError (ROADMAP C13).

Data-parallel training runs one process a card under torchrun:
``torchrun --nproc_per_node k -m transmil_deepgraft_tpu_torch.cli.train
--config C.yaml`` (each process on ``cuda:LOCAL_RANK``, NCCL; with
``--device cpu`` gloo processes on the CPU). dp is the world size, which must
divide the configured batch: JAX's CLI takes ``gcd(batch, devices)`` of the
devices of one process, while here every launched process must train
(ROADMAP C23).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TransMIL-DeepGraft training (PyTorch port)")
    p.add_argument("--stage", default="train", choices=["train", "test", "val", "fine_tune"])
    p.add_argument("--config", required=True)
    p.add_argument("--version", type=int, default=None)
    p.add_argument("--epoch", default=None)
    p.add_argument("--loss", default=None)
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--bag_size", type=int, default=None)
    p.add_argument("--label_file", default=None)
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--fine_tune", action="store_true")
    p.add_argument("--fast_dev_run", action="store_true")
    p.add_argument("--log_dir", default=None, help="override the derived log path")
    p.add_argument("--check_home", action="store_true",
                   help="re-root absolute data/log paths onto this host's mount root")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the stage to DIR/trace.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


# the optional ``cfg.Model`` knobs, forwarded to the heads that take them
# (JAX cli/train.py:57-70): TransMIL's use_pallas/fused_inference,
# RoFormerMIL's num_landmarks/depth/..., TransformerMIL's pool/dropout
MODEL_KNOBS = ("use_pallas", "fused_inference", "num_landmarks", "depth", "heads", "dim_head",
               "mlp_dim", "pool", "dropout", "rope_base")


def _model_extras(cfg, model_name: str) -> dict:
    """The ``cfg.Model`` knobs the head's constructor declares; the others
    are ignored, so one YAML schema serves every head."""
    import inspect

    from transmil_deepgraft_tpu_torch.models import MODEL_REGISTRY

    cls = MODEL_REGISTRY.get(model_name)
    if cls is None:
        return {}
    declared = inspect.signature(cls.__init__).parameters
    return {k: cfg.Model[k] for k in MODEL_KNOBS if k in declared and k in cfg.Model}


def _join(batch_size: int, device: str | None):
    """Under a launcher: join the group and make the dp mesh; returns
    (mesh, device). A single process returns (None, device)."""
    import os

    from transmil_deepgraft_tpu_torch.parallel.mesh import (
        init_multihost, make_mesh, rank_device)

    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1 and batch_size % world:
        fits = max(d for d in range(1, world + 1) if batch_size % d == 0)
        raise SystemExit(f"data-parallel training needs the world size to divide the batch: "
                         f"batch {batch_size}, world {world}; launch {fits} processes "
                         f"(ROADMAP C23)")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    _, world = init_multihost(backend="gloo" if on_cpu else None)
    if world == 1:
        return None, device
    return (make_mesh(dp=world, device_type="cpu" if on_cpu else "cuda"),
            device if on_cpu else str(rank_device()))


def _mesh_kw(mesh) -> dict:
    """``build``'s mesh argument, passed only when there is a mesh (a
    single process calls ``build`` as before)."""
    return {} if mesh is None else {"mesh": mesh}


def build(cfg, log_dir: str | None = None, device: str | None = None, mesh=None):
    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
    from transmil_deepgraft_tpu_torch.device import resolve_device
    from transmil_deepgraft_tpu_torch.models import (
        CLASSIC_NAMES, SPATIAL_HEADS, ImageMILModel, create_backbone, create_classic_model,
        create_model)
    from transmil_deepgraft_tpu_torch.train.losses import create_loss
    from transmil_deepgraft_tpu_torch.train.optimizers import (
        create_dtfd_optimizer, create_optimizer_from_config)
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig
    from transmil_deepgraft_tpu_torch.utils.torch_weights import load_image_backbone_variables

    n_classes = int(cfg.Model.n_classes)
    in_features = int(cfg.Model.in_features or 2048)
    out_features = int(cfg.Model.out_features or 512)
    model_name = str(cfg.Model.name)
    is_dtfd = model_name in ("DTFD", "DTFDMIL")
    dev = resolve_device(device)
    seed = int(cfg.General.seed or 2021)

    synthetic = cfg.Data.synthetic.to_dict() if cfg.Data.synthetic else None
    if synthetic is not None:
        synthetic.setdefault("feature_size", in_features)
    batch_size = int(cfg.Data.train_dataloader.batch_size or 1)
    dm = MILDataModule(
        data_dir=str(cfg.Data.data_dir) if cfg.Data.data_dir else None,
        label_path=str(cfg.Data.label_file) if cfg.Data.label_file else None,
        n_classes=n_classes,
        max_bag_size=int(cfg.Data.bag_size or 1000),
        batch_size=batch_size,
        mixup=bool(cfg.Data.mixup),
        feature_extractor=(f"FEATURES_{str(cfg.Data.feature_extractor).upper()}_{in_features}"
                           if cfg.Data.feature_extractor else None),
        slide_patient_path=str(cfg.Data.patient_dict) if cfg.Data.patient_dict else None,
        seed=seed,
        synthetic=synthetic,
        fine_tune=bool(cfg.fine_tune),
        dataset_name=str(cfg.Data.dataset_name or "custom"),
        fold=int(cfg.Data.fold or 0),
        # inception takes 299x299 tiles (ref classic_jpg_dataloader.py)
        tile_size=int(cfg.Data.tile_size or (299 if model_name == "inception" else 224)),
        # the variant by name (JAX cli/train.py:104-118): single tiles for a
        # classic network (which create_model then refuses, ROADMAP C13),
        # spatial feature volumes for CTMIL/resnet50, else feature bags
        variant=str(cfg.Data.variant
                    or ("tiles" if model_name in CLASSIC_NAMES
                        else "spatial" if model_name in SPATIAL_HEADS else "features")),
    )
    if dm.variant in ("images", "tiles"):
        dm.eval_pad = "exact"  # image bags: bucketing to 2^k tiles wastes backbone compute
    if is_dtfd and dm.batch_size != 1:
        # DTFD takes one slide at a time (ref model_interface_dtfd.py:183)
        print(f"[cli] DTFD requires batch_size=1 (configured {dm.batch_size}); clamping")
        dm.batch_size = 1
    backbone_name = str(cfg.Model.backbone or "features")
    images = dm.variant == "images" and backbone_name != "features"
    tiles = dm.variant == "tiles"

    def head(in_f: int):
        return create_model(model_name, n_classes=n_classes, in_features=in_f,
                            out_features=out_features, device=dev,
                            precision=cfg.General.precision or None,
                            **_model_extras(cfg, model_name))

    # the initial weights come from the config's seed (JAX: key(seed)), drawn
    # on the CPU, without touching the caller's random state
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = head(in_features)
        if images:
            # the backbone in the graph (ref model_interface.py:297-317): tiles
            # stream through the frozen backbone into the head, rebuilt for
            # the backbone's width (JAX cli/train.py:135-149)
            backbone, feat_dim = create_backbone(backbone_name, out_features=out_features)
            if feat_dim != in_features:
                model = head(feat_dim)
            model = ImageMILModel(backbone, model).to(dev)
        elif tiles:  # the classic per-tile classifier replaces the head (JAX :150-153)
            model = create_classic_model(backbone_name, n_classes, dev)
    loss_fn = create_loss(str(cfg.Loss.base_loss or "CrossEntropyLoss"))
    grad_acc = int(cfg.General.grad_acc or 1)
    if is_dtfd:
        # the two tier-wise Adams (JAX cli/train.py:157-163): its epoch is
        # n_train synthetic bags or 100 steps, whatever the cohort, and
        # General.grad_acc is not applied (ROADMAP C10)
        steps = max(1, (int(cfg.Data.synthetic.n_train or 32) if cfg.Data.synthetic else 100)
                    // int(cfg.Data.train_dataloader.batch_size or 1))
        tx = create_dtfd_optimizer(steps_per_epoch=steps)
    else:
        tx = create_optimizer_from_config(cfg.Optimizer, grad_accum_steps=grad_acc)
    tcfg = TrainerConfig(
        epochs=int(cfg.General.epochs or 200),
        patience=int(cfg.General.patience or 50),
        grad_acc=grad_acc,
        seed=seed,
        log_dir=log_dir or str(cfg.log_path or "logs/run"),
        task=str(cfg.task or "norm_rest"),
        fast_dev_run=bool(cfg.fast_dev_run),
        eval_batch_size=int(cfg.Data.test_dataloader.batch_size or 1),
        tile_level=tiles,
    )
    # data parallelism: one process a card under torchrun (main joins the
    # group), the batch split over the world
    trainer = Trainer(model, tx, dm, n_classes=n_classes, loss_fn=loss_fn, config=tcfg,
                      model_name=model_name, mesh=mesh)
    if images and cfg.Model.backbone_weights:
        # pretrained frozen-backbone weights (ref model_interface.py:237-267)
        trainer.set_backbone_variables(
            load_image_backbone_variables(str(cfg.Model.backbone_weights), backbone_name))
    return trainer


def main(argv: list[str] | None = None) -> dict:
    from transmil_deepgraft_tpu_torch.utils.config import check_home, finalize_config, read_yaml

    args = make_parser().parse_args(argv)
    cfg = read_yaml(args.config)
    if args.check_home:
        cfg = check_home(cfg)
    cfg = finalize_config(
        cfg, config_path=args.config, stage=args.stage, fold=args.fold,
        version=args.version, loss=args.loss, epoch=args.epoch,
        fine_tune=args.fine_tune or args.stage == "fine_tune",
        resume_training=args.resume_training, fast_dev_run=args.fast_dev_run,
        label_file=args.label_file,
    )
    if args.bag_size:
        cfg.Data.bag_size = args.bag_size

    mesh, args.device = _join(int(cfg.Data.train_dataloader.batch_size or 1), args.device)
    trainer = build(cfg, log_dir=args.log_dir, device=args.device, **_mesh_kw(mesh))
    if not args.profile:
        return _dispatch(args, cfg, trainer)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = _dispatch(args, cfg, trainer)
    Path(args.profile).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(args.profile) / "trace.json"))
    return result


def _dispatch(args, cfg, trainer) -> dict:
    if args.stage in ("train", "fine_tune") and cfg.Data.cross_val:
        # k-fold cross-validation + the fold ensemble (ref train.py:256-260)
        from transmil_deepgraft_tpu_torch.train.kfold import KFoldPreempted, run_kfold

        def build_for_fold(fold_dm, log_dir):
            t = build(cfg, log_dir=log_dir, device=args.device, **_mesh_kw(trainer.mesh))
            t.dm = fold_dm
            return t

        try:
            result = run_kfold(build_for_fold, trainer.dm, nfold=int(cfg.Data.nfold or 3),
                               export_dir=Path(trainer.cfg.log_dir) / "kfold",
                               seed=int(cfg.General.seed or 2021))
        except KFoldPreempted as e:
            out = {"event": "preempted", "fold": e.fold, "resume_dir": str(e.fold_dir)}
            print(json.dumps(out))
            return out
        print(json.dumps(result.ensemble_metrics, default=float))
        return result.ensemble_metrics

    ckpt_dir = Path(trainer.cfg.log_dir) / "checkpoints"
    if args.stage == "fine_tune":
        # ref fine_tune.py: the checkpoint of --epoch, then ft_epochs over
        # train + test_mixin (the data module is in fine_tune mode already)
        trainer.cfg.epochs = int(cfg.General.ft_epochs or 20)
        if args.epoch not in (None, "last"):
            matches = sorted(ckpt_dir.glob(f"epoch={int(args.epoch):02d}*.ckpt"))
            if matches:
                trainer.load_checkpoint(matches[0])
        elif (ckpt_dir / "last.ckpt").exists():
            trainer.load_checkpoint(ckpt_dir / "last.ckpt")

    if args.stage in ("train", "fine_tune"):
        if args.resume_training and trainer.ckpts.last_path().exists():
            trainer.load_train_state(trainer.ckpts.last_path())
        history = trainer.fit()
        if trainer.preempted:  # the state is in last.ckpt: resume, do not test
            out = {"event": "preempted", **{k: v for k, v in history.items() if k != "preempted"}}
            print(json.dumps(out, default=float))
            return out
        summary = trainer.test()
        print(json.dumps({**history, **summary}, default=float))
        return summary

    # test/val: every checkpoint of the log dir (ref train.py:273-327)
    candidates = sorted(ckpt_dir.glob("*.ckpt")) if ckpt_dir.exists() else []
    if args.epoch is not None and args.epoch != "last":
        candidates = [c for c in candidates if f"epoch={int(args.epoch):02d}" in c.name]
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    results = {}
    mode = "test" if args.stage == "test" else "val"
    for ckpt in candidates:
        trainer.load_checkpoint(ckpt)
        res = trainer.evaluate(mode, save_results=True, stage_name=f"{mode}_{ckpt.stem}")
        results[ckpt.name] = {"auroc": res["auroc"], "patient_auroc": res["patient_auroc"]}
        print(ckpt.name, json.dumps(results[ckpt.name]))
    return results


if __name__ == "__main__":
    main()
