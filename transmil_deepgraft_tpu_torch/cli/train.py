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

Runs on the card unless ``--device cpu``. ``General.precision`` 16 or
``16-mixed`` trains a bfloat16-compute TransMIL. The other heads, DTFD and the
non-feature dataset variants are not ported yet and raise (ROADMAP A6/A7).
"""

from __future__ import annotations

import argparse
import json
import math
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


def _model_extras(cfg) -> dict:
    """The ``cfg.Model`` knobs TransMIL's constructor takes (JAX forwards
    each knob the head declares; the other heads' knobs are theirs)."""
    return {k: cfg.Model[k] for k in ("use_pallas", "fused_inference") if k in cfg.Model}


def build(cfg, log_dir: str | None = None, device: str | None = None):
    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
    from transmil_deepgraft_tpu_torch.device import resolve_device
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.train.losses import create_loss
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer_from_config
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig

    n_classes = int(cfg.Model.n_classes)
    in_features = int(cfg.Model.in_features or 2048)
    out_features = int(cfg.Model.out_features or 512)
    model_name = str(cfg.Model.name)
    if model_name in ("DTFD", "DTFDMIL"):
        raise NotImplementedError("DTFD (a batch-1 head with two optimizers) is not ported "
                                  "yet (ROADMAP A7)")
    if model_name != "TransMIL":
        raise NotImplementedError(f"Model.name {model_name!r}: the port trains TransMIL; the "
                                  "other heads are ROADMAP A7")
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
        tile_size=int(cfg.Data.tile_size or 224),
        # JAX picks the variant by head (spatial for CTMIL/resnet50, tiles for
        # the classic CNNs); TransMIL reads feature bags
        variant=str(cfg.Data.variant or "features"),
    )
    # the initial weights come from the config's seed (JAX: key(seed)), drawn
    # on the CPU, without touching the caller's random state
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model(model_name, n_classes=n_classes, in_features=in_features,
                             out_features=out_features, device=dev,
                             precision=cfg.General.precision or None,
                             **_model_extras(cfg))
    loss_fn = create_loss(str(cfg.Loss.base_loss or "CrossEntropyLoss"))
    grad_acc = int(cfg.General.grad_acc or 1)
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
    )
    # JAX shards the batch over gcd(batch, devices) devices; the port trains
    # on one card (data parallelism is ROADMAP A10)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if math.gcd(batch_size, cards) > 1:
        print(f"[cli] training on {dev} alone of {cards} cards (multi-GPU is ROADMAP A10)")
    return Trainer(model, tx, dm, n_classes=n_classes, loss_fn=loss_fn, config=tcfg,
                   model_name=model_name)


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

    trainer = build(cfg, log_dir=args.log_dir, device=args.device)
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
            t = build(cfg, log_dir=log_dir, device=args.device)
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
