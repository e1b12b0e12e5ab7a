"""K-fold cross-validation and the logit-mean ensemble (port of
``train/kfold.py``; ref ``code/train_loop.py`` KFoldLoop and
EnsembleVotingModel).

The train split is cut into ``nfold`` folds; each fold trains a fresh
trainer on the others and validates on itself, then tests; its weights go to
``model.{fold}.pt``. The ensemble averages the fold models' logits on the
test split. The splits are scikit-learn's ``KFold(shuffle=True,
random_state=seed)``, reproduced without scikit-learn (:func:`kfold_splits`).
The top-k attention tile export of the JAX ensemble is not ported (ROADMAP A9).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.data.datamodule import Batch, MILDataModule, collate
from transmil_deepgraft_tpu_torch.data.sampler import ImbalancedSampler
from transmil_deepgraft_tpu_torch.train.aggregation import aggregate_patients
from transmil_deepgraft_tpu_torch.train.metrics import auroc, classification_report
from transmil_deepgraft_tpu_torch.utils.checkpoints import read_checkpoint, save_checkpoint


def kfold_splits(n: int, nfold: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(train, val) indices of ``sklearn.model_selection.KFold(nfold,
    shuffle=True, random_state=seed).split(range(n))``: a RandomState(seed)
    shuffle of 0..n-1 cut into consecutive folds, the first ``n % nfold``
    one longer; each side comes back sorted."""
    if not 2 <= nfold <= n:
        raise ValueError(f"cannot cut {n} slides into {nfold} folds")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(nfold, n // nfold)
    sizes[:n % nfold] += 1
    splits, start = [], 0
    for size in sizes:
        val = np.zeros(n, bool)
        val[order[start:start + size]] = True
        splits.append((np.flatnonzero(~val), np.flatnonzero(val)))
        start += size
    return splits


class FoldDataModule:
    """A base MILDataModule restricted to a fold's train and val indices of
    the train split (ref ``data_interface.py:416-419``)."""

    def __init__(self, base: MILDataModule, train_idx: np.ndarray, val_idx: np.ndarray) -> None:
        self.base = base
        self.train_idx = train_idx
        self.val_idx = val_idx
        self.n_classes = base.n_classes
        self.batch_size = base.batch_size
        self.eval_pad = base.eval_pad

    def train_batches(self, epoch: int) -> Iterator[Batch]:
        ds = self.base.dataset("train")
        rng = np.random.default_rng((self.base.seed, epoch))
        labels = [ds.get_labels()[i] for i in self.train_idx]
        if self.base.use_imbalanced_sampler:
            order = self.train_idx[ImbalancedSampler(labels, self.n_classes).sample_epoch(rng)]
        else:
            order = rng.permutation(self.train_idx)
        bs = self.batch_size
        for start in range(0, len(order) - bs + 1, bs):
            yield collate([ds.get_item(int(i), rng) for i in order[start:start + bs]],
                          eval_pad="exact")

    def eval_batches(self, mode: str, batch_size: int = 1) -> Iterator[Batch]:
        if mode != "val":
            yield from self.base.eval_batches(mode, batch_size)
            return
        ds = self.base.dataset("train")
        rng = np.random.default_rng(0)
        for start in range(0, len(self.val_idx), batch_size):
            items = [ds.get_item(int(i), rng) for i in self.val_idx[start:start + batch_size]]
            yield collate(items, eval_pad=self.eval_pad)

    def steps_per_epoch(self) -> int:
        return len(self.train_idx) // self.batch_size

    def dataset(self, mode: str):
        return self.base.dataset(mode)


@dataclass
class KFoldResult:
    fold_metrics: list[dict]
    ensemble_metrics: dict
    checkpoint_paths: list[Path]


class KFoldPreempted(RuntimeError):
    """A fold's fit was stopped by SIGTERM/SIGINT: its train state is in
    ``fold_dir``; the folds before it have their ``model.{fold}.pt``."""

    def __init__(self, fold: int, fold_dir: Path) -> None:
        super().__init__(f"k-fold run preempted during fold {fold} (state in {fold_dir})")
        self.fold = fold
        self.fold_dir = fold_dir


def run_kfold(build_trainer: Callable, dm: MILDataModule, nfold: int,
              export_dir: str | Path, seed: int = 2021) -> KFoldResult:
    """Per-fold fit + test, then the logit-mean ensemble of the fold models
    on the test split. ``build_trainer(fold_dm, log_dir)`` makes a fresh
    trainer for each fold."""
    export_dir = Path(export_dir)
    export_dir.mkdir(parents=True, exist_ok=True)
    fold_metrics: list[dict] = []
    paths: list[Path] = []
    trainer = None
    for fold, (train_idx, val_idx) in enumerate(kfold_splits(len(dm.dataset("train")), nfold,
                                                             seed)):
        trainer = build_trainer(FoldDataModule(dm, train_idx, val_idx),
                                str(export_dir / f"fold{fold}"))
        trainer.fit()
        if trainer.preempted:
            raise KFoldPreempted(fold, export_dir / f"fold{fold}")
        fold_metrics.append(trainer.test())
        path = export_dir / f"model.{fold}.pt"
        save_checkpoint(path, {"model": trainer.model.state_dict()})
        paths.append(path)

    # the ensemble: the last fold's model takes each fold's weights in turn
    model = trainer.model
    fold_weights = [read_checkpoint(p)["model"] for p in paths]
    model.eval()
    probs_l, labels_l, names, patients = [], [], [], []
    with torch.inference_mode():
        for batch in dm.eval_batches("test"):
            bags = torch.from_numpy(batch.bags).to(trainer.device)
            logits = []
            for weights in fold_weights:
                model.load_state_dict(weights)
                logits.append(model(bags).float())
            probs_l.append(torch.softmax(torch.stack(logits).mean(0), -1).cpu().numpy())
            labels_l.append(batch.labels)
            names += batch.names
            patients += batch.patients
    probs, labels = np.concatenate(probs_l), np.concatenate(labels_l)
    agg = aggregate_patients(probs, labels, names, patients, dm.n_classes)
    ensemble = {
        "ensemble_auc": auroc(probs, labels, dm.n_classes),
        "ensemble_patient_auc": auroc(agg.scores, agg.targets, dm.n_classes),
        **classification_report(agg.scores, agg.targets, dm.n_classes).as_dict("ensemble_patient_"),
    }
    (export_dir / "ensemble_metrics.json").write_text(json.dumps(ensemble, indent=2))
    trainer._save_results(agg, mode="ensemble")
    trainer._save_topk_patients(agg, [1.0 / dm.n_classes] * dm.n_classes, stage="ensemble")
    return KFoldResult(fold_metrics, ensemble, paths)
