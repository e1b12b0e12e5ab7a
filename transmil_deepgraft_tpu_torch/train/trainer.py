"""The experiment layer: train step, fit and test loops (port of ``train/trainer.py``).

As the JAX Trainer (and the reference's Lightning ``ModelInterface``):

- train step: soft-target loss (one-hot labels) through the model in train
  mode, backward, one micro-step of the optimizer (grad accumulation inside
  it, ``train/optimizers.py``); dropout on unless ``train_deterministic``,
  its mask drawn from a ``torch.Generator`` seeded from ``seed + 1``;
- validation/test: per-slide probabilities in eval mode (TransMIL's fused
  K1/K2 path on the card), slide CE loss, slide and patient AUROC (positive
  slide filter), classification reports, Youden-J thresholds persisted to
  ``val_thresholds.csv`` and read back at test, the result CSVs;
- early stopping on val_loss (``patience``, ``min_delta``); ReduceLROnPlateau
  with torch's semantics through the optimizer's ``lr_scale``
  (``reduce_lr_every``, ``reduce_lr_patience``, ``plateau_threshold``,
  ``min_lr_scale``); top-k checkpoints plus ``last.ckpt``, the full train
  state, which :meth:`Trainer.load_train_state` resumes;
- SIGTERM/SIGINT during ``fit``: the step in flight finishes, ``last.ckpt``
  gets the train state, and ``fit`` returns with ``preempted`` set;
- ``metrics.jsonl`` / ``metrics.csv`` rows with the JAX Trainer's keys.

Checkpoints are ``torch.save`` files; :meth:`Trainer.load_checkpoint` and
:meth:`Trainer.load_train_state` also read the flax-msgpack ``.ckpt`` files
of the JAX Trainer.

Not ported yet (ROADMAP A5): SWA, autosave, TensorBoard, figures, the top-k
attention tile export, tile-level aggregation, DTFD, coord-aware heads,
meshes and prefetch threads.
"""

from __future__ import annotations

import contextlib
import csv
import json
import signal
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.models.layers import Dropout
from transmil_deepgraft_tpu_torch.train.aggregation import aggregate_patients
from transmil_deepgraft_tpu_torch.train.losses import LossFn
from transmil_deepgraft_tpu_torch.train.metrics import auroc, classification_report, youden_j_threshold
from transmil_deepgraft_tpu_torch.train.optimizers import Optimizer
from transmil_deepgraft_tpu_torch.utils.checkpoints import CheckpointManager, read_checkpoint
from transmil_deepgraft_tpu_torch.utils.jax_params import optimizer_state_from_jax, state_dict_from_jax
from transmil_deepgraft_tpu_torch.utils.logging import MetricLogger

# Class names per task (ref ``code/utils/utils.py:37-53``), for the result CSVs.
LABEL_MAP: dict[str, dict[str, str]] = {
    "no_other": {"0": "Normal", "1": "TCMR", "2": "ABMR", "3": "Mixed", "4": "Viral"},
    "rejections": {"0": "TCMR", "1": "ABMR", "2": "Mixed"},
    "norm_rest": {"0": "Normal", "1": "Disease"},
    "rej_rest": {"0": "Rejection", "1": "Other"},
    "rest_rej": {"0": "Other", "1": "Rejection"},
    "norm_rej_rest": {"0": "Normal", "1": "Rejection", "2": "Other"},
    "big_three": {"0": "ccRCC", "1": "papRCC", "2": "chRCC"},
    "tcmr_abmr": {"0": "TCMR", "1": "ABMR"},
    "tcmr": {"0": "Other", "1": "TCMR"},
    "tcmr_viral": {"0": "TCMR", "1": "Viral"},
    "no_viral": {"0": "Normal", "1": "TCMR", "2": "ABMR", "3": "Mixed"},
}


@dataclass
class TrainerConfig:
    """The JAX Trainer's fields and defaults. ``autosave_async``,
    ``prefetch_batches``, ``eval_fn_cache``, ``epoch_figures`` and
    ``export_topk_tiles`` have no effect in the port; ``swa``,
    ``autosave_steps``, ``use_tensorboard``, ``tile_level`` and
    ``ckpt_backend='orbax'`` are refused (not ported yet, ROADMAP A5).
    Checkpoints are ``torch.save`` files whatever ``ckpt_backend`` says."""

    epochs: int = 200
    patience: int = 50
    grad_acc: int = 1
    seed: int = 2021
    log_dir: str = "logs/run"
    task: str = "norm_rest"
    reduce_lr_factor: float = 0.5
    reduce_lr_every: int = 10  # epochs between scheduler steps (ref frequency=10)
    reduce_lr_patience: int = 10  # bad STEPS before reduction (torch default)
    plateau_threshold: float = 1e-4  # torch rel-threshold for "improved"
    min_delta: float = 0.0  # EarlyStopping min_delta (ref utils.py:146)
    min_lr_scale: float = 1e-3
    swa: bool = False
    swa_start_frac: float = 0.75
    fast_dev_run: bool = False
    use_tensorboard: bool = False
    tile_level: bool = False
    eval_batch_size: int = 1
    export_topk_tiles: bool = True
    ckpt_backend: str = "msgpack"
    autosave_steps: int = 0
    handle_preemption: bool = True
    autosave_async: bool = True
    prefetch_batches: int = 2
    eval_fn_cache: int = 256
    epoch_figures: bool = True
    # train with dropout off (the composed fit-parity runs: torch and flax
    # dropout masks cannot be shared)
    train_deterministic: bool = False


def _refuse_unported(cfg: TrainerConfig) -> None:
    unported = {"swa": cfg.swa, "autosave_steps": cfg.autosave_steps > 0,
                "use_tensorboard": cfg.use_tensorboard, "tile_level": cfg.tile_level,
                "ckpt_backend='orbax'": cfg.ckpt_backend == "orbax"}
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"not ported yet (ROADMAP A5): {', '.join(asked)}")


_FIT_START = {"epoch": 0, "best_val_loss": float("inf"), "epochs_since_best": 0,
              "plateau_since_best": 0, "plateau_best": float("inf")}


def _write_csv(path: Path, columns: dict[str, list], index: bool) -> None:
    """Columns -> CSV, with a leading unnamed 0..n-1 index column when
    ``index`` (pandas' ``to_csv`` layout, which the JAX Trainer writes)."""
    names = list(columns)
    rows = zip(*columns.values()) if names else iter(())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(([""] if index else []) + names)
        for i, row in enumerate(rows):
            w.writerow(([i] if index else []) + list(row))


class Trainer:
    def __init__(self, model: torch.nn.Module, tx: Optimizer, datamodule: MILDataModule, *,
                 n_classes: int, loss_fn: LossFn, config: TrainerConfig,
                 model_name: str = "TransMIL") -> None:
        _refuse_unported(config)
        self.model = model
        self.tx = tx
        self.dm = datamodule
        self.n_classes = n_classes
        self.loss_fn = loss_fn
        self.cfg = config
        self.model_name = model_name
        self.device = next(model.parameters()).device
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator

        self.log_dir = Path(config.log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.logger = MetricLogger(self.log_dir)
        self.ckpts = CheckpointManager(self.log_dir / "checkpoints")
        self._resume_fit_state: Optional[dict] = None
        self.preempted = False
        (self.log_dir / "run_meta.json").write_text(json.dumps({
            "model": model_name, "n_classes": n_classes,
            "config": {k: str(v) for k, v in vars(config).items()},
            "torch": torch.__version__, "device": str(self.device),
        }, indent=2))

    # ------------------------------------------------------------ train step
    def _train_mode(self) -> None:
        """Train mode; with ``train_deterministic`` every dropout stays off."""
        self.model.train()
        if self.cfg.train_deterministic:
            for m in self.model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.eval()

    def loss(self, bags: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The train forward: (loss, logits) of one batch, in train mode."""
        self._train_mode()
        logits = self.model(bags)
        return self.loss_fn(logits, F.one_hot(labels, self.n_classes).float()), logits

    def train_step(self, bags: torch.Tensor, labels: torch.Tensor) -> tuple[float, np.ndarray]:
        """One micro-step: forward, backward, optimizer. Returns (loss, probs)."""
        for p in self.model.parameters():
            p.grad = None
        loss, logits = self.loss(bags, labels)
        loss.backward()
        self.tx.step()
        return loss.item(), torch.softmax(logits.detach(), dim=-1).cpu().numpy()

    def _batch_tensors(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        bags = torch.from_numpy(batch.bags).to(self.device)
        return bags, torch.as_tensor(batch.labels, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------ fit
    def fit(self) -> dict[str, float]:
        with self._preemption_guard():
            return self._fit()

    @contextlib.contextmanager
    def _preemption_guard(self):
        """SIGTERM/SIGINT during fit set ``_preempted``; the loop then saves
        the train state and returns. Installed on the main thread only and
        restored on exit; a second signal goes to the previous handler."""
        self._preempted = self.preempted = False
        if (not self.cfg.handle_preemption
                or threading.current_thread() is not threading.main_thread()):
            yield
            return
        prev = {}

        def on_signal(signum, frame):
            if self._preempted:
                handler = prev.get(signum)
                if callable(handler):
                    handler(signum, frame)
                else:
                    raise KeyboardInterrupt
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, on_signal)
        try:
            yield
        finally:
            for sig, handler in prev.items():
                signal.signal(sig, handler)

    def _train_state(self, epoch: int, fit: dict) -> dict:
        """What ``last.ckpt`` holds: weights, optimizer state, loop counters
        (``epoch`` is the first epoch a resumed fit runs)."""
        return {"model": self.model.state_dict(), "optimizer": self.tx.state_dict(),
                "fit": {**fit, "epoch": epoch}}

    def _preempt_return(self, history: dict, epoch: int, fit: dict, step: int = -1) -> dict:
        self.ckpts.save_last(self._train_state(epoch, fit))
        self.preempted = True
        self.logger.log(epoch, {"event": "preempted", "step": step})
        return {**history, "preempted": True}

    def _fit(self) -> dict[str, float]:
        if not self.tx.params:  # the optimizer binds the weights as they are now
            self.tx.init(self.model.parameters())
        fit = {**_FIT_START, **(self._resume_fit_state or {})}
        start_epoch = int(fit.pop("epoch"))
        lr_scale = self.tx.lr_scale  # restored with the optimizer state on resume
        history: dict[str, float] = {}
        n_epochs = 1 if self.cfg.fast_dev_run else self.cfg.epochs
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            # the dropout stream of an epoch depends on the epoch alone, so a
            # resumed run draws what a straight-through run draws
            self.dropout_generator.manual_seed(
                int(np.random.SeedSequence([self.cfg.seed + 1, epoch]).generate_state(1)[0]))
            losses, train_probs, train_labels = [], [], []
            for step, batch in enumerate(self.dm.train_batches(epoch)):
                loss, probs = self.train_step(*self._batch_tensors(batch))
                losses.append(loss)
                train_probs.append(probs)
                train_labels.append(batch.labels)
                if self._preempted:
                    return self._preempt_return(history, epoch, fit, step)
                if self.cfg.fast_dev_run:
                    break
            train_loss = float(np.mean(np.asarray(losses, np.float32)))
            tp, tl = np.concatenate(train_probs), np.concatenate(train_labels)

            val = self.evaluate("val")
            metrics = {
                "loss": train_loss,
                "train_auc": auroc(tp, tl, self.n_classes),
                "val_loss": val["loss"],
                "val_auc": val["auroc"],
                "val_patient_auc": val["patient_auroc"],
                "val_accuracy": val["patient_report"].accuracy,
                "lr_scale": lr_scale,
                "epoch_time_s": time.time() - t0,
            }
            self.logger.log(epoch, metrics)
            history = metrics

            # early stopping on val_loss, Lightning EarlyStopping semantics:
            # improvement iff current < best - min_delta
            if val["loss"] < fit["best_val_loss"] - self.cfg.min_delta:
                fit["best_val_loss"], fit["epochs_since_best"] = val["loss"], 0
            else:
                fit["epochs_since_best"] += 1
            stop = fit["epochs_since_best"] >= self.cfg.patience

            # ReduceLROnPlateau, torch's semantics (relative threshold, the
            # scheduler's own best, reduce when bad steps exceed patience),
            # stepped every reduce_lr_every epochs
            if (epoch + 1) % self.cfg.reduce_lr_every == 0:
                if val["loss"] < fit["plateau_best"] * (1.0 - self.cfg.plateau_threshold):
                    fit["plateau_best"], fit["plateau_since_best"] = val["loss"], 0
                else:
                    fit["plateau_since_best"] += 1
                if (fit["plateau_since_best"] > self.cfg.reduce_lr_patience
                        and lr_scale > self.cfg.min_lr_scale):
                    lr_scale = max(lr_scale * self.cfg.reduce_lr_factor, self.cfg.min_lr_scale)
                    self.tx.lr_scale = lr_scale
                    fit["plateau_since_best"] = 0

            self.ckpts.save_epoch(
                {"model": self.model.state_dict()}, epoch,
                {k: metrics[k] for k in ("val_loss", "val_auc", "val_accuracy")},
                last_obj=self._train_state(epoch + 1, fit),
            )
            if self._preempted:  # the end-of-epoch state is on disk already
                self.preempted = True
                self.logger.log(epoch, {"event": "preempted", "step": -1})
                return {**history, "preempted": True}
            if stop:
                break
        return history

    # --------------------------------------------------------- checkpoints
    def _in_features(self) -> int:
        return self.model._fc1[0].in_features

    def load_checkpoint(self, path: str | Path) -> None:
        """Weights only, from any checkpoint of the port (``{"model": ...}``)
        or of the JAX Trainer (flax msgpack ``{"params": ...}``, metric
        checkpoints and ``last.ckpt`` alike)."""
        obj = read_checkpoint(path)
        if "model" in obj:
            self.model.load_state_dict(obj["model"])
        elif "params" in obj:
            self.model.load_state_dict(state_dict_from_jax(obj["params"], self._in_features()))
        else:
            raise ValueError(f"no weights in checkpoint {path}")

    def load_train_state(self, path: str | Path) -> bool:
        """Restore a full train state (weights, optimizer state, epoch,
        early-stop and plateau counters, lr_scale) written by ``fit``, the
        port's or the JAX Trainer's; the next ``fit`` resumes from it.
        Returns False when ``path`` holds weights only (those are loaded)."""
        obj = read_checkpoint(path)
        self.load_checkpoint(path)
        if "fit" not in obj or not ("optimizer" in obj or "opt_state" in obj):
            return False
        self.tx.init(self.model.parameters())
        if "optimizer" in obj:
            state = obj["optimizer"]
        else:
            names = [n for n, _ in self.model.named_parameters()]
            state = optimizer_state_from_jax(obj["opt_state"], self._in_features(), names)
        self.tx.load_state_dict(state)
        fit = obj["fit"]
        self._resume_fit_state = {k: type(v)(np.asarray(fit[k])) for k, v in _FIT_START.items()
                                  if k in fit}
        return True

    # ------------------------------------------------------------------ eval
    def evaluate(self, mode: str, save_results: bool = False,
                 stage_name: Optional[str] = None) -> dict:
        all_probs, all_logits, all_labels, names, patients = [], [], [], [], []
        self.model.eval()
        with torch.inference_mode():
            for batch in self.dm.eval_batches(mode, batch_size=self.cfg.eval_batch_size):
                logits = self.model(self._batch_tensors(batch)[0])
                all_probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
                all_logits.append(logits.cpu().numpy())
                all_labels.append(batch.labels)
                names += batch.names
                patients += batch.patients
                if self.cfg.fast_dev_run and len(names) >= 2:
                    break
        probs = np.concatenate(all_probs)
        logits = np.concatenate(all_logits)
        labels = np.concatenate(all_labels)

        # slide-level CE loss (ref validation_step's cross_entropy_torch)
        mx = logits.max(-1, keepdims=True)
        logp = logits - np.log(np.exp(logits - mx).sum(-1, keepdims=True)) - mx
        loss = float(-np.mean(logp[np.arange(len(labels)), labels]))

        agg = aggregate_patients(probs, labels, names, patients, self.n_classes)
        thresholds = self._thresholds(mode, agg)
        result = {
            "loss": loss,
            "auroc": auroc(probs, labels, self.n_classes),
            "patient_auroc": auroc(agg.scores, agg.targets, self.n_classes),
            "slide_report": classification_report(probs, labels, self.n_classes),
            "patient_report": classification_report(agg.scores, agg.targets, self.n_classes),
            "thresholds": thresholds,
            "aggregate": agg,
        }
        if save_results:
            self._save_results(agg, mode=stage_name or mode)
            self._save_topk_patients(agg, thresholds, stage=stage_name or mode)
        return result

    def _thresholds(self, mode: str, agg) -> list[float]:
        """Youden-J operating points (ref load_thresholds): val stages compute
        them (binary on the positive class, else per class one-vs-rest) and
        persist ``val_thresholds.csv``; test stages read it back, else
        1/n_classes."""
        thresholds = [1.0 / self.n_classes] * self.n_classes
        path = self.log_dir / "val_thresholds.csv"
        if mode != "test" and len(np.unique(agg.targets)) > 1:
            if self.n_classes <= 2:
                *_, thr = youden_j_threshold(agg.scores[:, 1], agg.targets)
                thresholds = [thr, thr]
            else:
                for c in range(self.n_classes):
                    y = (agg.targets == c).astype(np.int64)
                    if y.min() != y.max():
                        *_, thresholds[c] = youden_j_threshold(agg.scores[:, c], y)
            _write_csv(path, {f"class_{c}": [thresholds[c]] for c in range(self.n_classes)},
                       index=False)
        elif mode == "test" and path.exists():
            with open(path, newline="") as f:
                row = next(csv.DictReader(f), {})
            loaded = [float(row[f"class_{c}"]) for c in range(self.n_classes) if f"class_{c}" in row]
            if len(loaded) == self.n_classes:
                thresholds = loaded
        return thresholds

    def test(self) -> dict:
        result = self.evaluate("test", save_results=True, stage_name="test")
        summary = {
            "test_loss": result["loss"],
            "test_auc": result["auroc"],
            "test_patient_auc": result["patient_auroc"],
            **result["patient_report"].as_dict("test_patient_"),
            **result["slide_report"].as_dict("test_slide_"),
        }
        (self.log_dir / "test_metrics.json").write_text(json.dumps(summary, indent=2))
        self.logger.log(-1, summary)
        return summary

    # ------------------------------------------------------------- reporting
    def _label_map(self) -> dict[str, str]:
        lm = dict(LABEL_MAP.get(self.cfg.task) or {})
        for i in range(self.n_classes):
            lm.setdefault(str(i), f"class_{i}")
        return {str(i): lm[str(i)] for i in range(self.n_classes)}

    def _save_results(self, agg, mode: str = "test") -> None:
        """``<MODE>_RESULT_PATIENT.csv`` / ``<MODE>_RESULT_SLIDE.csv``."""
        lm = self._label_map()
        patient: dict[str, list[Any]] = {"PATIENT": agg.patients, "yTrue": agg.targets.tolist()}
        for i in range(self.n_classes):
            patient[lm[str(i)]] = agg.scores[:, i].tolist()
        _write_csv(self.log_dir / f"{mode.upper()}_RESULT_PATIENT.csv", patient, index=True)
        rows: dict[str, list[Any]] = {"SLIDE": [], "yTrue": [], **{v: [] for v in lm.values()}}
        for p, t in zip(agg.patients, agg.targets):
            for slide_name, score in agg.slide_scores[p]:
                rows["SLIDE"].append(slide_name)
                rows["yTrue"].append(int(t))
                for j in range(self.n_classes):
                    rows[lm[str(j)]].append(float(score[j]))
        _write_csv(self.log_dir / f"{mode.upper()}_RESULT_SLIDE.csv", rows, index=True)

    def _save_topk_patients(self, agg, thresholds, stage: str = "test", k: int = 50) -> None:
        """Per-class top-k patient CSVs that seed the visualizer."""
        for c in range(self.n_classes):
            mask = agg.targets == c
            c_patients = np.array(agg.patients)[mask]
            c_scores = agg.scores[mask, c]
            order = np.argsort(-c_scores)[:min(k, len(c_scores))]
            keep = c_scores[order] > thresholds[c]
            _write_csv(self.log_dir / f"{stage}_c{c}_top_patients.csv",
                       {"Patient": c_patients[order][keep].tolist(),
                        "Scores": c_scores[order][keep].tolist()}, index=False)
