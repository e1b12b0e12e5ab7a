"""The experiment layer: train step, fit and test loops (port of ``train/trainer.py``).

As the JAX Trainer (and the reference's Lightning ``ModelInterface``):

- train step: soft-target loss (one-hot labels) through the model in train
  mode, backward, one micro-step of the optimizer (grad accumulation inside
  it, ``train/optimizers.py``); dropout on unless ``train_deterministic``,
  its mask drawn from a ``torch.Generator`` seeded from ``seed + 1``;
- the forward is the head's own: a coord-aware head (RoFormerMIL) gets
  ``Batch.padded_coords`` as its second argument, or the square-grid
  fallback when the batch has none, as the JAX Trainer stages them;
- an ``ImageMILModel`` (the ``images`` variant) streams the tiles through its
  frozen backbone; :meth:`Trainer.set_backbone_variables` loads pretrained
  backbone weights. As in JAX, the backbone's parameters are in the
  optimizer with zero gradients, so coupled L2 weight decay still moves its
  conv kernels (ROADMAP C11);
- batches are produced, and copied to the device from pinned memory on a
  side stream, by a prefetch thread up to ``prefetch_batches`` (at least
  1) ahead (``data/pipeline.device_prefetch``);
- DTFD (``model_name`` DTFD/DTFDMIL, with ``create_dtfd_optimizer``): the
  loss is ``(slide loss + the pseudo-bags' loss against the slide's label) /
  2`` (ref ``model_interface_dtfd.py:268``), eval takes the slide logits,
  and the pseudo-bag split draws from a ``torch.Generator`` seeded from
  ``seed + 2`` (JAX's ``shuffle`` stream), the identity under
  ``train_deterministic``;
- BatchNorm models (the CTMIL and ``resnet50`` heads, the classic tile
  classifiers over resnet18, efficientnet and inception) train with flax's
  BatchNorm rule and keep their running statistics in every checkpoint
  (JAX's Trainer cannot train them, ROADMAP C6); MDMIL is refused, as JAX's
  Trainer fails on it (its forward returns the attention by default,
  ROADMAP C9);
- the classic per-tile pipeline (a ``models/classic`` classifier on the
  ``tiles`` variant, ``tile_level=True``): the per-tile probabilities
  aggregate to slides, then patients (``aggregate_tiles_to_patients``);
- validation/test: per-slide probabilities in eval mode (TransMIL's fused
  K1/K2 path on the card), slide CE loss, slide and patient AUROC (positive
  slide filter), classification reports, Youden-J thresholds persisted to
  ``val_thresholds.csv`` and read back at test, the result CSVs;
- a stage that saves results (test, ``cli.train --stage test|val``) of a
  head with an attention query (TransMIL, RoFormerMIL) runs the
  ``return_attn`` forward (the standard layers: B5/B6 under ``use_pallas``
  on the card, not K1/K2) and writes each slide's top-k attended tiles to
  ``topk_tiles/<slide>_topk_tiles.csv`` (``export_topk_tiles``);
- figures (``epoch_figures``): val patient ROC/PR each epoch and the train
  confusion matrix every 10th under ``figures/``, the test stage's
  ROC/PR/confusion beside the result CSVs; a figure that fails (no
  matplotlib) is skipped with a printed line, never failing the run;
- early stopping on val_loss (``patience``, ``min_delta``); ReduceLROnPlateau
  with torch's semantics through the optimizer's ``lr_scale``
  (``reduce_lr_every``, ``reduce_lr_patience``, ``plateau_threshold``,
  ``min_lr_scale``); top-k checkpoints plus ``last.ckpt``, the full train
  state, which :meth:`Trainer.load_train_state` resumes;
- SIGTERM/SIGINT during ``fit``: the step in flight finishes, ``last.ckpt``
  gets the train state, and ``fit`` returns with ``preempted`` set;
- ``autosave_steps``: every n micro-steps ``last.ckpt`` gets the train state
  with the current epoch (a resume restarts that epoch, as JAX's), copied to
  the host in the step loop and written by a daemon thread, one write in
  flight at most (``autosave_async``; else inline); the thread is joined
  before each epoch's checkpoints, at preemption and at the end of ``fit``,
  and a failed write raises at that join;
- ``swa``: after each epoch from ``int(swa_start_frac * epochs)`` on, a
  running mean of the parameters; at the end of ``fit`` the model takes it
  and ``last.ckpt`` is rewritten with the weights alone;
- AdaHessian (an ``adahessian`` optimizer, JAX's ``needs_hessian``): each
  micro-step also takes the Hutchinson diagonal of the same loss
  (``train/adahessian.py``, one forward, the probes from a
  ``torch.Generator`` seeded from ``seed + 7`` and the epoch), handed to
  the optimizer's step; a head JAX's AdaHessian cannot differentiate is
  refused when the Trainer is built (ROADMAP C18);
- ``metrics.jsonl`` / ``metrics.csv`` rows with the JAX Trainer's keys, and
  with ``use_tensorboard`` the same scalars through tensorboardX under
  ``tb/``;
- data parallelism (``mesh=``, a ``parallel.mesh.make_mesh`` mesh, one
  process a card): each process takes its contiguous 1/dp slice of every
  global batch (``MILDataModule.train_batches(shard=)``) and its loss is the
  mean over its slice; at each optimizer step the accumulated gradients are
  averaged over dp in one ``all_reduce`` of a flattened buffer (the
  optimizer's ``grad_reduce``; both tiers of DTFD's, and AdaHessian's
  Hessian diagonal too), so the update is the global batch's, as JAX's dp
  mesh computes it. During the train step the Newton-Schulz divisor
  (``ops/pinv.divisor_reduced_over``) and the flax-rule BatchNorm's batch
  statistics (``models/resnet.batch_stats_reduced_over``) are reduced over
  dp, so dp training equals one-process training. Eval takes whole batches
  a process and gathers logits, names and attention rows in bag order, so
  every process takes the same early-stop, plateau, SWA and checkpoint
  decisions; the SIGTERM flag is reduced (MAX) each step, so every process
  stops at the same step. Only rank 0 writes checkpoints, metrics,
  TensorBoard, figures, top-k tiles, thresholds and autosaves; a resume
  reads ``last.ckpt`` on every rank. Dropout masks are drawn per process
  (``seed + 1``, the epoch and the rank), where JAX's GSPMD draws one global
  mask (ROADMAP C22).

Checkpoints are ``torch.save`` files; :meth:`Trainer.load_checkpoint` and
:meth:`Trainer.load_train_state` also read the flax-msgpack ``.ckpt`` files
of the JAX Trainer.

Not ported: ``ckpt_backend='orbax'`` (refused: neither machine has orbax).
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
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.data.pipeline import device_prefetch, to_device
from transmil_deepgraft_tpu_torch.models import head_logits
from transmil_deepgraft_tpu_torch.models.backbones import ImageMILModel, load_backbone_variables
from transmil_deepgraft_tpu_torch.models.classic import ClassicTileClassifier
from transmil_deepgraft_tpu_torch.models.dtfd import PseudoBagShuffle
from transmil_deepgraft_tpu_torch.models.layers import Dropout
from transmil_deepgraft_tpu_torch.models.resnet import batch_stats_reduced_over
from transmil_deepgraft_tpu_torch.ops.pinv import divisor_reduced_over
from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank, axis_size
from transmil_deepgraft_tpu_torch.train.adahessian import (
    refuse_custom_vjp_heads, value_grad_and_diag_hessian)
from transmil_deepgraft_tpu_torch.train.aggregation import (
    aggregate_patients, aggregate_tiles_to_patients)
from transmil_deepgraft_tpu_torch.train.losses import LossFn
from transmil_deepgraft_tpu_torch.train.metrics import auroc, classification_report, youden_j_threshold
from transmil_deepgraft_tpu_torch.train.optimizers import Optimizer
from transmil_deepgraft_tpu_torch.utils.checkpoints import CheckpointManager, read_checkpoint
from transmil_deepgraft_tpu_torch.utils.config import LABEL_MAP
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    classic_state_dict_from_jax, head_state_dict_from_jax, optimizer_state_from_jax)
from transmil_deepgraft_tpu_torch.utils.logging import MetricLogger
from transmil_deepgraft_tpu_torch.utils.profiling import span


@dataclass
class TrainerConfig:
    """The JAX Trainer's fields and defaults. ``eval_fn_cache`` has no
    effect in the port; ``prefetch_batches`` is the prefetch thread's
    depth, and 0 counts as 1 (the port always stages batches on that
    thread); ``ckpt_backend='orbax'`` is refused. Checkpoints are
    ``torch.save`` files."""

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
    if cfg.ckpt_backend == "orbax":
        raise NotImplementedError(
            "ckpt_backend='orbax' is not ported: orbax and tensorstore are installed on neither "
            "the CPU nor the GPU machine, and the port's checkpoints are torch.save files "
            "(ckpt_backend='msgpack' writes those)")


_FIT_START = {"epoch": 0, "best_val_loss": float("inf"), "epochs_since_best": 0,
              "plateau_since_best": 0, "plateau_best": float("inf")}


def _to_host(obj: Any) -> Any:
    """A copy of a (nested) checkpoint object with every tensor cloned to
    the host, so that later steps do not change what a writer thread
    saves."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _mean_over(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` in place over ``group``: one ``all_reduce`` of
    one flattened buffer a dtype."""
    size = dist.get_world_size(group)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat /= size
        for t, chunk in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(chunk.view_as(t))


class _NoLog:
    """The metric logger of a process other than rank 0: writes nothing."""

    def log(self, step: int, metrics: dict) -> None:
        pass


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
                 model_name: str = "TransMIL", mesh=None) -> None:
        _refuse_unported(config)
        if model_name == "MDMIL":
            raise NotImplementedError(
                "MDMIL does not train: its forward returns (logits, attention) by default, "
                "which JAX's Trainer hands to the loss and fails on (ROADMAP C9)")
        self.model = model
        self.tx = tx
        self.dm = datamodule
        self.n_classes = n_classes
        self.loss_fn = loss_fn
        self.cfg = config
        self.model_name = model_name
        self.is_dtfd = model_name in ("DTFD", "DTFDMIL")
        # coord-aware heads take the tile grid coordinates as a second
        # forward argument
        self.coord_aware = bool(getattr(model, "coord_aware", False))
        self.device = next(model.parameters()).device
        # data parallelism over the mesh's dp dim (one process a card)
        self.mesh = mesh
        self.dp, self.dp_rank = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
        self.dp_group = mesh.get_group("dp") if self.dp > 1 else None
        self.rank = dist.get_rank() if mesh is not None else 0
        self.world = dist.get_world_size() if mesh is not None else 1
        self.is_main = self.rank == 0
        if self.dp > 1:
            if datamodule.batch_size % self.dp:
                raise ValueError(f"batch {datamodule.batch_size} does not split over dp="
                                 f"{self.dp} processes")
            for opt in getattr(tx, "tiers", (tx,)):
                opt.grad_reduce = lambda ts: _mean_over(ts, self.dp_group)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.shuffle_generator = torch.Generator(device=self.device).manual_seed(config.seed + 2)
        # AdaHessian takes the Hessian diagonal, with Rademacher probes (JAX
        # draws them from seed + 7's stream), where JAX's can (ROADMAP C18)
        self.needs_hessian = getattr(tx, "rule", None) == "adahessian"
        if self.needs_hessian:
            refuse_custom_vjp_heads(model)
        self.hessian_generator = torch.Generator(device=self.device).manual_seed(config.seed + 7)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator
            if isinstance(m, PseudoBagShuffle):
                m.generator = self.shuffle_generator

        self.log_dir = Path(config.log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.logger = (MetricLogger(self.log_dir, use_tensorboard=config.use_tensorboard)
                       if self.is_main else _NoLog())
        self.ckpts = CheckpointManager(self.log_dir / "checkpoints")
        self._resume_fit_state: Optional[dict] = None
        self.preempted = False
        self._swa: Optional[list[torch.Tensor]] = None
        self._swa_count = 0
        self._autosave_thread: Optional[threading.Thread] = None
        self._autosave_error: Optional[Exception] = None
        if self.is_main:
            (self.log_dir / "run_meta.json").write_text(json.dumps({
                "model": model_name, "n_classes": n_classes,
                "config": {k: str(v) for k, v in vars(config).items()},
                "torch": torch.__version__, "device": str(self.device),
                "world": self.world, "dp": self.dp,
            }, indent=2))

    # ------------------------------------------------------------ train step
    def _train_mode(self) -> None:
        """Train mode; with ``train_deterministic`` every dropout and DTFD's
        pseudo-bag shuffle stay off."""
        self.model.train()
        if self.cfg.train_deterministic:
            for m in self.model.modules():
                if isinstance(m, (torch.nn.Dropout, PseudoBagShuffle)):
                    m.eval()

    def forward(self, bags: torch.Tensor, coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The head's logits: ``coords`` go to a coord-aware head (None: its
        square-grid fallback, the JAX Trainer's ``grid_coords``), and to no
        other."""
        return head_logits(self.model, *((bags, coords) if self.coord_aware else (bags,)))

    def loss(self, bags: torch.Tensor, labels: torch.Tensor,
             coords: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The train forward: (loss, logits) of one batch, in train mode."""
        self._train_mode()
        one_hot = F.one_hot(labels, self.n_classes).float()
        if not self.is_dtfd:
            logits = self.forward(bags, coords)
            return self.loss_fn(logits, one_hot), logits
        # the two tiers' losses averaged (ref model_interface_dtfd.py:268);
        # the factor sets the data-gradient to weight-decay ratio of the
        # coupled-L2 Adams
        sub, logits = self.model(bags)
        sub_loss = self.loss_fn(sub, one_hot[:1].expand(sub.shape[0], -1))
        return (self.loss_fn(logits, one_hot) + sub_loss) / 2.0, logits

    def train_step(self, bags: torch.Tensor, labels: torch.Tensor,
                   coords: Optional[torch.Tensor] = None) -> tuple[float, np.ndarray]:
        """One micro-step: forward, backward, optimizer. Returns (loss,
        probs). Under AdaHessian the same forward also gives the
        Hutchinson diagonal, which the optimizer's step takes; that forward
        then counts as the ``train.backward`` span's."""
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        with divisor_reduced_over(self.dp_group), batch_stats_reduced_over(self.dp_group):
            if not self.needs_hessian:
                with span("train.forward"):
                    loss, logits = self.loss(bags, labels, coords)
                with span("train.backward"):
                    loss.backward()
                with span("train.update"):
                    self.tx.step()
                with span("train.readback"):
                    return loss.item(), torch.softmax(logits.detach(), dim=-1).cpu().numpy()
            with span("train.backward"):
                (loss, logits), grads, diag = value_grad_and_diag_hessian(
                    lambda: self.loss(bags, labels, coords), params,
                    generator=self.hessian_generator, has_aux=True)
        for p, g in zip(params, grads):
            p.grad = g
        with span("train.update"):
            if self.dp_group is not None:  # the global batch's diagonal
                _mean_over(list(diag), self.dp_group)
            self.tx.step(hessian=diag)
        with span("train.readback"):
            return loss.item(), torch.softmax(logits, dim=-1).cpu().numpy()

    def _batch_arrays(self, batch) -> tuple:
        """(bags, int64 labels, coords) of a batch, numpy: the (B, N, 2)
        padded coords for a coord-aware head, else None (also when the bags
        carry none)."""
        coords = batch.padded_coords if self.coord_aware else None
        return batch.bags, np.asarray(batch.labels, np.int64), coords

    def _batch_tensors(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        return to_device(self._batch_arrays(batch)[:2], self.device)

    def _batch_coords(self, batch) -> Optional[torch.Tensor]:
        return to_device(self._batch_arrays(batch)[2:], self.device)[0]

    def _staged(self, batches):
        """(batch, bags, labels, coords) with the tensors on the device: a
        thread makes the batches and copies them up to ``prefetch_batches``
        (at least 1) ahead of the step (JAX ``_staged_batches``)."""
        return device_prefetch(batches, self.device, self._batch_arrays,
                               max(1, self.cfg.prefetch_batches))

    def set_backbone_variables(self, variables: dict) -> None:
        """Load pretrained weights (flax-layout ``{'params', 'batch_stats'}``,
        e.g. ``utils/torch_weights.load_image_backbone_variables``) into the
        frozen backbone of an ``ImageMILModel`` (JAX ``train/trainer.py:
        270-301``), by ``models/backbones.load_backbone_variables``."""
        if not isinstance(self.model, ImageMILModel):
            raise ValueError("model has no in-graph 'backbone' submodule")
        load_backbone_variables(self.model.backbone, variables)

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
        self._autosave_join()
        if self.is_main:
            self.ckpts.save_last(self._train_state(epoch, fit))
        self.preempted = True
        self.logger.log(epoch, {"event": "preempted", "step": step})
        return {**history, "preempted": True}

    def _fit(self) -> dict[str, float]:
        if not self.tx.params:  # the optimizer binds the weights as they are now
            self.tx.init(self.model)
        fit = {**_FIT_START, **(self._resume_fit_state or {})}
        start_epoch = int(fit.pop("epoch"))
        lr_scale = self.tx.lr_scale  # restored with the optimizer state on resume
        history: dict[str, float] = {}
        n_epochs = 1 if self.cfg.fast_dev_run else self.cfg.epochs
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            # the dropout stream of an epoch depends on the epoch alone, so a
            # resumed run draws what a straight-through run draws
            # (dropout draws per process, ROADMAP C22; the Hessian probes
            # are the same on every process)
            per_rank = [self.rank] if self.world > 1 else []
            for gen, seed in ((self.dropout_generator, [self.cfg.seed + 1, epoch, *per_rank]),
                              (self.shuffle_generator, [self.cfg.seed + 2, epoch]),
                              (self.hessian_generator, [self.cfg.seed + 7, epoch])):
                gen.manual_seed(int(np.random.SeedSequence(seed).generate_state(1)[0]))
            losses, train_probs, train_labels = [], [], []
            for step, (batch, bags, labels, coords) in enumerate(
                    self._staged(self.dm.train_batches(epoch, **self._shard_kw()))):
                loss, probs = self.train_step(bags, labels, coords)
                losses.append(loss)
                train_probs.append(probs)
                train_labels.append(batch.labels)
                if self.cfg.autosave_steps and (step + 1) % self.cfg.autosave_steps == 0:
                    self._autosave(self._train_state(epoch, fit))
                if self._stop_everywhere():
                    return self._preempt_return(history, epoch, fit, step)
                if self.cfg.fast_dev_run:
                    break
            losses, tp, tl = self._gather_train(losses, train_probs, train_labels)
            train_loss = float(np.mean(np.asarray(losses, np.float32)))

            val = self.evaluate("val")
            self._epoch_figures(epoch, val, tp, tl)
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
            if self.cfg.swa and epoch >= int(self.cfg.swa_start_frac * n_epochs):
                self._swa_update()

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

            self._autosave_join()  # no write in flight may race last.ckpt
            if self.is_main:
                self.ckpts.save_epoch(
                    {"model": self.model.state_dict()}, epoch,
                    {k: metrics[k] for k in ("val_loss", "val_auc", "val_accuracy")},
                    last_obj=self._train_state(epoch + 1, fit),
                )
            if self._stop_everywhere():  # the end-of-epoch state is on disk already
                self.preempted = True
                self.logger.log(epoch, {"event": "preempted", "step": -1})
                return {**history, "preempted": True}
            if stop:
                break
        self._autosave_join()
        if self.cfg.swa and self._swa is not None:
            with torch.no_grad():
                for p, a in zip(self.model.parameters(), self._swa):
                    p.copy_(a)
            if self.is_main:
                self.ckpts.save_last({"model": self.model.state_dict()})
        return history

    def _shard_kw(self) -> dict:
        """The data module's ``shard`` argument under data parallelism."""
        return {"shard": (self.dp_rank, self.dp)} if self.dp > 1 else {}

    def _stop_everywhere(self) -> bool:
        """The preemption flag, reduced (MAX) over every process when there
        are several, so that all stop at the same step."""
        if self.world == 1:
            return self._preempted
        flag = torch.tensor([float(self._preempted)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._preempted = bool(flag.item())
        return self._preempted

    def _gather_train(self, losses: list, probs: list, labels: list):
        """The epoch's per-step losses averaged over dp (each process's is
        the mean over its slice, so this is the global batch's), and every
        process's train probabilities and labels."""
        tp, tl = np.concatenate(probs), np.concatenate(labels)
        if self.dp_group is None:
            return losses, tp, tl
        t = torch.tensor(losses, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=self.dp_group)
        parts = [None] * self.dp
        dist.all_gather_object(parts, (tp, tl), group=self.dp_group)
        return ((t / self.dp).tolist(), np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def _swa_update(self) -> None:
        """The running mean of the parameters over the epochs so far
        (JAX: ``(a * c + p) / (c + 1)``; the reference's SWA callback)."""
        params = [p.detach() for p in self.model.parameters()]
        if self._swa is None:
            self._swa, self._swa_count = [p.clone() for p in params], 1
            return
        c = self._swa_count
        self._swa = [(a * c + p) / (c + 1) for a, p in zip(self._swa, params)]
        self._swa_count += 1

    def _autosave(self, state: dict) -> None:
        """``last.ckpt`` <- ``state``: copied to the host here (the
        consistency point), written by a daemon thread with
        ``autosave_async`` (after the previous write, at most one in
        flight), else inline."""
        if not self.is_main:
            return
        if not self.cfg.autosave_async:
            self.ckpts.save_last(state)
            return
        self._autosave_join()
        snapshot = _to_host(state)

        def write() -> None:
            try:
                self.ckpts.save_last(snapshot)
            except Exception as e:  # noqa: BLE001 - raised at the next join
                self._autosave_error = e

        self._autosave_thread = threading.Thread(target=write, name="autosave", daemon=True)
        self._autosave_thread.start()

    def _autosave_join(self) -> None:
        """Wait for the autosave in flight; a failed write raises here
        (training that believes it is preemption-safe while ``last.ckpt``
        goes stale is worse than stopping)."""
        if self._autosave_thread is not None:
            self._autosave_thread.join()
            self._autosave_thread = None
        err, self._autosave_error = self._autosave_error, None
        if err is not None:
            raise RuntimeError(f"background autosave to {self.ckpts.last_path()} failed; "
                               "training is no longer preemption-safe") from err

    # --------------------------------------------------------- checkpoints
    def _jax_state_dict(self, params: Any, stats: Any) -> dict:
        """A JAX Trainer's ``params`` (and BatchNorm ``batch_stats``) -> the
        model's state dict: a classic tile classifier by the flax tree's
        walk, a head by its carry-over table."""
        if isinstance(self.model, ClassicTileClassifier):
            return classic_state_dict_from_jax({"params": params, "batch_stats": stats or {}},
                                               self.model)
        return head_state_dict_from_jax(self.model_name, params, self._in_features(), stats)

    def _in_features(self) -> int:
        """The head's input width: the in_features of its first Linear or
        Conv1d (the fc1 MLP, Chowder's scorer, MONAI's ``myfc``)."""
        head = self.model.head if isinstance(self.model, ImageMILModel) else self.model
        for m in head.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d)):
                return m.in_features if isinstance(m, torch.nn.Linear) else m.in_channels
        raise ValueError("the model has no Linear layer")

    def load_checkpoint(self, path: str | Path) -> None:
        """Weights only, from any checkpoint of the port (``{"model": ...}``)
        or of the JAX Trainer (flax msgpack ``{"params": ...}``, metric
        checkpoints and ``last.ckpt`` alike)."""
        obj = read_checkpoint(path)
        if "model" in obj:
            self.model.load_state_dict(obj["model"])
        elif "params" in obj:
            stats = (obj.get("model_state") or {}).get("batch_stats") or None
            self.model.load_state_dict(self._jax_state_dict(obj["params"], stats))
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
        self.tx.init(self.model)
        if "optimizer" in obj:
            state = obj["optimizer"]
        else:
            names = [n for n, _ in self.model.named_parameters()]
            state = optimizer_state_from_jax(obj["opt_state"], self._in_features(), names,
                                             self.model_name,
                                             lambda tree: self._jax_state_dict(tree, None),
                                             rule=getattr(self.tx, "rule", "adam"),
                                             params=obj["params"])
        self.tx.load_state_dict(state)
        fit = obj["fit"]
        self._resume_fit_state = {k: type(v)(np.asarray(fit[k])) for k, v in _FIT_START.items()
                                  if k in fit}
        return True

    # ------------------------------------------------------------------ eval
    def evaluate(self, mode: str, save_results: bool = False,
                 stage_name: Optional[str] = None) -> dict:
        # the test-stage top-k attention tile export (ref custom_test_module,
        # test_visualize.py:38-120) of the heads with an attention query
        with_attn = (save_results and self.cfg.export_topk_tiles
                     and hasattr(self.model, "attn_query"))
        all_probs, all_logits, all_labels, names, patients, topk = [], [], [], [], [], []
        self.model.eval()
        with torch.inference_mode():
            for batch, bags, _, coords in self._staged(
                    self.dm.eval_batches(mode, batch_size=self.cfg.eval_batch_size,
                                         **self._shard_kw())):
                if with_attn:
                    logits, attn = self.model(*((bags, coords) if self.coord_aware else (bags,)),
                                              return_attn=True)
                    # what the export reads (not the bags, which a gather would copy)
                    topk.append((SimpleNamespace(names=batch.names, lengths=batch.lengths,
                                                 coords=batch.coords),
                                 attn.tile_scores().mean(dim=1).float().cpu()))
                else:
                    logits = self.forward(bags, coords)
                all_probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
                all_logits.append(logits.cpu().numpy())
                all_labels.append(batch.labels)
                names += batch.names
                patients += batch.patients
                if self.cfg.fast_dev_run and len(names) >= 2:
                    break
        if self.dp_group is not None:  # every process's bags, in bag order
            parts = [None] * self.dp
            dist.all_gather_object(parts, (all_probs, all_logits, all_labels, names, patients,
                                           topk), group=self.dp_group)
            all_probs, all_logits, all_labels, names, patients, topk = (
                [x for part in parts for x in part[i]] for i in range(6))
        if self.is_main:
            for batch, rows in topk:
                self._export_topk_tiles(batch, rows)
        probs = np.concatenate(all_probs)
        logits = np.concatenate(all_logits)
        labels = np.concatenate(all_labels)

        # slide-level CE loss (ref validation_step's cross_entropy_torch)
        mx = logits.max(-1, keepdims=True)
        logp = logits - np.log(np.exp(logits - mx).sum(-1, keepdims=True)) - mx
        loss = float(-np.mean(logp[np.arange(len(labels)), labels]))

        aggregate = aggregate_tiles_to_patients if self.cfg.tile_level else aggregate_patients
        agg = aggregate(probs, labels, names, patients, self.n_classes)
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
        if save_results and self.is_main:
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
            if self.is_main:
                _write_csv(path, {f"class_{c}": [thresholds[c]] for c in range(self.n_classes)},
                           index=False)
        elif mode == "test" and path.exists():
            with open(path, newline="") as f:
                row = next(csv.DictReader(f), {})
            loaded = [float(row[f"class_{c}"]) for c in range(self.n_classes) if f"class_{c}" in row]
            if len(loaded) == self.n_classes:
                thresholds = loaded
        return thresholds

    def _export_topk_tiles(self, batch, rows: torch.Tensor,
                           out_dir: Optional[Path] = None) -> None:
        """Each slide's top-k tiles by its (n_tokens,) attention row (mean
        over heads), to ``<out_dir>/<slide>_topk_tiles.csv``."""
        from transmil_deepgraft_tpu_torch.visualize.heatmap import export_topk_tiles

        out_dir = out_dir or self.log_dir / "topk_tiles"
        rows = rows.float().cpu().numpy()
        for j, slide_name in enumerate(batch.names):
            export_topk_tiles(rows[j][:int(batch.lengths[j])], batch.coords[j], slide_name,
                              out_dir / f"{slide_name}_topk_tiles.csv")

    def _epoch_figures(self, epoch: int, val: dict, train_probs, train_labels) -> None:
        """Train-stage dashboard figures (ref ``model_interface.py:385-430``):
        the val patient ROC/PR every epoch, the train confusion every 10th."""
        if not self.cfg.epoch_figures or not self.is_main:
            return
        try:
            from transmil_deepgraft_tpu_torch.utils.plots import (
                plot_confusion_matrix, plot_pr_curves, plot_roc_curves)

            figs = self.log_dir / "figures"
            figs.mkdir(parents=True, exist_ok=True)
            agg = val["aggregate"]
            plot_roc_curves(agg.scores, agg.targets, self.n_classes,
                            figs / f"val_patient_roc_epoch{epoch:03d}", self.cfg.task)
            plot_pr_curves(agg.scores, agg.targets, self.n_classes,
                           figs / f"val_patient_pr_epoch{epoch:03d}", self.cfg.task)
            if (epoch + 1) % 10 == 0:  # ref: confusion every 10 train epochs
                plot_confusion_matrix(train_probs, train_labels, self.n_classes,
                                      figs / f"train_confusion_epoch{epoch:03d}", self.cfg.task)
        except Exception as e:  # figures must never fail training
            print(f"[trainer] epoch figure export skipped: {e}")

    def test(self) -> dict:
        result = self.evaluate("test", save_results=True, stage_name="test")
        summary = {
            "test_loss": result["loss"],
            "test_auc": result["auroc"],
            "test_patient_auc": result["patient_auroc"],
            **result["patient_report"].as_dict("test_patient_"),
            **result["slide_report"].as_dict("test_slide_"),
        }
        if not self.is_main:
            return summary
        # figure artifacts (ref model_interface.py:814-821)
        try:
            from transmil_deepgraft_tpu_torch.utils.plots import (
                plot_confusion_matrix, plot_pr_curves, plot_roc_curves)

            agg = result["aggregate"]
            for fn, stem in ((plot_roc_curves, "test_patient_roc"),
                             (plot_pr_curves, "test_patient_pr")):
                fn(agg.scores, agg.targets, self.n_classes, self.log_dir / stem, self.cfg.task)
            plot_confusion_matrix(
                agg.scores, agg.targets, self.n_classes, self.log_dir / "test_patient_confusion",
                self.cfg.task, threshold=result["thresholds"][1] if self.n_classes <= 2 else 0.5)
        except Exception as e:  # figures must never fail a test run
            print(f"[trainer] figure export skipped: {e}")
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
