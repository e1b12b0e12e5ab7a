"""SimCLR pretraining loop (port of ``train/simclr.py``; the reference's
trainable LightningModule, ``code/models/SimCLR.py:1-61``).

As the JAX loop:

* model: a feature backbone + the projection MLP ``Linear(feat, 4*hidden)
  -> ReLU -> Linear(4*hidden, hidden)`` (``models/simclr.SimCLRModel``);
* loss: NT-Xent over the two-view batch, positives ``B`` apart;
* optimizer: AdamW (decoupled weight decay on every parameter) with optax's
  cosine decay to ``lr/50`` over ``epochs * steps_per_epoch`` updates,
  evaluated at optax's count, so the first update takes the full ``lr``;
* BatchNorm: view 1's forward moves the running statistics, and view 2's
  forward starts from them, inside one step (JAX threads them so);
* ranking metrics ``acc_top1`` / ``acc_top5`` / ``acc_mean_pos`` of every
  step, averaged over the epoch;
* two stain-augmented views a tile on the host (``data/transforms``), the
  next batch's while the device runs the step (nothing waits on the device
  until the epoch's end);
* ``simclr_last.ckpt`` (``{"model": state_dict}``, the port's format) every
  epoch; :func:`load_simclr_checkpoint` also reads the JAX loop's msgpack
  file.

The initial weights are torch's, drawn under ``torch.manual_seed(seed)``;
``init_variables`` (flax-layout ``{'params', 'batch_stats'}``, e.g. a JAX
run's) replaces them. The model takes the backbone's device and dtype.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.data.transforms import imagenet_normalize, train_augment
from transmil_deepgraft_tpu_torch.models.simclr import SimCLRModel, nt_xent
from transmil_deepgraft_tpu_torch.train.optimizers import (
    Optimizer, cosine_decay_schedule, create_scheduled_adamw)


def _ranking_metrics(z1: torch.Tensor, z2: torch.Tensor, temperature: float) -> dict:
    """The rank of each positive among all 2B-1 candidates (``SimCLR.py:
    47-55``): top-1, top-5 and 1 + the mean rank."""
    b = z1.shape[0]
    z = torch.cat([z1, z2], dim=0)
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
    sim = (z @ z.T) / temperature
    rows = torch.arange(2 * b, device=z.device)
    pos_idx = torch.cat([rows[b:], rows[:b]])
    self_mask = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(self_mask, -9e15)
    pos_sim = sim[rows, pos_idx]
    # rank of the positive = the number of OTHER candidates strictly above it
    others = sim.clone()
    others[rows, pos_idx] = -9e15
    rank = (others > pos_sim[:, None]).sum(dim=-1)
    return {  # float32 means, as JAX's whatever the projections' dtype
        "acc_top1": (rank == 0).float().mean(),
        "acc_top5": (rank < 5).float().mean(),
        "acc_mean_pos": 1.0 + rank.float().mean(),
    }


def two_view_batch(images: np.ndarray, idx: np.ndarray,
                   rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """uint8 images (N, H, W, 3) + batch indices -> two augmented normalized
    float32 views (B, H, W, 3) each."""
    views = []
    for _ in range(2):
        views.append(np.stack([imagenet_normalize(train_augment(images[i], rng)) for i in idx]))
    return views[0], views[1]


def simclr_step(model: SimCLRModel, tx: Optimizer, view1: torch.Tensor, view2: torch.Tensor,
                temperature: float) -> tuple[torch.Tensor, dict]:
    """One update on a two-view batch: (loss, ranking metrics), device
    tensors (nothing here waits on the device)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    z1 = model(view1)  # moves the BatchNorm statistics ...
    z2 = model(view2)  # ... which view 2 starts from
    loss = nt_xent(z1, z2, temperature)
    loss.backward()
    tx.step()
    with torch.no_grad():
        metrics = _ranking_metrics(z1.detach(), z2.detach(), temperature)
    return loss.detach(), metrics


def _feature_dim(backbone: torch.nn.Module, view: np.ndarray) -> int:
    dim = getattr(backbone, "feature_dim", None)
    if dim is not None:
        return int(dim)
    p = next(backbone.parameters())
    was = backbone.training
    with torch.no_grad():
        out = backbone.eval()(torch.from_numpy(view[:1]).to(p.device, p.dtype))
    backbone.train(was)
    return int(out.shape[-1])


def load_simclr_checkpoint(model: SimCLRModel, path: str | Path) -> None:
    """``simclr_last.ckpt`` of the port (``{"model": state_dict}``) or of the
    JAX loop (flax msgpack ``{'params', 'batch_stats'}``) into ``model``."""
    from transmil_deepgraft_tpu_torch.utils.checkpoints import read_checkpoint
    from transmil_deepgraft_tpu_torch.utils.jax_params import backbone_state_dict_from_jax

    obj = read_checkpoint(path)
    sd = obj["model"] if "model" in obj else backbone_state_dict_from_jax(obj)
    model.load_state_dict(sd)


def fit_simclr(
    images: np.ndarray,
    *,
    backbone: Optional[torch.nn.Module] = None,
    hidden_dim: int = 128,
    epochs: int = 10,
    batch_size: int = 32,
    lr: float = 5e-4,
    weight_decay: float = 1e-4,
    temperature: float = 0.07,
    seed: int = 0,
    log_dir: Optional[str | Path] = None,
    device: Optional[str | torch.device] = None,
    init_variables: Optional[dict] = None,
) -> tuple[SimCLRModel, list[dict]]:
    """Pretrain on uint8 images (N, H, W, 3); returns (model, per-epoch
    history). ``backbone`` defaults to ResNet18 in feature mode (512-d, as
    the reference) on ``device`` (default: CUDA); a given backbone keeps its
    own device. The backbone's part of the model feeds the feature
    extractor afterwards (:func:`backbone_features`)."""
    from transmil_deepgraft_tpu_torch.device import resolve_device
    from transmil_deepgraft_tpu_torch.models.resnet import resnet18

    rng = np.random.default_rng(seed)
    n = images.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    # the first two-view draw (JAX initializes on it) keeps the augmentation
    # stream in step with the JAX loop's
    v1, _ = two_view_batch(images, np.arange(min(batch_size, n)), rng)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if backbone is None:
            backbone = resnet18(num_classes=0).to(resolve_device(device))
        p = next(backbone.parameters())
        model = SimCLRModel(backbone, _feature_dim(backbone, v1), proj_dim=hidden_dim,
                            hidden_dim=4 * hidden_dim).to(p.device, p.dtype)
    if init_variables is not None:
        from transmil_deepgraft_tpu_torch.utils.jax_params import backbone_state_dict_from_jax

        model.load_state_dict(backbone_state_dict_from_jax(init_variables))
    dev, dtype = p.device, p.dtype

    # AdamW + cosine annealing to lr/50 over the whole run (ref SimCLR.py:17-23)
    tx = create_scheduled_adamw(model, cosine_decay_schedule(lr, epochs * steps_per_epoch,
                                                             alpha=1.0 / 50), weight_decay)

    def to_dev(view: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(view)
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, dtype, non_blocking=True)

    history: list[dict] = []
    logger = None
    if log_dir is not None:
        from transmil_deepgraft_tpu_torch.utils.logging import MetricLogger

        logger = MetricLogger(log_dir)
    for epoch in range(epochs):
        order = rng.permutation(n)
        losses, accs = [], []
        pending = two_view_batch(images, order[:batch_size], rng)
        for s in range(steps_per_epoch):
            view1, view2 = pending
            loss, metrics = simclr_step(model, tx, to_dev(view1), to_dev(view2), temperature)
            if s + 1 < steps_per_epoch:  # augment the next batch while the device runs
                idx = order[(s + 1) * batch_size:(s + 2) * batch_size]
                pending = two_view_batch(images, idx, rng)
            losses.append(loss)
            accs.append(metrics)
        row = {
            "train_loss": float(np.mean(torch.stack(losses).cpu().numpy())),
            **{k: float(np.mean(torch.stack([m[k] for m in accs]).cpu().numpy()))
               for k in accs[0]},
        }
        history.append(row)
        if logger is not None:
            logger.log(epoch, row)
        if log_dir is not None:
            from transmil_deepgraft_tpu_torch.utils.checkpoints import save_checkpoint

            save_checkpoint(Path(log_dir) / "simclr_last.ckpt", {"model": model.state_dict()})
    return model, history


def backbone_features(model: SimCLRModel, images: np.ndarray,
                      batch_size: int = 64) -> np.ndarray:
    """The pretrained BACKBONE's features (projection head dropped) of uint8
    images, for linear probing / downstream extraction."""
    backbone = model.backbone.eval()
    p = next(backbone.parameters())
    outs = []
    with torch.inference_mode():
        for s in range(0, images.shape[0], batch_size):
            batch = np.stack([imagenet_normalize(img) for img in images[s:s + batch_size]])
            outs.append(backbone(torch.from_numpy(batch).to(p.device, p.dtype)).cpu().numpy())
    return np.concatenate(outs)
