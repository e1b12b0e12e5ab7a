"""Loss factory over logits (port of ``train/losses.py``).

Name-keyed losses mirroring the reference surface (``MyLoss/loss_factory.py``):
torch.nn names (default ``CrossEntropyLoss``), focal / poly / dice / jaccard /
lovasz variants and the ``bce+<x>`` joint losses. The reference trains with
*soft* targets, ``loss(logits, one_hot(label).float())``, so
:func:`cross_entropy` is ``-sum(target * log_softmax(logits))`` averaged over
the batch. Every loss is a pure function ``(logits, targets_onehot) -> scalar``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Soft-target CE: mean over batch of -sum(p * log_softmax(logits))."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def label_smoothing_cross_entropy(smoothing: float = 0.2) -> LossFn:
    """Uniform label smoothing CE (ref LabelSmoothingCrossEntropy(0.2))."""

    def loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        n = logits.shape[-1]
        return cross_entropy(logits, targets * (1.0 - smoothing) + smoothing / n)

    return loss


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))).mean()


def focal_loss(gamma: float = 2.0, alpha: float = 0.25) -> LossFn:
    """Multiclass focal loss over softmax probabilities."""

    def loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        per_class = -targets * (1.0 - logp.exp()) ** gamma * logp
        return (alpha * per_class.sum(dim=-1)).mean()

    return loss


def poly_loss(epsilon: float = 1.0) -> LossFn:
    """PolyLoss (Leng 2022): CE + eps * (1 - p_t)."""

    def loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        ce = -(targets * logp).sum(dim=-1)
        pt = (targets * logp.exp()).sum(dim=-1)
        return (ce + epsilon * (1.0 - pt)).mean()

    return loss


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = torch.softmax(logits, dim=-1)
    return 1.0 - (2.0 * (p * targets).sum() + eps) / (p.sum() + targets.sum() + eps)


def jaccard_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = torch.softmax(logits, dim=-1)
    inter = (p * targets).sum()
    union = p.sum() + targets.sum() - inter
    return 1.0 - (inter + eps) / (union + eps)


def lovasz_softmax(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Lovasz-softmax (Berman 2018), flat multi-class: per class, errors
    ``|1{y=c} - p_c|`` sorted descending, weighted by the gradient of the
    Lovasz extension of the IoU, averaged over the classes present."""
    c = logits.shape[-1]
    p = torch.softmax(logits, dim=-1).reshape(-1, c)
    fg = targets.reshape(-1, c).float()
    losses = []
    for k in range(c):
        errors = (fg[:, k] - p[:, k]).abs()
        order = torch.argsort(-errors, stable=True)
        err_sorted, fg_sorted = errors[order], fg[order, k]
        gts = fg[:, k].sum()
        inter = gts - fg_sorted.cumsum(0)
        union = gts + (1.0 - fg_sorted).cumsum(0)
        jaccard = 1.0 - inter / union.clamp(min=1e-12)
        grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
        losses.append(err_sorted @ grad)
    present = (fg.sum(dim=0) > 0).float()
    return (torch.stack(losses) * present).sum() / present.sum().clamp(min=1.0)


def dice_log_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """-log(dice score) (ref 'dice_log')."""
    return -torch.log((1.0 - dice_loss(logits, targets, eps)).clamp(min=eps))


def jaccard_log_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """-log(jaccard score) (the 'log_jaccard' half of 'bce+log_jaccard')."""
    return -torch.log((1.0 - jaccard_loss(logits, targets, eps)).clamp(min=eps))


def reduced_focal_loss(gamma: float = 2.0, threshold: float = 0.5) -> LossFn:
    """Reduced focal loss (Sergievskiy 2019): no down-weighting while
    p_t < threshold, then the focal factor normalised to 1 at the threshold."""

    def loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        pt = (targets * logp.exp()).sum(dim=-1)
        ce = -(targets * logp).sum(dim=-1)
        factor = torch.where(pt < threshold, torch.ones_like(pt),
                             ((1.0 - pt) / (1.0 - threshold)) ** gamma)
        return (factor * ce).mean()

    return loss


def joint_loss(first: LossFn, second: LossFn, w1: float = 1.0, w2: float = 0.5) -> LossFn:
    """Weighted sum (ref JointLoss with the factory's w1=1.0, w2=0.5)."""

    def loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return w1 * first(logits, targets) + w2 * second(logits, targets)

    return loss


def mse_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return ((logits - targets) ** 2).mean()


def l1_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (logits - targets).abs().mean()


def smooth_l1_loss(logits: torch.Tensor, targets: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = (logits - targets).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


# Segmentation-era losses the reference's factory never registers: a config
# naming one fails in both frameworks.
_UNSUPPORTED: dict[str, str] = {
    name: (
        f"'{name}' is a segmentation-era loss module the reference factory "
        "never registers (MyLoss/loss_factory.py:21-62 raises on it too); "
        "use 'dice'/'jaccard'/'lovasz' or a CE variant for MIL heads"
    )
    for name in ("boundary", "hausdorff", "hd", "nd_topk", "ndtopk", "topk")
}

_LOSSES: dict[str, Callable[..., LossFn] | LossFn] = {
    "CrossEntropyLoss": cross_entropy,
    "BCEWithLogitsLoss": bce_with_logits,
    "LabelSmoothingCrossEntropy": label_smoothing_cross_entropy,
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "focal": focal_loss,
    "reduced_focal": reduced_focal_loss,
    "polyloss": poly_loss,
    "dice": dice_loss,
    "dice_log": dice_log_loss,
    "jaccard": jaccard_loss,
    # ref quirk: 'jaccard_log' maps to the PLAIN jaccard loss
    "jaccard_log": jaccard_loss,
    "lovasz": lovasz_softmax,
}

_FACTORY_STYLE = ("LabelSmoothingCrossEntropy", "focal", "reduced_focal", "polyloss")

_JOINT = {"bce+lovasz": lovasz_softmax, "bce+jaccard": jaccard_loss,
          "bce+log_jaccard": jaccard_log_loss, "bce+log_dice": dice_log_loss}


def create_loss(base_loss: str = "CrossEntropyLoss", w1: float = 1.0, w2: float = 0.5,
                **kwargs) -> LossFn:
    """Resolve a loss by config name (``cfg.Loss.base_loss``), with the JAX
    package's name table; names the reference factory rejects raise."""
    if base_loss in _UNSUPPORTED:
        raise NotImplementedError(_UNSUPPORTED[base_loss])
    if base_loss.startswith("bce+"):
        if base_loss not in _JOINT:
            raise KeyError(f"unknown joint loss '{base_loss}'; supported: {', '.join(_JOINT)}")
        return joint_loss(bce_with_logits, _JOINT[base_loss], w1=w1, w2=w2)
    if base_loss not in _LOSSES:
        raise KeyError(f"unknown loss '{base_loss}'; available: {sorted(_LOSSES)}")
    fn = _LOSSES[base_loss]
    return fn(**kwargs) if base_loss in _FACTORY_STYLE else fn
