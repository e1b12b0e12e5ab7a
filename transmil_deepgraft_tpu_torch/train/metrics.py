"""Evaluation metrics matching the reference's torchmetrics semantics (a copy of
the JAX package's ``train/metrics.py``; numpy only).

Ref ``code/models/model_interface.py:180-215``: binary tasks use binary
AUROC/Accuracy/CohenKappa/F1/Recall/Precision; multiclass (>2) uses
``AUROC(average=None).mean()``, weighted Accuracy, macro F1/Recall/Precision/
Specificity. Metrics run host-side (numpy) on gathered outputs - the TPU answer
to the reference's ``sync_dist=True`` reductions is an eval-output all_gather,
after which these are cheap.

All curve logic (ROC / PR / Youden-J operating point, ref
``utils/utils.py:257-276``) is implemented directly so numerics are
backend-independent and deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


def _roc_points(scores: np.ndarray, labels: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC curve (fpr, tpr, thresholds), thresholds descending; torchmetrics-style
    with a leading (0,0) point at threshold +inf."""
    order = np.argsort(-scores, kind="stable")
    scores_s = scores[order]
    labels_s = labels[order].astype(np.float64)
    distinct = np.where(np.diff(scores_s))[0]
    idx = np.r_[distinct, labels_s.size - 1]
    tps = np.cumsum(labels_s)[idx]
    fps = 1 + idx - tps
    p = labels_s.sum()
    n = labels_s.size - p
    tpr = np.r_[0.0, tps / max(p, 1e-12)]
    fpr = np.r_[0.0, fps / max(n, 1e-12)]
    thresholds = np.r_[np.inf, scores_s[idx]]
    return fpr, tpr, thresholds


def binary_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    fpr, tpr, _ = _roc_points(np.asarray(scores, np.float64), np.asarray(labels))
    return float(_trapezoid(tpr, fpr))


def multiclass_auroc_mean(probs: np.ndarray, labels: np.ndarray) -> float:
    """torchmetrics ``AUROC(task='multiclass', average=None)(...).mean()``: one-vs-rest
    per-class AUC, classes absent from labels contribute 0 (degenerate guard at
    ref ``model_interface.py:500-503`` handled by the caller)."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    n_classes = probs.shape[-1]
    aucs = []
    for c in range(n_classes):
        y = (labels == c).astype(np.int64)
        if y.min() == y.max():
            aucs.append(0.0)
        else:
            aucs.append(binary_auroc(probs[:, c], y))
    return float(np.mean(aucs))


def auroc(probs: np.ndarray, labels: np.ndarray, n_classes: int) -> float:
    """Dispatch like the reference: binary uses probs[:, 1]; multiclass ovr-mean."""
    probs = np.asarray(probs)
    if n_classes <= 2:
        scores = probs[:, 1] if probs.ndim == 2 else probs
        labels = np.asarray(labels)
        if labels.min() == labels.max():
            return 0.0
        return binary_auroc(scores, labels)
    return multiclass_auroc_mean(probs, labels)


def youden_j_threshold(scores: np.ndarray, labels: np.ndarray) -> tuple[float, float, float]:
    """Optimal operating point (fpr, tpr, threshold) maximizing tpr - fpr
    (ref ``utils/utils.py:257-276``)."""
    fpr, tpr, thr = _roc_points(np.asarray(scores, np.float64), np.asarray(labels))
    i = int(np.argmax(tpr - fpr))
    return float(fpr[i]), float(tpr[i]), float(thr[i])


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(np.asarray(labels).ravel(), np.asarray(preds).ravel()):
        cm[int(t), int(p)] += 1
    return cm


def _preds_from_probs(probs: np.ndarray, n_classes: int, threshold: float = 0.5) -> np.ndarray:
    probs = np.asarray(probs)
    if probs.ndim == 2 and probs.shape[-1] == n_classes:
        return probs.argmax(-1)
    return (probs >= threshold).astype(np.int64)


@dataclass
class ClassificationReport:
    accuracy: float
    auroc: float
    cohen_kappa: float
    f1: float
    recall: float
    precision: float
    specificity: float

    def as_dict(self, prefix: str = "") -> dict[str, float]:
        return {f"{prefix}{k}": v for k, v in vars(self).items()}


def classification_report(
    probs: np.ndarray, labels: np.ndarray, n_classes: int, threshold: float = 0.5
) -> ClassificationReport:
    """The reference's MetricCollection (ref ``model_interface.py:186-214``):
    binary -> binary metrics; multiclass -> weighted accuracy + macro F1/recall/
    precision/specificity + Cohen's kappa."""
    labels = np.asarray(labels).ravel()
    preds = _preds_from_probs(probs, n_classes, threshold)
    cm = confusion_matrix(preds, labels, n_classes)
    support = cm.sum(1)
    total = cm.sum()
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    tn = total - tp - fp - fn

    with np.errstate(divide="ignore", invalid="ignore"):
        prec_c = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        rec_c = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        spec_c = np.where(tn + fp > 0, tn / (tn + fp), 0.0)
        f1_c = np.where(prec_c + rec_c > 0, 2 * prec_c * rec_c / (prec_c + rec_c), 0.0)

    po = tp.sum() / max(total, 1)
    pe = float((cm.sum(1) * cm.sum(0)).sum()) / max(total * total, 1)
    kappa = (po - pe) / (1 - pe) if pe < 1 else 0.0

    if n_classes <= 2:
        acc = po
        f1 = float(f1_c[1])
        rec = float(rec_c[1])
        prec = float(prec_c[1])
        spec = float(spec_c[1])
    else:
        # weighted accuracy == weighted recall in torchmetrics
        acc = float(np.sum(rec_c * support) / max(support.sum(), 1))
        f1 = float(f1_c.mean())
        rec = float(rec_c.mean())
        prec = float(prec_c.mean())
        spec = float(spec_c.mean())

    return ClassificationReport(
        accuracy=float(acc),
        auroc=auroc(probs, labels, n_classes),
        cohen_kappa=float(kappa),
        f1=f1,
        recall=rec,
        precision=prec,
        specificity=spec,
    )
