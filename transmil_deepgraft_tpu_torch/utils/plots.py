"""Figure artifacts: ROC / PR curves and confusion matrices (port of
``utils/plots.py``; ref seaborn renderers, ``code/utils/utils.py:242-720``).

Per-class ROC/PR curves in ``COLOR_MAP``'s colours, a confusion matrix at an
operating threshold; each written as PNG + SVG. matplotlib is imported when
a figure is drawn; without it a figure raises an ``ImportError`` that names
it (the Trainer then skips its figures with a printed line, as JAX's does).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from transmil_deepgraft_tpu_torch.train.metrics import _roc_points, _trapezoid, confusion_matrix
from transmil_deepgraft_tpu_torch.utils.config import COLOR_MAP, LABEL_MAP


def pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError names matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("figures need matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _class_names(task: str, n_classes: int) -> list[str]:
    lm = LABEL_MAP.get(task, {})
    return [lm.get(str(i), f"class_{i}") for i in range(n_classes)]


def _save(fig, path: Path) -> list[Path]:
    path.parent.mkdir(parents=True, exist_ok=True)
    out = []
    for suffix in (".png", ".svg"):
        p = path.with_suffix(suffix)
        fig.savefig(p, bbox_inches="tight", dpi=150)
        out.append(p)
    pyplot().close(fig)
    return out


def plot_roc_curves(probs: np.ndarray, labels: np.ndarray, n_classes: int, path: str | Path,
                    task: str = "") -> list[Path]:
    plt = pyplot()
    probs = np.asarray(probs)
    labels = np.asarray(labels).ravel()
    names = _class_names(task, n_classes)
    fig, ax = plt.subplots(figsize=(5, 5))
    classes = [1] if n_classes <= 2 else range(n_classes)
    for ci, c in enumerate(classes):
        y = (labels == c).astype(int)
        if y.min() == y.max():
            continue
        fpr, tpr, _ = _roc_points(probs[:, c].astype(np.float64), y)
        auc = float(_trapezoid(tpr, fpr))
        ax.plot(fpr, tpr, color=COLOR_MAP[ci % len(COLOR_MAP)],
                label=f"{names[c]} (AUC={auc:.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("1 - Specificity")
    ax.set_ylabel("Sensitivity")
    if ax.get_legend_handles_labels()[1]:  # all-one-class epochs draw no curves
        ax.legend(loc="lower right")
    return _save(fig, Path(path))


def plot_pr_curves(probs: np.ndarray, labels: np.ndarray, n_classes: int, path: str | Path,
                   task: str = "") -> list[Path]:
    plt = pyplot()
    probs = np.asarray(probs)
    labels = np.asarray(labels).ravel()
    names = _class_names(task, n_classes)
    fig, ax = plt.subplots(figsize=(5, 5))
    classes = [1] if n_classes <= 2 else range(n_classes)
    for ci, c in enumerate(classes):
        y = (labels == c).astype(int)
        if y.sum() == 0:
            continue
        order = np.argsort(-probs[:, c])
        tp = np.cumsum(y[order])
        precision = tp / np.arange(1, len(y) + 1)
        recall = tp / max(y.sum(), 1)
        ap = float(np.sum(np.diff(np.r_[0.0, recall]) * precision))
        ax.plot(recall, precision, color=COLOR_MAP[ci % len(COLOR_MAP)],
                label=f"{names[c]} (AP={ap:.3f})")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    if ax.get_legend_handles_labels()[1]:
        ax.legend(loc="lower left")
    return _save(fig, Path(path))


def plot_confusion_matrix(probs: np.ndarray, labels: np.ndarray, n_classes: int,
                          path: str | Path, task: str = "", threshold: float = 0.5) -> list[Path]:
    plt = pyplot()
    probs = np.asarray(probs)
    labels = np.asarray(labels).ravel()
    if probs.ndim == 2 and n_classes <= 2:
        preds = (probs[:, 1] >= threshold).astype(int)
    elif probs.ndim == 2:
        preds = probs.argmax(-1)
    else:
        preds = (probs >= threshold).astype(int)
    cm = confusion_matrix(preds, labels, n_classes)
    names = _class_names(task, n_classes)
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(cm, cmap="Blues")
    for i in range(n_classes):
        for j in range(n_classes):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > cm.max() / 2 else "black")
    ax.set_xticks(range(n_classes), names, rotation=30)
    ax.set_yticks(range(n_classes), names)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    fig.colorbar(im, shrink=0.8)
    return _save(fig, Path(path))
