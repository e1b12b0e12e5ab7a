"""Offline metric export with bootstrapped confidence intervals (port of
``utils/export_metrics.py``; ref ``code/utils/export_metrics.py:34-786``): read
``TEST_RESULT_PATIENT.csv`` result tables from run log dirs, bootstrap-resample
patient scores for AUROC confidence intervals, and render combined/per-run
ROC/PR figures + a summary CSV.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from transmil_deepgraft_tpu_torch.train.metrics import auroc
from transmil_deepgraft_tpu_torch.utils.config import LABEL_MAP


def bootstrap_auroc(
    probs: np.ndarray,
    targets: np.ndarray,
    n_classes: int,
    n_boot: int = 1000,
    seed: int = 0,
    ci: float = 0.95,
) -> dict:
    """Percentile bootstrap CI over patients (ref ``export_metrics.py`` bootstrap)."""
    rng = np.random.default_rng(seed)
    probs = np.asarray(probs)
    targets = np.asarray(targets)
    n = len(targets)
    point = auroc(probs, targets, n_classes)
    samples = []
    for _ in range(n_boot):
        idx = rng.integers(0, n, n)
        t = targets[idx]
        if len(np.unique(t)) < 2:
            continue
        samples.append(auroc(probs[idx], t, n_classes))
    lo, hi = (1 - ci) / 2, 1 - (1 - ci) / 2
    arr = np.asarray(samples) if samples else np.array([point])
    return {
        "auroc": point,
        "ci_low": float(np.quantile(arr, lo)),
        "ci_high": float(np.quantile(arr, hi)),
        "n_boot": len(arr),
    }


def read_patient_results(csv_path: str | Path, task: str, n_classes: int) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Parse a TEST_RESULT_PATIENT.csv back into (probs, targets, patients)."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    lm = LABEL_MAP.get(task, {str(i): f"class_{i}" for i in range(n_classes)})
    cols = [lm[str(i)] for i in range(n_classes)]
    return df[cols].to_numpy(), df["yTrue"].to_numpy(), df["PATIENT"].tolist()


def export_run(
    log_dir: str | Path,
    task: str,
    n_classes: int,
    mode: str = "test",
    n_boot: int = 1000,
) -> dict:
    """Summarize one run dir: bootstrap CI + ROC/PR/confusion figures."""
    from transmil_deepgraft_tpu_torch.utils.plots import (
        plot_confusion_matrix,
        plot_pr_curves,
        plot_roc_curves,
    )

    log_dir = Path(log_dir)
    csv_path = log_dir / f"{mode.upper()}_RESULT_PATIENT.csv"
    probs, targets, _ = read_patient_results(csv_path, task, n_classes)
    summary = bootstrap_auroc(probs, targets, n_classes, n_boot=n_boot)
    plot_roc_curves(probs, targets, n_classes, log_dir / f"{mode}_patient_roc", task)
    plot_pr_curves(probs, targets, n_classes, log_dir / f"{mode}_patient_pr", task)
    plot_confusion_matrix(probs, targets, n_classes, log_dir / f"{mode}_patient_confusion", task)
    (log_dir / f"{mode}_bootstrap.json").write_text(json.dumps(summary, indent=2))
    return summary


def bootstrap_auroc_per_class(
    probs: np.ndarray,
    targets: np.ndarray,
    n_classes: int,
    n_boot: int = 1000,
    seed: int = 0,
    ci: float = 0.95,
) -> list[dict]:
    """Per-class one-vs-rest bootstrap CIs (ref export_metrics per-class rows)."""
    from transmil_deepgraft_tpu_torch.train.metrics import binary_auroc

    rng = np.random.default_rng(seed)
    probs = np.asarray(probs)
    targets = np.asarray(targets)
    n = len(targets)
    out = []
    for c in range(n_classes):
        y = (targets == c).astype(np.int64)
        scores = probs[:, c]
        if y.min() == y.max():
            out.append({"class": c, "auroc": 0.0, "ci_low": 0.0, "ci_high": 0.0})
            continue
        point = binary_auroc(scores, y)
        samples = []
        for _ in range(n_boot):
            idx = rng.integers(0, n, n)
            yy = y[idx]
            if yy.min() == yy.max():
                continue
            samples.append(binary_auroc(scores[idx], yy))
        arr = np.asarray(samples) if samples else np.array([point])
        lo, hi = (1 - ci) / 2, 1 - (1 - ci) / 2
        out.append({
            "class": c, "auroc": point,
            "ci_low": float(np.quantile(arr, lo)),
            "ci_high": float(np.quantile(arr, hi)),
        })
    return out


def plot_runs_comparison(
    results: list[tuple[str, np.ndarray, np.ndarray, dict]],
    n_classes: int,
    out_stem: str | Path,
) -> None:
    """Multi-run comparison figures (ref plot_combined): overlaid patient-level
    ROC curves (one per run, AUC + CI in the legend) and an AUROC bar chart
    with CI whiskers."""
    from transmil_deepgraft_tpu_torch.utils.plots import pyplot

    plt = pyplot()

    from transmil_deepgraft_tpu_torch.train.metrics import _roc_points
    from transmil_deepgraft_tpu_torch.utils.config import COLOR_MAP

    out_stem = Path(out_stem)
    out_stem.parent.mkdir(parents=True, exist_ok=True)

    fig, ax = plt.subplots(figsize=(6, 6))
    for i, (name, probs, targets, summary) in enumerate(results):
        scores = probs[:, 1] if n_classes <= 2 else probs.max(-1)
        y = targets if n_classes <= 2 else (probs.argmax(-1) == targets).astype(int)
        fpr, tpr, _ = _roc_points(np.asarray(scores, np.float64), np.asarray(y))
        ax.plot(
            fpr, tpr, color=COLOR_MAP[i % len(COLOR_MAP)],
            label=f"{name} AUC={summary['auroc']:.3f} "
                  f"[{summary['ci_low']:.3f}, {summary['ci_high']:.3f}]",
        )
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("1 - specificity")
    ax.set_ylabel("sensitivity")
    ax.legend(fontsize=7)
    fig.savefig(f"{out_stem}_roc_comparison.png", dpi=150, bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(max(4, len(results)), 4))
    names = [r[0] for r in results]
    aucs = [r[3]["auroc"] for r in results]
    err = np.array([
        [r[3]["auroc"] - r[3]["ci_low"] for r in results],
        [r[3]["ci_high"] - r[3]["auroc"] for r in results],
    ])
    ax.bar(range(len(results)), aucs, yerr=err, capsize=4,
           color=[COLOR_MAP[i % len(COLOR_MAP)] for i in range(len(results))])
    ax.set_xticks(range(len(results)))
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=7)
    ax.set_ylabel("patient AUROC (95% CI)")
    ax.set_ylim(0, 1)
    fig.savefig(f"{out_stem}_auroc_bars.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_combined_confusions(
    results: list[tuple[str, np.ndarray, np.ndarray, dict]],
    n_classes: int,
    out_path: str | Path,
    task: str = "",
) -> None:
    """Grid of per-run confusion matrices in one figure (ref
    ``export_metrics.py:576-675`` plot_combined_cm)."""
    from transmil_deepgraft_tpu_torch.utils.plots import pyplot

    plt = pyplot()

    from transmil_deepgraft_tpu_torch.train.metrics import confusion_matrix
    from transmil_deepgraft_tpu_torch.utils.plots import _class_names

    names_c = _class_names(task, n_classes)
    n = len(results)
    cols = min(3, n)
    rows_n = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows_n, cols, figsize=(3.2 * cols, 3.0 * rows_n),
                             squeeze=False)
    for idx, (name, probs, targets, _) in enumerate(results):
        ax = axes[idx // cols][idx % cols]
        preds = probs.argmax(-1)
        cm = confusion_matrix(preds, targets, n_classes)
        ax.imshow(cm, cmap="Blues")
        for i in range(n_classes):
            for j in range(n_classes):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center", fontsize=8)
        ax.set_title(name, fontsize=8)
        ax.set_xticks(range(n_classes))
        ax.set_xticklabels(names_c, rotation=30, fontsize=6)
        ax.set_yticks(range(n_classes))
        ax.set_yticklabels(names_c, fontsize=6)
    for idx in range(n, rows_n * cols):
        axes[idx // cols][idx % cols].axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_pr_comparison(
    results: list[tuple[str, np.ndarray, np.ndarray, dict]],
    n_classes: int,
    out_path: str | Path,
) -> None:
    """Overlaid patient-level precision-recall curves across runs (the PR half
    of ref plot_combined)."""
    from transmil_deepgraft_tpu_torch.utils.plots import pyplot

    plt = pyplot()

    from transmil_deepgraft_tpu_torch.utils.config import COLOR_MAP

    fig, ax = plt.subplots(figsize=(6, 6))
    for i, (name, probs, targets, _) in enumerate(results):
        scores = probs[:, 1] if n_classes <= 2 else probs.max(-1)
        y = targets if n_classes <= 2 else (probs.argmax(-1) == targets).astype(int)
        order = np.argsort(-np.asarray(scores, np.float64))
        y_sorted = np.asarray(y)[order]
        tp = np.cumsum(y_sorted)
        precision = tp / np.arange(1, len(y_sorted) + 1)
        recall = tp / max(1, y_sorted.sum())
        ax.plot(recall, precision, color=COLOR_MAP[i % len(COLOR_MAP)], label=name)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_ylim(0, 1.05)
    ax.legend(fontsize=7)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def export_combined(run_dirs: list[str | Path], task: str, n_classes: int, out_csv: str | Path) -> None:
    """Summary CSV + multi-run comparison figures across runs
    (ref plot_combined/get_csv, ``export_metrics.py:34-786``)."""
    import pandas as pd

    rows = []
    results = []
    for d in run_dirs:
        try:
            s = export_run(d, task, n_classes)
            probs, targets, _ = read_patient_results(
                Path(d) / "TEST_RESULT_PATIENT.csv", task, n_classes
            )
            for pc in bootstrap_auroc_per_class(probs, targets, n_classes, n_boot=200):
                rows.append({"run": str(d), **s, **{f"class_{pc['class']}_{k}": v
                            for k, v in pc.items() if k != "class"}})
            results.append((Path(d).name, probs, targets, s))
        except FileNotFoundError:
            continue
    pd.DataFrame(rows).to_csv(out_csv, index=False)
    if results:
        stem = Path(out_csv).with_suffix("")
        plot_runs_comparison(results, n_classes, stem)
        plot_combined_confusions(results, n_classes, f"{stem}_confusions.png", task)
        plot_pr_comparison(results, n_classes, f"{stem}_pr_comparison.png")


def scan_log_tree(
    log_root: str | Path,
    project: str | None = None,
    model: str | None = None,
    task: str | None = None,
) -> list[dict]:
    """Discover finished runs in the project log tree — the reference's
    ``get_data`` surface (``export_metrics.py:198-260`` walks
    ``logs/{project}/{model}/{task}/..._{loss}/.../version_{v}/test_epoch_{e}``
    for result CSVs; this framework's tree is
    ``{log_path}/{project}/{model}/{task}/_{backbone}_{loss}`` with kfold runs
    nesting ``fold{k}`` dirs — ``utils/config.finalize_config``).

    Returns one dict per run dir holding a ``TEST_RESULT_PATIENT.csv``:
    ``{"dir", "project", "model", "task", "variant"}``, filtered by the
    optional project/model/task arguments (case-insensitive exact match).
    Feed the ``dir`` values to :func:`export_combined` /
    ``cli.export_metrics --log_root``.
    """
    root = Path(log_root)
    runs: list[dict] = []
    for csv in sorted(root.rglob("TEST_RESULT_PATIENT.csv")):
        run_dir = csv.parent
        rel = run_dir.relative_to(root).parts
        # walk up past version_/fold subdirs to the _{backbone}_{loss} leaf
        fields = [p for p in rel if not (p.startswith(("version_", "fold")))]
        info = {
            "dir": str(run_dir),
            "project": fields[0] if len(fields) > 3 else None,
            "model": fields[1] if len(fields) > 3 else None,
            "task": fields[2] if len(fields) > 3 else None,
            "variant": fields[3] if len(fields) > 3 else (fields[-1] if fields else None),
        }
        for key, want in (("project", project), ("model", model), ("task", task)):
            if want is not None and (info[key] or "").lower() != want.lower():
                break
        else:
            runs.append(info)
    return runs
