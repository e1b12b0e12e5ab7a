"""Slide -> patient score aggregation (a copy of the JAX
package's ``train/aggregation.py``; numpy only).

Ref ``code/models/model_interface.py:519-562`` (val) / ``:714-760`` (test): slides
group by patient; for binary tasks, if any slide of a patient argmaxes positive,
only those positive slides are kept before averaging (the "positive-slide filter"
- a deliberate sensitivity bias); otherwise the patient score is the mean of all
its slide probability vectors. Patient target is the first-seen slide target.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PatientAggregate:
    patients: list[str]
    scores: np.ndarray  # (P, C) aggregated probability vectors
    targets: np.ndarray  # (P,)
    slide_scores: dict[str, list[tuple[str, np.ndarray]]] = field(default_factory=dict)


def aggregate_patients(
    probs: np.ndarray,
    targets: np.ndarray,
    slide_names: list[str],
    patients: list[str],
    n_classes: int,
) -> PatientAggregate:
    probs = np.asarray(probs)
    targets = np.asarray(targets).ravel()

    per_patient: dict[str, list[tuple[str, np.ndarray]]] = {}
    patient_target: dict[str, int] = {}
    order: list[str] = []
    for p, s, pr, t in zip(patients, slide_names, probs, targets):
        if p not in per_patient:
            per_patient[p] = []
            patient_target[p] = int(t)
            order.append(p)
        per_patient[p].append((s, pr))

    agg_scores = []
    for p in order:
        score = np.stack([pr for _, pr in per_patient[p]])  # (S, C)
        if n_classes == 2:
            positive = score.argmax(-1) == 1
            if positive.any():
                score = score[positive]
        agg_scores.append(score.mean(0) if score.ndim > 1 else score)

    return PatientAggregate(
        patients=order,
        scores=np.stack(agg_scores),
        targets=np.array([patient_target[p] for p in order]),
        slide_scores=per_patient,
    )


def _positive_filter_mean(score: np.ndarray, n_classes: int) -> np.ndarray:
    """Binary positive-argmax filter then mean (the reference's repeated motif)."""
    if n_classes == 2:
        positive = score.argmax(-1) == 1
        if positive.any():
            score = score[positive]
    return score.mean(0) if score.ndim > 1 else score


def aggregate_tiles_to_patients(
    probs: np.ndarray,
    targets: np.ndarray,
    slide_names: list[str],
    patients: list[str],
    n_classes: int,
) -> PatientAggregate:
    """Two-level aggregation for the classic per-tile pipeline
    (ref ``model_interface_classic.py:643-700``): tiles -> slide scores with the
    binary positive-tile filter, then slides -> patient scores with the
    positive-slide filter."""
    probs = np.asarray(probs)
    targets = np.asarray(targets).ravel()

    per: dict[str, dict[str, list[np.ndarray]]] = {}
    patient_target: dict[str, int] = {}
    order: list[str] = []
    for p, s, pr, t in zip(patients, slide_names, probs, targets):
        if p not in per:
            per[p] = {}
            patient_target[p] = int(t)
            order.append(p)
        per[p].setdefault(s, []).append(pr)

    agg_scores = []
    slide_scores: dict[str, list[tuple[str, np.ndarray]]] = {}
    for p in order:
        slide_level = []
        slide_scores[p] = []
        for s, tile_probs in per[p].items():
            sscore = _positive_filter_mean(np.stack(tile_probs), n_classes)
            slide_level.append(sscore)
            slide_scores[p].append((s, sscore))
        agg_scores.append(_positive_filter_mean(np.stack(slide_level), n_classes))

    return PatientAggregate(
        patients=order,
        scores=np.stack(agg_scores),
        targets=np.array([patient_target[p] for p in order]),
        slide_scores=slide_scores,
    )
