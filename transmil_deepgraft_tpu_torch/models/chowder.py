"""Chowder (Courtiol 2018): instance scorer + top/bottom-R score MLP (port of
``models/chowder.py``).

Ref ``code/models/Chowder.py:19-50``: a 1x1 Conv1d instance scorer (a linear
map to one score per instance), the bottom-R min and top-R max scores
(:func:`~transmil_deepgraft_tpu_torch.ops.pooling.topk_minmax_scores`), an
MLP 2R -> 200 -> 100 -> n_classes. Parameter names and shapes are the
reference's (``f1.0`` a Conv1d weight (1, L, 1), ``f2.<i>``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.ops.pooling import topk_minmax_scores


class Chowder(nn.Module):
    flax_classifier = "f2_2"  # the flax name of the (width, n_classes) classifier
    gives_attention = True  # return_attn gives per-tile scores

    def __init__(self, n_classes: int, in_features: int = 512, r: int = 5) -> None:
        super().__init__()
        self.r = r
        self.f1 = nn.Sequential(nn.Conv1d(in_features, 1, 1))
        self.f2 = nn.Sequential(nn.Linear(2 * r, 200), nn.Linear(200, 100),
                                nn.Linear(100, n_classes))

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, N, in_features) -> (B, C) logits; with ``return_attn`` also the
        (B, N) instance scores."""
        if x.dim() == 2:
            x = x[None]
        conv = self.f1[0]
        scores = F.linear(x.float(), conv.weight[:, :, 0], conv.bias)[..., 0]  # (B, N)
        logits = self.f2(topk_minmax_scores(scores, self.r))
        return (logits, scores) if return_attn else logits
