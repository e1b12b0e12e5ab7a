"""MONAI-style MIL head, ``AttTrans`` in the reference configs (port of
``models/monai_mil.py``).

Ref ``code/models/MonaiMILModel.py:11-232``: modes ``mean`` and ``max`` (a
per-instance classifier, averaged or maxed over instances), ``att`` (tanh
attention ``Linear(nfc, 2048) -> Tanh -> Linear(2048, 1)`` softmaxed over
instances, then a classifier of the pooled feature) and ``att_trans`` (a
4-block post-norm ReLU ``nn.TransformerEncoder`` over the instances before
the attention; the reference wires it for 'AttTrans'). Parameter names are
the reference's (``myfc``, ``attention.{0,2}``, ``transformer.layers.<i>
.self_attn.in_proj_weight``, ...).

``att_trans_pyramid`` needs the backbone's per-stage feature pyramid
(``ResNet(return_pyramid=True)``), which the port's ResNet does not give yet
(ROADMAP A8): it raises.
"""

from __future__ import annotations

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import TorchTransformerEncoder

MODES = ("mean", "max", "att", "att_trans")


class MonaiMIL(nn.Module):
    flax_classifier = "myfc"  # the flax name of the (width, n_classes) classifier

    def __init__(self, n_classes: int, in_features: int = 2048, mil_mode: str = "att_trans",
                 trans_blocks: int = 4, trans_dropout: float = 0.0) -> None:
        super().__init__()
        if mil_mode == "att_trans_pyramid":
            raise NotImplementedError("MonaiMIL att_trans_pyramid needs the backbone's feature "
                                      "pyramid (return_pyramid), not ported yet (ROADMAP A8)")
        if mil_mode not in MODES:
            raise ValueError(f"unsupported mil_mode '{mil_mode}'")
        self.mil_mode = mil_mode
        # return_attn gives per-tile scores in the att modes, None for mean/max
        self.gives_attention = mil_mode in ("att", "att_trans")
        self.myfc = nn.Linear(in_features, n_classes)
        if mil_mode in ("att", "att_trans"):
            self.attention = nn.Sequential(nn.Linear(in_features, 2048), nn.Tanh(),
                                           nn.Linear(2048, 1))
        if mil_mode == "att_trans":
            self.transformer = TorchTransformerEncoder(in_features, trans_blocks, nhead=8,
                                                       dropout=trans_dropout)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, N, in_features) -> (B, C) logits; with ``return_attn`` also the
        (B, 1, N) attention of the att modes (None for mean/max)."""
        if x.dim() == 2:
            x = x[None]
        h = x.float()
        attn = None
        if self.mil_mode == "mean":
            logits = self.myfc(h).mean(dim=1)
        elif self.mil_mode == "max":
            logits = self.myfc(h).max(dim=1).values
        else:
            if self.mil_mode == "att_trans":
                h = self.transformer(h)
            a = torch.softmax(self.attention(h), dim=1)  # (B, N, 1)
            logits = self.myfc((h * a).sum(dim=1))
            attn = a.transpose(1, 2)
        return (logits, attn) if return_attn else logits
