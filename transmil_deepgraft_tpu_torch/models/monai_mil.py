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

``att_trans_pyramid`` takes the backbone's per-stage pooled features
(``ResNet(return_pyramid=True)``, streamed by ``ImageMILModel(pyramid=True)``)
through a cascade of encoders (ref ``MonaiMILModel.py:127-155``): T0 over
layer1's 256-d, then [T_{i-1}, layer_i] through a Linear to 256 and T_i for
layers 2 and 3, then T3 over [T2, layer4] at 2,304-d, the attention pool
and the classifier at that width. Its names are the reference's
(``transformer.0``, ``transformer.1.0`` the Linear, ``transformer.1.1``
the encoder, ..., ``transformer.3``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import TorchTransformerEncoder

MODES = ("mean", "max", "att", "att_trans", "att_trans_pyramid")
PYRAMID_DIMS = (256, 512, 1024, 2048)  # the ResNet50 stages' output widths


class MonaiMIL(nn.Module):
    flax_classifier = "myfc"  # the flax name of the (width, n_classes) classifier

    def __init__(self, n_classes: int, in_features: int = 2048, mil_mode: str = "att_trans",
                 trans_blocks: int = 4, trans_dropout: float = 0.0) -> None:
        super().__init__()
        if mil_mode not in MODES:
            raise ValueError(f"unsupported mil_mode '{mil_mode}'")
        self.mil_mode = mil_mode
        # return_attn gives per-tile scores in the att modes, None for mean/max
        self.gives_attention = mil_mode not in ("mean", "max")
        pyramid = mil_mode == "att_trans_pyramid"
        nfc = PYRAMID_DIMS[-1] + 256 if pyramid else in_features
        self.myfc = nn.Linear(nfc, n_classes)
        if self.gives_attention:
            self.attention = nn.Sequential(nn.Linear(nfc, 2048), nn.Tanh(), nn.Linear(2048, 1))

        def encoder(d: int) -> TorchTransformerEncoder:
            return TorchTransformerEncoder(d, trans_blocks, nhead=8, dropout=trans_dropout)

        if mil_mode == "att_trans":
            self.transformer = encoder(in_features)
        elif pyramid:
            self.transformer = nn.ModuleList(
                [encoder(256)]
                + [nn.Sequential(nn.Linear(256 + d, 256), encoder(256)) for d in PYRAMID_DIMS[1:3]]
                + [encoder(nfc)])

    def forward(self, x: torch.Tensor, return_attn: bool = False,
                pyramid: Optional[Sequence[torch.Tensor]] = None):
        """(B, N, in_features) -> (B, C) logits; with ``return_attn`` also the
        (B, 1, N) attention of the att modes (None for mean/max).
        ``att_trans_pyramid`` reads the four (B, N, D_s) stage features of
        ``pyramid``."""
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
            elif self.mil_mode == "att_trans_pyramid":
                if pyramid is None:
                    raise ValueError("att_trans_pyramid needs the backbone feature pyramid "
                                     "(ResNet(..., return_pyramid=True) stage features l1..l4)")
                levels = [p.float() for p in pyramid]
                h = self.transformer[0](levels[0])
                for stage in (1, 2):
                    h = self.transformer[stage](torch.cat([h, levels[stage]], dim=-1))
                h = self.transformer[3](torch.cat([h, levels[3]], dim=-1))
            a = torch.softmax(self.attention(h), dim=1)  # (B, N, 1)
            logits = self.myfc((h * a).sum(dim=1))
            attn = a.transpose(1, 2)
        return (logits, attn) if return_attn else logits
