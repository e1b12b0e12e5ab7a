"""MDMIL: TransMIL behind a one-layer tokenizer (port of ``models/mdmil.py``).

Ref ``code/models/MDMIL.py:47-141``: ``_fc1`` = Linear + exact GELU (no
dropout), then TransMIL's body (:class:`~.transmil.TransMILBody`: cls token,
TransLayer 1, PPEG, TransLayer 2, LayerNorm, ``_fc2``). ``return_attn``
defaults to True, as in JAX, and the payload holds the cls token's own row
of layer 2 (the reference's ``attn[:, :, 0, :]``). Asked for logits alone
(``return_attn=False``, what serving asks), the two TransLayers run fused at
inference: the K1/K2 kernels on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import GELU, PPEG, TransLayer
from transmil_deepgraft_tpu_torch.models.transmil import TransMILAttention, TransMILBody


class MDMIL(TransMILBody):
    flax_classifier = "fc2"  # the flax name of the (width, n_classes) classifier
    gives_attention = True  # return_attn gives the TransMILAttention row

    def __init__(self, n_classes: int, in_features: int = 1024, out_features: int = 512) -> None:
        super().__init__()
        self.out_features = out_features
        self.fused_inference = True  # False: the standard layers at inference too
        self.pos_layer = PPEG(dim=out_features)
        self._fc1 = nn.Sequential(nn.Linear(in_features, out_features), GELU())
        self.cls_token = nn.Parameter(torch.randn(1, 1, out_features))
        self.layer1 = TransLayer(dim=out_features)
        self.layer2 = TransLayer(dim=out_features)
        self.norm = nn.LayerNorm(out_features, eps=1e-5)
        self._fc2 = nn.Linear(out_features, n_classes)

    def forward(self, x: torch.Tensor, return_attn: bool = True):
        if x.dim() == 2:
            x = x[None]
        logits, attn_row, pad, n_tokens = self._body(self._fc1(x.float()), self._fc2,
                                                     0 if return_attn else None)
        if return_attn:
            return logits, TransMILAttention(row=attn_row, pad=pad, n_tokens=n_tokens)
        return logits
