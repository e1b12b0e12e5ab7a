"""TransformerMIL: a pre-norm ViT-style encoder over bags (port of
``models/transformer_mil.py``).

Ref ``code/models/TransformerMIL.py:74-152``: fc1 per in_features -> cls
token -> embedding dropout (0.5) -> two TransformerBlocks (depth 2, 8 heads
x 64, mlp 512, dropout 0.5) -> cls (or mean) pool -> LayerNorm -> linear
head. The fc1 branches: 2048 (Linear 2048->1024, GELU, Dropout .6, LN,
Linear 1024->out, GELU), 1024 (Linear, GELU, Dropout .6, LN), else (Linear,
ReLU). Parameter names are the reference's (``fc1.<i>``, ``cls_token``,
``transformer{1,2}.layers.<i>.{0,1}...``, ``norm``, ``_fc2``).

The attention is dense (b*h*n^2): on the card it runs through
``scaled_dot_product_attention`` (``ops/attention``), so a 40,960-tile bag
fits.
"""

from __future__ import annotations

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import GELU, Dropout, TransformerBlock


def transformer_fc1(in_features: int, out_features: int) -> nn.Sequential:
    """TransformerMIL's fc1 branches (ref ``TransformerMIL.py:106-119``)."""
    if in_features == 2048:
        half = in_features // 2
        return nn.Sequential(nn.Linear(in_features, half), GELU(), Dropout(0.6),
                             nn.LayerNorm(half, eps=1e-5), nn.Linear(half, out_features), GELU())
    if in_features == 1024:
        return nn.Sequential(nn.Linear(in_features, out_features), GELU(), Dropout(0.6),
                             nn.LayerNorm(out_features, eps=1e-5))
    return nn.Sequential(nn.Linear(in_features, out_features), nn.ReLU())


class TransformerMIL(nn.Module):
    flax_classifier = "fc2"  # the flax name of the (width, n_classes) classifier
    gives_attention = False  # return_attn gives None, as in JAX

    def __init__(self, n_classes: int, in_features: int = 2048, out_features: int = 512,
                 pool: str = "cls", dropout: float = 0.5, emb_dropout: float = 0.5) -> None:
        super().__init__()
        self.pool = pool
        self.fc1 = transformer_fc1(in_features, out_features)
        self.cls_token = nn.Parameter(torch.randn(1, 1, out_features))
        self.dropout = Dropout(emb_dropout)
        self.transformer1 = TransformerBlock(out_features, 2, 8, 64, 512, dropout)
        self.transformer2 = TransformerBlock(out_features, 2, 8, 64, 512, dropout)
        self.norm = nn.LayerNorm(out_features, eps=1e-5)
        self._fc2 = nn.Linear(out_features, n_classes)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, N, in_features) -> (B, C) logits; ``return_attn`` gives
        (logits, None), as the JAX head does."""
        if x.dim() == 2:
            x = x[None]
        h = self.fc1(x.float())
        h = torch.cat([self.cls_token.expand(h.shape[0], -1, -1), h], dim=1)
        h = self.transformer2(self.transformer1(self.dropout(h)))
        logits = self._fc2(self.norm(h.mean(dim=1) if self.pool == "mean" else h[:, 0]))
        return (logits, None) if return_attn else logits
