"""AttMIL: Ilse-style gated attention pooling MIL head (port of
``models/attmil.py``).

Ref ``code/models/AttMIL.py:20-110``: the fc1 input MLP (2048 -> 1024 -> 512,
or in_features -> 512), gated attention ``A = w^T(tanh(V H) * sigmoid(U H))``
softmaxed over instances (L 512, D 128, K 1), bag feature ``M = A H``, a
linear classifier. Parameter names are the reference's (``_fc1.<i>``,
``attention_V.0``, ``attention_U.0``, ``attention_weights``,
``classifier.0``); the attention math is
:func:`~transmil_deepgraft_tpu_torch.ops.pooling.gated_attention_pool`.
"""

from __future__ import annotations

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import GELU, Dropout
from transmil_deepgraft_tpu_torch.ops.pooling import gated_attention_pool


class AttMIL(nn.Module):
    flax_classifier = "classifier"  # the flax name of the (width, n_classes) classifier
    gives_attention = True  # return_attn gives per-tile scores

    def __init__(self, n_classes: int, in_features: int = 2048, out_features: int = 512,
                 attn_dim: int = 128, attn_heads: int = 1) -> None:
        super().__init__()
        if in_features == 2048:
            half = in_features // 2
            self._fc1 = nn.Sequential(nn.Linear(in_features, half), GELU(), Dropout(0.6),
                                      nn.LayerNorm(half, eps=1e-5),
                                      nn.Linear(half, out_features), GELU())
        else:
            self._fc1 = nn.Sequential(nn.Linear(in_features, out_features), GELU(), Dropout(0.6),
                                      nn.LayerNorm(out_features, eps=1e-5))
        self.attention_V = nn.Sequential(nn.Linear(out_features, attn_dim), nn.Tanh())
        self.attention_U = nn.Sequential(nn.Linear(out_features, attn_dim), nn.Sigmoid())
        self.attention_weights = nn.Linear(attn_dim, attn_heads)
        self.classifier = nn.Sequential(nn.Linear(out_features * attn_heads, n_classes))

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, N, in_features) -> (B, C) logits; with ``return_attn`` also the
        (B, K, N) attention."""
        if x.dim() == 2:
            x = x[None]
        h = self._fc1(x.float())
        v, u, w = self.attention_V[0], self.attention_U[0], self.attention_weights
        pooled, attn = gated_attention_pool(h, v.weight.T, u.weight.T, w.weight.T,
                                            v_b=v.bias, u_b=u.bias, w_b=w.bias)
        logits = self.classifier(pooled.reshape(pooled.shape[0], -1))
        return (logits, attn) if return_attn else logits
