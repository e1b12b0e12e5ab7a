"""DSMIL: dual-stream MIL (Li et al., CVPR 2021; port of ``models/dsmil.py``).

The instance stream ``i_classifier`` gives (B, N, C) instance logits; their
per-class max is the max-pooling prediction and their per-class argmax the
critical instance (``torch.argmax`` takes the first maximal index, as
``jnp.argmax``). The bag stream: each instance's query (``q0`` ReLU ``q1``
tanh) against the critical instances' queries, scaled by sqrt(q_dim) and
softmaxed over instances, pools the ReLU values ``v`` into one embedding a
class; ``fcc`` maps the flattened (C, in_features) block to the bag logits.
The head returns ``0.5 * (bag + max_instance)``; ``return_attn`` adds the
predicted class's attention column (B, N).

``lengths`` ((B,) real bag lengths) masks the rows past each length with
-1e9 in the instance logits and the attention scores. Without it, zero pad
rows (a bucketed bag) share the ``i_classifier`` bias as their logit and
can win the argmax, as in JAX. Parameter names are the flax module names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import Dropout


class DSMIL(nn.Module):
    flax_classifier = "fcc"  # the (n_classes * in_features, n_classes) bag head
    gives_attention = True  # return_attn gives the predicted class's column

    def __init__(self, n_classes: int, in_features: int = 2048, q_dim: int = 128,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.n_classes, self.q_dim = n_classes, q_dim
        self.i_classifier = nn.Linear(in_features, n_classes)
        self.q0 = nn.Linear(in_features, q_dim)
        self.q1 = nn.Linear(q_dim, q_dim)
        self.dropout = Dropout(dropout)
        self.v = nn.Linear(in_features, in_features)
        self.fcc = nn.Linear(n_classes * in_features, n_classes)

    def _query(self, t: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.q1(torch.relu(self.q0(t))))

    def forward(self, x: torch.Tensor, return_attn: bool = False,
                lengths: Optional[torch.Tensor] = None):
        if x.dim() == 2:
            x = x[None]
        h = x.float()  # (B, N, D)
        ins_logits = self.i_classifier(h)  # (B, N, C)
        real = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=h.device).reshape(h.shape[0])
            real = (torch.arange(h.shape[1], device=h.device)[None] < lengths[:, None])[..., None]
            ins_logits = torch.where(real, ins_logits, torch.full_like(ins_logits, -1e9))
        v = torch.relu(self.v(self.dropout(h)))  # (B, N, D)
        crit = torch.argmax(ins_logits, dim=1)  # (B, C)
        m_feats = torch.gather(h, 1, crit[..., None].expand(-1, -1, h.shape[-1]))  # (B, C, D)
        attn = torch.einsum("bnq,bcq->bnc", self._query(h), self._query(m_feats))
        attn = attn / torch.sqrt(torch.tensor(float(self.q_dim)))
        if real is not None:
            attn = torch.where(real, attn, torch.full_like(attn, -1e9))
        attn = torch.softmax(attn, dim=1)  # over instances, per class
        bag = torch.einsum("bnc,bnv->bcv", attn, v)  # (B, C, D)
        bag_logits = self.fcc(bag.reshape(bag.shape[0], -1))
        logits = 0.5 * (bag_logits + ins_logits.max(dim=1).values)
        if return_attn:
            pred = torch.argmax(logits, dim=-1)
            scores = torch.gather(attn, 2, pred[:, None, None].expand(-1, attn.shape[1], 1))
            return logits, scores[..., 0]
        return logits
