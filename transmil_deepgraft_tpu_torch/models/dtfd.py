"""DTFD-MIL: two-tier double-feature-distillation MIL (port of
``models/dtfd.py``).

Ref ``code/models/DTFDMIL.py:14-108`` and ``model_interface_dtfd.py:174-224``:
the bag splits into at most 8 pseudo-bags of 120 instances; tier 1 runs
DimReduction -> gated attention -> attention-weighted sum -> a 1-fc
classifier a pseudo-bag; tier 2 a gated attention + classifier over the
stacked pseudo-bag features. The tiers train under two optimizers
(``train/optimizers.create_dtfd_optimizer``, split by
:meth:`DTFDMIL.parameter_groups`).

The pseudo-bag count and size come from the input's length, padded rows
included: a 300-tile bag served in the 512 bucket runs 4 pseudo-bags of 120
rows, 180 of them zero pads, as the JAX bundles do. The split is a random
permutation in train mode (:class:`PseudoBagShuffle`, whose generator the
Trainer seeds) and the identity in eval mode.

Parameter names are the reference's (``dimreduction.fc1``,
``attention.attention_V.0``, ``classifier.fc``, ``attCls.attention.*``,
``attCls.classifier.fc``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.ops.pooling import gated_attention_pool


class DimReduction(nn.Module):
    """Linear (no bias) + ReLU (ref ``DTFDMIL.py:90-108``)."""

    def __init__(self, in_features: int, m_dim: int = 512) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_features, m_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc1(x))


class GatedAttention(nn.Module):
    """K-head gated attention (ref ``DTFDMIL.py:14-46``): (..., N, L) ->
    (pooled (..., K, L), attention (..., K, N))."""

    def __init__(self, features: int = 512, d_dim: int = 128, k_heads: int = 1) -> None:
        super().__init__()
        self.attention_V = nn.Sequential(nn.Linear(features, d_dim), nn.Tanh())
        self.attention_U = nn.Sequential(nn.Linear(features, d_dim), nn.Sigmoid())
        self.attention_weights = nn.Linear(d_dim, k_heads)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        v, u, w = self.attention_V[0], self.attention_U[0], self.attention_weights
        return gated_attention_pool(x, v.weight.T, u.weight.T, w.weight.T,
                                    v_b=v.bias, u_b=u.bias, w_b=w.bias)


class Classifier1fc(nn.Module):
    def __init__(self, features: int, n_classes: int) -> None:
        super().__init__()
        self.fc = nn.Linear(features, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class AttentionWithClassifier(nn.Module):
    """Tier 2: gated attention pool + linear classifier (ref ``DTFDMIL.py:47-60``)."""

    def __init__(self, n_classes: int, features: int = 512, d_dim: int = 128) -> None:
        super().__init__()
        self.attention = GatedAttention(features, d_dim)
        self.classifier = Classifier1fc(features, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.attention(x)[0])


class PseudoBagShuffle(nn.Module):
    """The pseudo-bags' row order: a permutation from ``generator`` (the
    global stream when None) in train mode, the identity in eval mode."""

    generator: Optional[torch.Generator] = None

    def forward(self, n: int, device: torch.device) -> torch.Tensor:
        if not self.training:
            return torch.arange(n, device=device)
        return torch.randperm(n, generator=self.generator, device=device)


class DTFDMIL(nn.Module):
    flax_classifier = "classifier"  # tier 1's (512, n_classes) classifier
    gives_attention = False  # return_attn gives pseudo-bag attention, no per-tile scores

    def __init__(self, n_classes: int, in_features: int = 1024, m_dim: int = 512,
                 pseudo_bag_size: int = 120, max_pseudo_bags: int = 8) -> None:
        super().__init__()
        self.pseudo_bag_size, self.max_pseudo_bags = pseudo_bag_size, max_pseudo_bags
        self.dimreduction = DimReduction(in_features, m_dim)
        self.attention = GatedAttention(m_dim)
        self.classifier = Classifier1fc(m_dim, n_classes)
        self.attCls = AttentionWithClassifier(n_classes, m_dim)
        self.shuffle = PseudoBagShuffle()

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(N, D) or (1, N, D) -> (sub_predictions (G, C), slide_prediction
        (1, C)); ``return_attn`` adds the tier-1 attention (G, pseudo-bag)."""
        if x.dim() == 3:
            if x.shape[0] != 1:
                raise ValueError(f"DTFDMIL processes one slide at a time (got batch="
                                 f"{x.shape[0]}); use batch_size=1")
            x = x[0]
        n = x.shape[0]
        g = max(1, min(self.max_pseudo_bags, n // self.pseudo_bag_size))
        pb = min(self.pseudo_bag_size, n)
        feats = self.dimreduction(x.float())
        bags = feats[self.shuffle(n, x.device)[:g * pb].reshape(g, pb)]  # (G, pb, m)
        pooled, t1_attn = self.attention(bags)
        pooled = pooled[:, 0]  # (G, m)
        sub_predictions = self.classifier(pooled)
        slide_prediction = self.attCls(pooled)  # (1, C)
        if return_attn:
            return sub_predictions, slide_prediction, t1_attn[:, 0]
        return sub_predictions, slide_prediction

    def parameter_groups(self) -> tuple[list[nn.Parameter], list[nn.Parameter]]:
        """(tier 1, tier 2) parameters for the two optimizers (ref
        ``model_interface_dtfd.py:166-172``): tier 2 is ``attCls``."""
        tier2 = list(self.attCls.parameters())
        ids = {id(p) for p in tier2}
        return [p for p in self.parameters() if id(p) not in ids], tier2
