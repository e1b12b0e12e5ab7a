"""SimCLR: a backbone + 2-layer projection head and the NT-Xent loss (port
of ``models/simclr.py``; ref ``code/models/SimCLR.py:1-61``).

``nt_xent`` is the contrastive loss over a batch of paired projections;
:class:`SimCLRModel` wraps any backbone (``backbone``, then ``proj_fc1`` ->
ReLU -> ``proj_fc2``, the flax names).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def nt_xent(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """NT-Xent over a batch of paired views; z*: (B, D)."""
    b = z1.shape[0]
    z = torch.cat([z1, z2], dim=0)
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
    sim = (z @ z.T) / temperature  # (2B, 2B)
    eye = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    targets = torch.cat([torch.arange(b) + b, torch.arange(b)]).to(z.device)
    logp = F.log_softmax(sim, dim=-1)
    return -logp[torch.arange(2 * b, device=z.device), targets].mean()


class SimCLRModel(nn.Module):
    def __init__(self, backbone: nn.Module, feature_dim: int, proj_dim: int = 128,
                 hidden_dim: int = 2048) -> None:
        super().__init__()
        self.backbone = backbone
        self.proj_fc1 = nn.Linear(feature_dim, hidden_dim)
        self.proj_fc2 = nn.Linear(hidden_dim, proj_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_fc2(F.relu(self.proj_fc1(self.backbone(x))))

    @staticmethod
    def loss(model: "SimCLRModel", view1: torch.Tensor, view2: torch.Tensor,
             temperature: float = 0.5) -> torch.Tensor:
        return nt_xent(model(view1), model(view2), temperature)
