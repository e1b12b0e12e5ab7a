"""Spatial ResNet MIL head: a ResNet50 classifier over feature volumes (port
of ``models/spatial_resnet.py``).

The reference's ``model.name == 'resnet50'`` branch
(``model_interface.py:131-139``): a ResNet50 whose conv1 takes
``in_features`` channels, on the (50, 50, in_features) volumes of
``data/local_features.py`` (NHWC), then ``fc``. At 50x50 the stages run at
25, 13, 7, 4 and 2: JAX pads every conv and the max-pool explicitly by
``k // 2``, as the port's symmetric ``padding=k//2`` does. BatchNorm has
flax's train-mode semantics (:class:`~.resnet.BatchNorm2d`, momentum 0.9).
"""

from __future__ import annotations

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.resnet import Bottleneck, ResNet


class SpatialResNetMIL(nn.Module):
    flax_classifier = "fc"  # the flax name of the (2048, n_classes) classifier
    gives_attention = False  # no attention

    def __init__(self, n_classes: int, in_features: int = 2048) -> None:
        super().__init__()
        self.resnet = ResNet(Bottleneck, (3, 4, 6, 3), in_channels=in_features)
        self.fc = nn.Linear(self.resnet.feature_dim, n_classes)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, H, W, D) or (H, W, D) -> (B, C) logits (``return_attn``: and None)."""
        if x.dim() == 3:
            x = x[None]
        logits = self.fc(self.resnet(x.float()))
        return (logits, None) if return_attn else logits
