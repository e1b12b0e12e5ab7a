"""Classic per-tile classifiers (port of ``models/classic.py``): the
reference's ModelInterface_Classic zoo.

Ref ``code/models/model_interface_classic.py:197-305``: a CNN or ViT over
single tiles (each with its slide's label): a backbone of
``models/backbones.create_backbone`` with ``out_features=512`` (inception,
resnet18, resnet50, vit, efficientnet, simple), then a Linear ``fc`` to the
classes. It pairs with the ``tiles`` variant and
``TrainerConfig(tile_level=True)``; inception takes 299x299 tiles. The
backbone runs in the module's mode, so its BatchNorm trains with flax's rule
in train mode (the JAX Trainer cannot train it, ROADMAP C6). Flax names the
backbone by its class (``VisionTransformer_0``; a ``ProjectedBackbone``'s
network and projection are siblings there, ``ResNet_0`` and
``ProjectedBackbone_0/proj``): ``utils/jax_params.classic_state_dict_from_jax``
and ``classic_variables_from_module`` carry the variables both ways.
"""

from __future__ import annotations

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.backbones import create_backbone


class ClassicTileClassifier(nn.Module):
    def __init__(self, n_classes: int, backbone_name: str = "resnet18") -> None:
        super().__init__()
        self.backbone, dim = create_backbone(backbone_name, out_features=512)
        self.fc = nn.Linear(dim, n_classes)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, H, W, 3) tiles (a (B, N, H, W, 3) bag is flattened to its
        tiles) in the model's dtype (JAX casts to float32) -> (B, n_classes)
        logits; ``return_attn`` gives (logits, None)."""
        if x.dim() == 5:
            x = x.reshape(-1, *x.shape[2:])
        logits = self.fc(self.backbone(x.to(self.fc.weight.dtype)))
        return (logits, None) if return_attn else logits


def classic_model(name: str, n_classes: int) -> ClassicTileClassifier:
    """'resnet18' / 'resnet50' / 'vit' / 'efficientnet' / 'inception' /
    'simple' tile classifiers."""
    return ClassicTileClassifier(n_classes=n_classes, backbone_name=name)
