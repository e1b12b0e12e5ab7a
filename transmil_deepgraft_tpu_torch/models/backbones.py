"""Tile backbones and the image-bag MIL model (port of ``models/backbones.py``).

The reference's backbone selection (``code/models/model_interface.py:223-281``):
'features' (precomputed bags, no backbone), 'retccl' (RetCCL ResNet50 ->
2048-d), 'resnet50' (the CLAM baseline -> 1024-d), 'resnet18' (+ a Linear to
``out_features``), 'simple' (the Ilse CNN -> 1024-d). The ViT, DINO,
EfficientNet and Inception backbones are not ported yet (ROADMAP A8).

:class:`ImageMILModel` is the reference's ``ModelInterface.forward`` reshape
path (``model_interface.py:297-317``): the tiles of a batch of bags stream
through the frozen backbone in ``n_chunks`` sequential chunks (activation
memory is one chunk) into the bag head.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.models.resnet import (
    ResNet,
    resnet18,
    resnet50_baseline,
    retccl_resnet50,
)

BACKBONE_DIMS = {
    "retccl": 2048,
    "resnet50": 1024,
    "resnet18": 512,
    "simple": 1024,
    "vit": 768,
    "dino": 768,
    "efficientnet": 1280,
    "inception": 2048,
}
# the JAX package's other backbones, and the ROADMAP item that ports them
NOT_PORTED = {"vit": "A8", "dino": "A8", "efficientnet": "A8", "inception": "A8"}


class SimpleCNN(nn.Module):
    """The 'simple' backbone (ref ``model_interface.py:268-281``): two
    conv/pool stages, then a Linear to ``out_features``. Takes 224x224 NHWC
    tiles. The feature map flattens in flax's (H, W, C) order, so the fc
    weight is the flax kernel transposed."""

    def __init__(self, out_features: int = 1024) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 20, 5)
        self.conv2 = nn.Conv2d(20, 50, 5)
        self.fc = nn.Linear(53 * 53 * 50, out_features)  # 224 -> 220 -> 110 -> 106 -> 53

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.max_pool2d(F.relu(self.conv1(x.permute(0, 3, 1, 2))), 2)
        out = F.max_pool2d(F.relu(self.conv2(out)), 2)
        return F.relu(self.fc(out.permute(0, 2, 3, 1).flatten(1)))


class ProjectedBackbone(nn.Module):
    """A backbone and a trainable linear projection (the reference's
    resnet18 path: frozen conv stack, ``Linear(512, out_features)``)."""

    def __init__(self, backbone: nn.Module, in_features: int, out_features: int) -> None:
        super().__init__()
        self.backbone = backbone
        self.proj = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.backbone(x))


def create_backbone(name: str, out_features: int = 512) -> tuple[Optional[nn.Module], int]:
    """(module, feature width) of a backbone name; 'features' -> (None, 0):
    the bags are precomputed embeddings. The module is on the CPU."""
    if name == "features":
        return None, 0
    if name == "retccl":
        return retccl_resnet50(), 2048
    if name == "resnet50":
        return resnet50_baseline(), 1024
    if name == "resnet18":
        return ProjectedBackbone(resnet18(), 512, out_features), out_features
    if name == "simple":
        return SimpleCNN(), 1024
    if name in NOT_PORTED:
        raise NotImplementedError(f"backbone {name!r} is not ported yet (ROADMAP {NOT_PORTED[name]})")
    raise KeyError(f"unknown backbone '{name}'")


class ImageMILModel(nn.Module):
    """End-to-end image-bag MIL: tiles -> frozen backbone (chunked) -> bag head.

    Input (B, bag, H, W, 3) NHWC. The tiles run through the backbone in
    ``n_chunks`` sequential chunks (zero tiles pad the last so that the
    chunks are equal, as JAX's ``nn.scan`` needs), under ``no_grad`` (JAX's
    ``stop_gradient``). The backbone stays in eval mode whatever the mode of
    the model (flax's ``train=False``): its BatchNorm uses the running
    statistics and never updates them."""

    def __init__(self, backbone: nn.Module, head: nn.Module, n_chunks: int = 10,
                 pyramid: bool = False) -> None:
        super().__init__()
        if pyramid:
            raise NotImplementedError("the pyramid stream (att_trans_pyramid) is not ported yet "
                                      "(ROADMAP A8)")
        self.backbone = backbone.eval()
        self.head = head
        self.n_chunks = n_chunks

    def train(self, mode: bool = True) -> "ImageMILModel":
        super().train(mode)
        self.backbone.eval()
        return self

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, bag, H, W, C) tiles -> (B, bag, D) features."""
        b, bag = x.shape[:2]
        tiles = x.reshape(b * bag, *x.shape[2:])
        n_total = tiles.shape[0]
        chunks = max(1, min(self.n_chunks, n_total))
        pad = (-n_total) % chunks
        if pad:
            tiles = torch.cat([tiles, tiles.new_zeros((pad, *tiles.shape[1:]))])
        with torch.no_grad():
            feats = torch.cat([self.backbone(c) for c in tiles.chunk(chunks)])
        return feats[:n_total].reshape(b, bag, -1)

    def forward(self, x: torch.Tensor, **head_kwargs):
        return self.head(self.embed(x), **head_kwargs)


__all__ = ["BACKBONE_DIMS", "ImageMILModel", "ProjectedBackbone", "ResNet", "SimpleCNN",
           "create_backbone"]
