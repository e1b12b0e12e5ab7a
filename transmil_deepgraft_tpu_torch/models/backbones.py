"""Tile backbones and the image-bag MIL model (port of ``models/backbones.py``).

The reference's backbone selection (``code/models/model_interface.py:223-281``):
'features' (precomputed bags, no backbone), 'retccl' (RetCCL ResNet50 ->
2048-d), 'resnet50' (the CLAM baseline -> 1024-d), 'resnet18' (+ a Linear to
``out_features``), 'simple' (the Ilse CNN -> 1024-d), 'vit'/'dino' (ViT-B/16
-> 768-d, ``models/vit.py``), 'inception' (InceptionV3 -> 2048-d, the
classic zoo's, ``models/inception.py``) and 'efficientnet' (EfficientNet-B0
+ Linear(1280, ``out_features``) + GELU, ``models/efficientnet.py``). The
port adds 'uni2_h' (UNI2-h, ViT-H/14 with registers -> 1536-d,
``models/vit.uni2_h``), which neither the reference nor JAX has.

:class:`ImageMILModel` is the reference's ``ModelInterface.forward`` reshape
path (``model_interface.py:297-317``): the tiles of a batch of bags stream
through the frozen backbone in ``n_chunks`` sequential chunks (activation
memory is one chunk) into the bag head; with ``pyramid`` the ResNet's
per-stage features stream beside them (MONAI's ``att_trans_pyramid``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.models.efficientnet import efficientnet_b0
from transmil_deepgraft_tpu_torch.models.inception import inception_v3
from transmil_deepgraft_tpu_torch.models.resnet import (
    ResNet,
    resnet18,
    resnet50_baseline,
    retccl_resnet50,
)
from transmil_deepgraft_tpu_torch.models.vit import VisionTransformer, uni2_h, vit_base
from transmil_deepgraft_tpu_torch.utils.jax_params import backbone_state_dict_from_jax
from transmil_deepgraft_tpu_torch.utils.torch_weights import convert_timm_vit_state_dict

BACKBONE_DIMS = {
    "retccl": 2048,
    "resnet50": 1024,
    "resnet18": 512,
    "simple": 1024,
    "vit": 768,
    "dino": 768,
    "uni2_h": 1536,
    "efficientnet": 1280,
    "inception": 2048,
}


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
    resnet18 path: frozen conv stack, ``Linear(512, out_features)``; the
    efficientnet path adds the exact GELU, ``activation='gelu'``)."""

    def __init__(self, backbone: nn.Module, in_features: int, out_features: int,
                 activation: str = "none") -> None:
        super().__init__()
        self.backbone = backbone
        self.proj = nn.Linear(in_features, out_features)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.proj(self.backbone(x))
        return F.gelu(out) if self.activation == "gelu" else out


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
    if name in ("vit", "dino"):
        return vit_base(), 768
    if name == "uni2_h":
        return uni2_h(), 1536
    if name == "inception":  # the classic zoo's (ref model_interface_classic.py:198-204)
        return inception_v3(), 2048
    if name == "efficientnet":  # ref model_interface.py:260-267
        return ProjectedBackbone(efficientnet_b0(), 1280, out_features, activation="gelu"), \
            out_features
    raise KeyError(f"unknown backbone '{name}'")


def load_backbone_variables(backbone: nn.Module, variables: dict) -> None:
    """Load flax-layout ``{'params', 'batch_stats'}`` (``utils/torch_weights
    .convert_backbone_state_dict`` of a .pth, or JAX's variables) into a
    backbone: raw weights for a ``ProjectedBackbone`` go into its inner
    network and keep the projection; weights of stages the backbone does not
    have (a truncated ResNet) are ignored; a weight of another shape raises."""
    if isinstance(backbone, ProjectedBackbone) and "proj" not in variables["params"]:
        backbone = backbone.backbone
    own = backbone.state_dict()
    given = {k: v for k, v in backbone_state_dict_from_jax(variables).items() if k in own}
    misfit = [k for k, v in given.items() if v.shape != own[k].shape]
    if misfit:  # e.g. NVIDIA's widese EfficientNet into the standard B0 (ROADMAP C14)
        raise ValueError(f"the weights do not fit the backbone: {misfit[0]} is "
                         f"{tuple(given[misfit[0]].shape)}, the backbone's "
                         f"{tuple(own[misfit[0]].shape)} (ROADMAP C14 for efficientnet)")
    backbone.load_state_dict(given)


def uni2_h_from_timm(state_dict) -> VisionTransformer:
    """UNI2-h (``models/vit.uni2_h``, float32 on the CPU) with the weights of
    a timm-named state dict (MahmoodLab/UNI2-h's ``pytorch_model.bin``; not
    in the repository), converted by ``utils/torch_weights.
    convert_timm_vit_state_dict``, which raises on a missing or misshaped
    key."""
    model = uni2_h()
    load_backbone_variables(model, convert_timm_vit_state_dict(state_dict))
    return model


class ImageMILModel(nn.Module):
    """End-to-end image-bag MIL: tiles -> frozen backbone (chunked) -> bag head.

    Input (B, bag, H, W, 3) NHWC. The tiles run through the backbone in
    ``n_chunks`` sequential chunks (zero tiles pad the last so that the
    chunks are equal, as JAX's ``nn.scan`` needs), under ``no_grad`` (JAX's
    ``stop_gradient``). The backbone stays in eval mode whatever the mode of
    the model (flax's ``train=False``): its BatchNorm uses the running
    statistics and never updates them. With ``pyramid`` the backbone (a
    ResNet) also gives its stages' pooled features, chunk by chunk, and the
    head (MONAI's ``att_trans_pyramid``) takes them as ``pyramid``."""

    def __init__(self, backbone: nn.Module, head: nn.Module, n_chunks: int = 10,
                 pyramid: bool = False) -> None:
        super().__init__()
        self.backbone = backbone.eval()
        self.head = head
        self.n_chunks = n_chunks
        self.pyramid = pyramid

    def train(self, mode: bool = True) -> "ImageMILModel":
        super().train(mode)
        self.backbone.eval()
        return self

    def embed(self, x: torch.Tensor):
        """(B, bag, H, W, C) tiles -> (B, bag, D) features; with ``pyramid``
        (features, the tuple of the stages' (B, bag, D_s) features)."""
        b, bag = x.shape[:2]
        tiles = x.reshape(b * bag, *x.shape[2:])
        n_total = tiles.shape[0]
        chunks = max(1, min(self.n_chunks, n_total))
        pad = (-n_total) % chunks
        if pad:
            tiles = torch.cat([tiles, tiles.new_zeros((pad, *tiles.shape[1:]))])
        kwargs = {"return_pyramid": True} if self.pyramid else {}
        with torch.no_grad():
            outs = [self.backbone(c, **kwargs) for c in tiles.chunk(chunks)]

        def unchunk(parts: list[torch.Tensor]) -> torch.Tensor:
            return torch.cat(parts)[:n_total].reshape(b, bag, -1)

        if not self.pyramid:
            return unchunk(outs)
        return unchunk([o[0] for o in outs]), tuple(
            unchunk([o[1][s] for o in outs]) for s in range(len(outs[0][1])))

    def forward(self, x: torch.Tensor, **head_kwargs):
        if self.pyramid:
            feats, pyramid = self.embed(x)
            return self.head(feats, pyramid=pyramid, **head_kwargs)
        return self.head(self.embed(x), **head_kwargs)


__all__ = ["BACKBONE_DIMS", "ImageMILModel", "ProjectedBackbone", "ResNet", "SimpleCNN",
           "create_backbone", "load_backbone_variables", "uni2_h_from_timm"]
