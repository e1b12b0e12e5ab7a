"""Model registry of the port (counterpart of ``models/__init__.py``).

Every bag-level head of the JAX zoo (TransMIL, TransformerMIL, AttMIL,
Chowder, RoFormerMIL, AttTrans/MonaiMILModel, CLAM_SB/MB, DTFD, MDMIL, DSMIL)
and the two heads over spatial feature volumes (CTMIL, ``resnet50``), the
tile backbones (``models/backbones``: RetCCL ResNet50, the CLAM baseline,
ResNet18, the simple CNN, ViT-B/16 (vit/dino), EfficientNet-B0, InceptionV3)
with ``ImageMILModel``, which puts one in front of a head, the classic
per-tile classifiers (:func:`create_classic_model`) and the ResNet50's int8
post-training-quantized form."""

from __future__ import annotations

import inspect
from typing import Any

import torch

from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.models.attmil import AttMIL
from transmil_deepgraft_tpu_torch.models.backbones import ImageMILModel, create_backbone
from transmil_deepgraft_tpu_torch.models.chowder import Chowder
from transmil_deepgraft_tpu_torch.models.classic import ClassicTileClassifier, classic_model
from transmil_deepgraft_tpu_torch.models.clam import CLAM_MB, CLAM_SB
from transmil_deepgraft_tpu_torch.models.ctmil import CTMIL
from transmil_deepgraft_tpu_torch.models.dsmil import DSMIL
from transmil_deepgraft_tpu_torch.models.dtfd import DTFDMIL
from transmil_deepgraft_tpu_torch.models.mdmil import MDMIL
from transmil_deepgraft_tpu_torch.models.monai_mil import MonaiMIL
from transmil_deepgraft_tpu_torch.models.resnet import ResNet, resnet50, resnet50_baseline
from transmil_deepgraft_tpu_torch.models.resnet_int8 import (
    QResNet50,
    apply_qresnet50,
    build_qresnet50,
)
from transmil_deepgraft_tpu_torch.models.roformer_mil import RoFormerMIL
from transmil_deepgraft_tpu_torch.models.spatial_resnet import SpatialResNetMIL
from transmil_deepgraft_tpu_torch.models.transformer_mil import TransformerMIL
from transmil_deepgraft_tpu_torch.models.transmil import TransMIL, TransMILAttention

MODEL_REGISTRY: dict[str, type[torch.nn.Module]] = {
    "TransMIL": TransMIL,
    "AttMIL": AttMIL,
    "TransformerMIL": TransformerMIL,
    "Chowder": Chowder,
    "MonaiMILModel": MonaiMIL,
    "AttTrans": MonaiMIL,
    "RoFormerMIL": RoFormerMIL,
    "CLAM_SB": CLAM_SB,
    "CLAM_MB": CLAM_MB,
    "DTFD": DTFDMIL,
    "DTFDMIL": DTFDMIL,
    "MDMIL": MDMIL,
    "DSMIL": DSMIL,
    "CTMIL": CTMIL,
    "resnet50": SpatialResNetMIL,
}
# the heads over (B, H, W, D) spatial feature volumes, not bags of tiles
SPATIAL_HEADS = ("CTMIL", "resnet50")
# the classic per-tile models' names, which configs put in Model.name and
# which no registry of either package holds (ROADMAP C13)
CLASSIC_NAMES = ("inception", "resnet18", "vit", "efficientnet")


def create_classic_model(backbone_name: str, n_classes: int,
                         device: str | torch.device | None = None) -> ClassicTileClassifier:
    """The per-tile classifier of the classic pipeline (ref
    ModelInterface_Classic) over ``backbone_name``, on ``device`` (None =
    CUDA)."""
    return classic_model(backbone_name, n_classes).to(resolve_device(device))


def create_model(name: str, n_classes: int, in_features: int = 2048,
                 out_features: int = 512, device: str | torch.device | None = None,
                 use_pallas: bool | None = None, precision: int | str | None = None,
                 **kwargs: Any) -> torch.nn.Module:
    """Instantiate a MIL head by config name (``cfg.Model.name``) on
    ``device`` (None = CUDA), with the JAX package's rules: ``out_features``
    goes to the heads that take it, ``kwargs`` are the head's own knobs.

    ``use_pallas=True`` (TransMIL) routes the TransLayers' attention, training
    included, through the fused Nystrom landmark kernels, as the JAX flag does.
    ``precision`` 16, '16', 'bf16' or '16-mixed' (``cfg.General.precision``)
    makes a bfloat16-compute TransMIL with float32 parameters; as in JAX it
    applies to TransMIL alone, and the other heads (the AttMIL and
    TransformerMIL configs ask for 16) compute in float32."""
    if name not in MODEL_REGISTRY:
        # JAX's KeyError; the classic models' names fail so too (ROADMAP C13)
        classic = (" (a classic per-tile model: train it with Data.variant 'tiles', its "
                   "network in Model.backbone and a bag head in Model.name; ROADMAP C13)"
                   if name in CLASSIC_NAMES else "")
        raise KeyError(f"unknown model '{name}'; available: {sorted(MODEL_REGISTRY)}{classic}")
    dev = resolve_device(device)
    common: dict[str, Any] = {"n_classes": n_classes, "in_features": in_features}
    if "out_features" in inspect.signature(MODEL_REGISTRY[name]).parameters:
        common["out_features"] = out_features
    if name == "TransMIL":
        common["use_pallas"] = use_pallas
        if precision in (16, "16", "bf16", "16-mixed"):
            common["dtype"] = torch.bfloat16
    elif use_pallas:
        raise ValueError(f"use_pallas is TransMIL's; {name} has no Pallas path")
    return MODEL_REGISTRY[name](**common, **kwargs).to(dev)


def head_logits(model: torch.nn.Module, *args: Any) -> torch.Tensor:
    """A head's logits on ``args`` (JAX ``serving._eval_forward``): DTFD's
    slide prediction; MDMIL asked for no attention row (its default), so
    its TransLayers run fused at inference; the others' forward as it is.
    An ``ImageMILModel`` answers as its bag head."""
    head = model.head if isinstance(model, ImageMILModel) else model
    if isinstance(head, MDMIL):
        return model(*args, return_attn=False)
    out = model(*args)
    return out[1] if isinstance(head, DTFDMIL) else out


__all__ = [
    "AttMIL", "CLAM_MB", "CLAM_SB", "CLASSIC_NAMES", "CTMIL", "Chowder", "ClassicTileClassifier",
    "DSMIL", "DTFDMIL", "ImageMILModel", "MDMIL", "MODEL_REGISTRY", "MonaiMIL", "QResNet50",
    "ResNet", "RoFormerMIL", "SPATIAL_HEADS", "SpatialResNetMIL", "TransMIL", "TransMILAttention",
    "TransformerMIL", "apply_qresnet50", "build_qresnet50", "create_backbone",
    "create_classic_model", "create_model", "head_logits", "resnet50", "resnet50_baseline",
]
