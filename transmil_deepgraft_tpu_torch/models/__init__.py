"""Model registry of the port (counterpart of ``models/__init__.py``).

The bag-level heads the configs train (TransMIL, TransformerMIL, AttMIL,
Chowder, RoFormerMIL, AttTrans/MonaiMILModel), the ResNet50 feature
extractor and its int8 post-training-quantized form."""

from __future__ import annotations

import inspect
from typing import Any

import torch

from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.models.attmil import AttMIL
from transmil_deepgraft_tpu_torch.models.chowder import Chowder
from transmil_deepgraft_tpu_torch.models.monai_mil import MonaiMIL
from transmil_deepgraft_tpu_torch.models.resnet import ResNet, resnet50, resnet50_baseline
from transmil_deepgraft_tpu_torch.models.resnet_int8 import (
    QResNet50,
    apply_qresnet50,
    build_qresnet50,
)
from transmil_deepgraft_tpu_torch.models.roformer_mil import RoFormerMIL
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
}
# the JAX package's other models, and the ROADMAP item that ports each: its
# other heads (A7) and the classic per-tile models it trains on tiles (A8)
NOT_PORTED = {"DTFD": "A7", "DTFDMIL": "A7", "CLAM_SB": "A7", "CLAM_MB": "A7", "CTMIL": "A7",
              "MDMIL": "A7", "DSMIL": "A7", "resnet50": "A7", "inception": "A8",
              "resnet18": "A8", "vit": "A8", "efficientnet": "A8"}


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
    if name in NOT_PORTED:
        raise KeyError(f"model '{name}' is not ported yet (ROADMAP {NOT_PORTED[name]}); the "
                       f"port has: {sorted(MODEL_REGISTRY)}")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(MODEL_REGISTRY)}")
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


__all__ = [
    "AttMIL", "Chowder", "MODEL_REGISTRY", "MonaiMIL", "QResNet50", "ResNet", "RoFormerMIL",
    "TransMIL", "TransMILAttention", "TransformerMIL", "apply_qresnet50", "build_qresnet50",
    "create_model", "resnet50", "resnet50_baseline",
]
