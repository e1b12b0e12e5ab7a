"""Model registry of the port (counterpart of ``models/__init__.py``).

The port has the TransMIL head (in the registry), the ResNet50 feature
extractor and its int8 post-training-quantized form."""

from __future__ import annotations

from typing import Any

import torch

from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.models.resnet import ResNet, resnet50, resnet50_baseline
from transmil_deepgraft_tpu_torch.models.resnet_int8 import (
    QResNet50,
    apply_qresnet50,
    build_qresnet50,
)
from transmil_deepgraft_tpu_torch.models.transmil import TransMIL, TransMILAttention

MODEL_REGISTRY = {"TransMIL": TransMIL}


def create_model(name: str, n_classes: int, in_features: int = 2048,
                 out_features: int = 512, device: str | torch.device | None = None,
                 use_pallas: bool | None = None, precision: int | str | None = None,
                 **kwargs: Any) -> TransMIL:
    """Instantiate a MIL head by config name on ``device`` (None = CUDA).
    ``use_pallas=True`` routes the TransLayers' attention (training included)
    through the fused Nystrom landmark kernels, as the JAX flag does;
    ``precision`` 16, '16', 'bf16' or '16-mixed' (``cfg.General.precision``)
    makes a bfloat16-compute TransMIL with float32 parameters."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; the port has: {sorted(MODEL_REGISTRY)} "
                       "(the other heads are ROADMAP A7)")
    dev = resolve_device(device)
    if precision in (16, "16", "bf16", "16-mixed"):
        kwargs["dtype"] = torch.bfloat16
    model = MODEL_REGISTRY[name](n_classes=n_classes, in_features=in_features,
                                 out_features=out_features, use_pallas=use_pallas, **kwargs)
    return model.to(dev)


__all__ = [
    "MODEL_REGISTRY", "QResNet50", "ResNet", "TransMIL", "TransMILAttention",
    "apply_qresnet50", "build_qresnet50", "create_model", "resnet50", "resnet50_baseline",
]
