"""Model registry of the port (counterpart of ``models/__init__.py``).

This slice ports the TransMIL head only."""

from __future__ import annotations

from typing import Any

import torch

from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.models.transmil import TransMIL, TransMILAttention

MODEL_REGISTRY = {"TransMIL": TransMIL}


def create_model(name: str, n_classes: int, in_features: int = 2048,
                 out_features: int = 512, device: str | torch.device | None = None,
                 **kwargs: Any) -> TransMIL:
    """Instantiate a MIL head by config name on ``device`` (None = CUDA)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; the port has: {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    model = MODEL_REGISTRY[name](n_classes=n_classes, in_features=in_features,
                                 out_features=out_features, **kwargs)
    return model.to(dev)


__all__ = ["MODEL_REGISTRY", "TransMIL", "TransMILAttention", "create_model"]
