"""Iterative Moore-Penrose pseudo-inverse (Newton-Schulz, order-3 variant).

Port of ``ops/pinv.py``: the Nystromformer paper's iteration

    Z_0   = A^T / (max_i sum_j |A_ij| * max_j sum_i |A_ij|)
    Z_t+1 = 1/4 * Z_t (13 I - A Z_t (15 I - A Z_t (7 I - A Z_t)))

The init divisor is ONE global max over every batch/head (a single scalar),
as in the reference dependency's ``torch.max`` over the whole tensor; it is
detached, as the JAX version stops its gradient.
"""

from __future__ import annotations

import torch


def newton_schulz_pinv(a: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Approximate pseudo-inverse of ``a`` (shape ``(..., m, m)``), in float32."""
    orig_dtype = a.dtype
    a32 = a.float()
    abs_a = a32.abs()
    denom = (abs_a.sum(dim=-1).max() * abs_a.sum(dim=-2).max()).detach()
    z = a32.transpose(-1, -2) / denom
    eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
    for _ in range(iters):
        az = a32 @ z
        inner = 7.0 * eye - az
        inner = 15.0 * eye - az @ inner
        inner = 13.0 * eye - az @ inner
        z = 0.25 * (z @ inner)
    return z.to(orig_dtype)
