"""Depthwise SAME convolutions in the JAX package's layouts (port of
``ops/depthwise.py``, forward only).

The JAX module hand-writes the VJP to dodge an XLA sharding bug; torch
autograd has no such bug, so only the forward is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _same_pads(k: int) -> tuple[int, int]:
    lo = (k - 1) // 2
    return lo, k - 1 - lo


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), w (kh, kw, 1, C) -> (B, H, W, C), SAME, stride 1."""
    kh, kw, _, c = w.shape
    xt = F.pad(x.permute(0, 3, 1, 2), (*_same_pads(kw), *_same_pads(kh)))
    out = F.conv2d(xt, w.permute(3, 2, 0, 1), groups=c)
    return out.permute(0, 2, 3, 1)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), w (k, 1, C) -> (B, N, C), SAME, stride 1."""
    k, _, c = w.shape
    xt = F.pad(x.transpose(1, 2), _same_pads(k))
    return F.conv1d(xt, w.permute(2, 1, 0), groups=c).transpose(1, 2)
