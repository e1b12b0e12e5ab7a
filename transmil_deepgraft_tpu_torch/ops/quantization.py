"""Post-training int8 quantization primitives for frozen conv backbones (port of
``ops/quantization.py``).

Scheme (symmetric weights, zero-point-free):
  w_q[c]  = round(w[..., c] / s_w[c]),   s_w[c] = max|w[..., c]| / 127
  x_q     = round(x / s_x)               s_x calibrated (max|x| over batches)
  y_q     = clip(round(relu(y) / s_y) - 128, -128, 127)  for ReLU outputs

The build-time functions (``fold_bn``, ``quantize_weight``,
``zero_point_bias``) are numpy, copied as they are from the JAX package, so
they give the same bits. The run-time ones take torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_bn(
    kernel: np.ndarray,
    bn_scale: np.ndarray,
    bn_bias: np.ndarray,
    bn_mean: np.ndarray,
    bn_var: np.ndarray,
    eps: float = 1e-5,
) -> tuple[np.ndarray, np.ndarray]:
    """Fold eval-mode BatchNorm into the preceding conv: returns (kernel', bias')."""
    inv = bn_scale / np.sqrt(bn_var + eps)
    return kernel * inv, bn_bias - bn_mean * inv


def quantize_weight(kernel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: returns (w_q int8 HWIO, s_w (C_out,))."""
    absmax = np.max(np.abs(kernel), axis=tuple(range(kernel.ndim - 1)))
    s_w = np.maximum(absmax, 1e-12) / 127.0
    w_q = np.clip(np.round(kernel / s_w), -127, 127).astype(np.int8)
    return w_q, s_w.astype(np.float32)


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """float -> int8 with a per-tensor scale."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_act_relu(x: torch.Tensor, scale) -> torch.Tensor:
    """Asymmetric quantization for ReLU outputs (x >= 0) with a fixed zero
    point of -128: x in [0, 255*scale] maps onto the full int8 range. The
    zero-point correction folds into the conv bias (``zero_point_bias``)."""
    q = torch.round(x.float() / scale) - 128.0
    return torch.clamp(q, -128, 127).to(torch.int8)


def zero_point_bias(w_q: np.ndarray, in_scale: float, w_scale: np.ndarray) -> np.ndarray:
    """Bias correction for zero-point -128 inputs: +128 * s_x * s_w * colsum(w_q)."""
    colsum = w_q.astype(np.float64).sum(axis=tuple(range(w_q.ndim - 1)))
    return (128.0 * in_scale * w_scale.astype(np.float64) * colsum).astype(np.float32)
