"""ConvMixer: patch embed + depthwise/pointwise residual mixer (port of
``models/convmixer.py``).

The reference's teaching implementation (``code/models/ConvMixer.py:8-181``;
its drivers never use it), as the JAX module has it: a p x p, stride-p patch
embed with flax's 'SAME' padding, then ``depth`` x (depthwise conv -> exact
GELU -> BatchNorm, added to its input; pointwise conv -> GELU -> BatchNorm),
the spatial mean, a Linear classifier. Inputs are NHWC; the depthwise conv
is :func:`~transmil_deepgraft_tpu_torch.ops.depthwise.depthwise_conv2d`.
BatchNorm is :class:`~transmil_deepgraft_tpu_torch.models.resnet.BatchNorm2d`
with flax's default momentum (0.99), so train mode follows flax's rule.
Module names are the flax ones (``patch_embed``, ``patch_bn``, ``dw_<i>``,
``dw_bn_<i>``, ``pw_<i>``, ``pw_bn_<i>``, ``fc``), so
``utils/jax_params.backbone_state_dict_from_jax`` / ``variables_from_module``
carry the weights both ways.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.models.resnet import BatchNorm2d
from transmil_deepgraft_tpu_torch.ops.depthwise import depthwise_conv2d


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax's 'SAME' padding of a k-tap, stride-s conv along one axis."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class DepthwiseConv2d(nn.Conv2d):
    """A depthwise ``Conv2d`` (weight (C, 1, k, k), bias) whose forward takes
    and gives NCHW views of NHWC memory through ``depthwise_conv2d``."""

    def __init__(self, dim: int, kernel_size: int) -> None:
        super().__init__(dim, dim, kernel_size, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = depthwise_conv2d(x.permute(0, 2, 3, 1), self.weight.permute(2, 3, 1, 0))
        return out.permute(0, 3, 1, 2) + self.bias[:, None, None]


class ConvMixer(nn.Module):
    def __init__(self, dim: int = 256, depth: int = 8, kernel_size: int = 9,
                 patch_size: int = 7, n_classes: int = 2) -> None:
        super().__init__()
        self.depth, self.patch_size = depth, patch_size
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.patch_bn = BatchNorm2d(dim)
        for i in range(depth):
            self.add_module(f"dw_{i}", DepthwiseConv2d(dim, kernel_size))
            self.add_module(f"dw_bn_{i}", BatchNorm2d(dim))
            self.add_module(f"pw_{i}", nn.Conv2d(dim, dim, 1))
            self.add_module(f"pw_bn_{i}", BatchNorm2d(dim))
        self.fc = nn.Linear(dim, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, n_classes) logits."""
        p = self.patch_size
        h = x.permute(0, 3, 1, 2)
        (top, bottom), (left, right) = _same_pad(h.shape[2], p, p), _same_pad(h.shape[3], p, p)
        if top or bottom or left or right:
            h = F.pad(h, (left, right, top, bottom))
        h = self.patch_bn(F.gelu(self.patch_embed(h)))
        for i in range(self.depth):
            r = getattr(self, f"dw_{i}")(h)
            h = h + getattr(self, f"dw_bn_{i}")(F.gelu(r))
            h = getattr(self, f"pw_bn_{i}")(F.gelu(getattr(self, f"pw_{i}")(h)))
        return self.fc(h.mean(dim=(2, 3)))
