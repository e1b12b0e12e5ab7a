"""ResNet50 in feature mode (port of ``models/resnet.py``).

The RetCCL ResNet50 (2048-d pooled features) and the CLAM baseline truncated
after layer3 (1024-d). Eval-mode BatchNorm with running statistics. Inputs are
NHWC, as in the JAX package; the convolutions run in NCHW (a channels-last
view of the same memory). Module names follow the flax module names
(``conv1``, ``bn1``, ``layer1_0.conv1``, ``layer2_0.downsample_conv``, ...),
so :func:`~transmil_deepgraft_tpu_torch.utils.jax_params.resnet_state_dict_from_jax`
maps the flax variables one to one.

The slide pipeline uses it for its bf16 route (``calib_tiles=None``), and the
int8 backbone is held to it as the float yardstick.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False) -> None:
        super().__init__()
        out = planes * self.expansion
        self.conv1, self.bn1 = _conv(in_planes, planes, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), _bn(out)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(in_planes, out, 1, stride)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """NHWC ResNet in feature mode: (B, H, W, 3) -> (B, C) pooled features."""

    def __init__(self, block: type = Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 truncate_after: int = 4) -> None:
        super().__init__()
        self.truncate_after = truncate_after
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.block_names: list[str] = []
        in_planes = 64
        for stage in range(truncate_after):
            planes, stride = (64, 128, 256, 512)[stage], (1, 2, 2, 2)[stage]
            for b in range(layers[stage]):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or in_planes != planes * block.expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(in_planes, planes, s, ds))
                self.block_names.append(name)
                in_planes = planes * block.expansion
        self.feature_dim = in_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.permute(0, 3, 1, 2)  # NHWC memory seen as channels-last NCHW
        out = F.relu(self.bn1(self.conv1(out)))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        for name in self.block_names:
            out = getattr(self, name)(out)
        return out.mean(dim=(2, 3))


def resnet50(truncate_after: int = 4) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), truncate_after=truncate_after)


def resnet50_baseline() -> ResNet:
    """CLAM baseline: ResNet50 truncated after layer3, avg-pooled -> 1024-d."""
    return ResNet(Bottleneck, (3, 4, 6, 3), truncate_after=3)
