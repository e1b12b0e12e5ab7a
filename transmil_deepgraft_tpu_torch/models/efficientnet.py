"""EfficientNet-B0 backbone (port of ``models/efficientnet.py``): the
reference's 'efficientnet' backbone, loaded there from NVIDIA torchhub's
``nvidia_efficientnet_widese_b0`` and capped with Linear(1280, out) + GELU
(ref ``model_interface.py:260-267``; the cap is ``models/backbones
.ProjectedBackbone``).

The standard B0 topology: a stride-2 conv32 stem, the MBConv stages
(e1 k3 s1 c16 x1, e6 k3 s2 c24 x2, e6 k5 s2 c40 x2, e6 k3 s2 c80 x3,
e6 k5 s1 c112 x3, e6 k5 s2 c192 x4, e6 k3 s1 c320 x1), a 1x1 conv to 1280
and the global pool. SiLU, squeeze-excite at a quarter of the block's input
width (of its expanded width with ``widese``, NVIDIA's variant), BatchNorm
with eps 1e-3 and flax's momentum 0.9 (:class:`~transmil_deepgraft_tpu_torch
.models.resnet.BatchNorm2d`). Every convolution pads ``k // 2`` on each
side, as the JAX module does (not TF's asymmetric 'SAME'); the depthwise
ones are ``nn.Conv2d(groups=channels)``. Module names are the flax ones
(``stem_conv``, ``stage<s>_block<b>.dw_conv``, ``.se.reduce``, ...)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.models.resnet import BatchNorm2d

# (expand, kernel, stride, channels, repeats)
B0_STAGES: tuple[tuple[int, int, int, int, int], ...] = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, momentum=0.9, eps=1e-3)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, groups=groups,
                     bias=bias)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int) -> None:
        super().__init__()
        self.reduce = _conv(channels, reduced, 1, bias=True)
        self.expand = _conv(reduced, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.expand(F.silu(self.reduce(s))))


class MBConv(nn.Module):
    def __init__(self, in_ch: int, expand: int, kernel: int, stride: int, out_ch: int,
                 se_ratio: float = 0.25, widese: bool = False) -> None:
        super().__init__()
        mid = in_ch * expand
        self.expand = expand
        if expand != 1:
            self.expand_conv, self.expand_bn = _conv(in_ch, mid, 1), _bn(mid)
        self.dw_conv, self.dw_bn = _conv(mid, mid, kernel, stride, groups=mid), _bn(mid)
        self.se = SqueezeExcite(mid, max(1, int((mid if widese else in_ch) * se_ratio)))
        self.project_conv, self.project_bn = _conv(mid, out_ch, 1), _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = F.silu(self.expand_bn(self.expand_conv(h)))
        h = self.se(F.silu(self.dw_bn(self.dw_conv(h))))
        h = self.project_bn(self.project_conv(h))
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """(B, H, W, 3) NHWC -> (B, head_ch) pooled features (logits with
    ``num_classes``)."""

    def __init__(self, stages: Sequence[tuple[int, int, int, int, int]] = B0_STAGES,
                 head_ch: int = 1280, num_classes: int = 0, widese: bool = False) -> None:
        super().__init__()
        self.stem_conv, self.stem_bn = _conv(3, 32, 3, 2), _bn(32)
        self.block_names: list[str] = []
        ch = 32
        for si, (e, k, s, c, r) in enumerate(stages):
            for b in range(r):
                name = f"stage{si}_block{b}"
                self.add_module(name, MBConv(ch, e, k, s if b == 0 else 1, c, widese=widese))
                self.block_names.append(name)
                ch = c
        self.head_conv, self.head_bn = _conv(ch, head_ch, 1), _bn(head_ch)
        self.num_classes = num_classes
        if num_classes:
            self.classifier = nn.Linear(head_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2))))
        for name in self.block_names:
            h = getattr(self, name)(h)
        h = F.silu(self.head_bn(self.head_conv(h))).mean(dim=(2, 3))
        return self.classifier(h) if self.num_classes else h


def efficientnet_b0(**kw) -> EfficientNet:
    return EfficientNet(**kw)
