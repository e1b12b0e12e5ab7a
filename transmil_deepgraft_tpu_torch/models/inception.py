"""InceptionV3 (port of ``models/inception.py``): the classic zoo's
'inception' tile classifier.

The reference loads torchvision's ``inception_v3`` for its classic per-tile
pipeline (ref ``code/models/model_interface_classic.py:198-204``, tiles
resized to 299). The modules and branches have torchvision's names
(``Mixed_5b.branch1x1.conv``), so ``utils/torch_weights
.convert_inception_state_dict`` is a name and transpose mapping. Each conv is
bias-free with BatchNorm (eps 1e-3, flax's momentum 0.9) and ReLU. The 3x3
average pools divide by 9 with the zero pad counted (torchvision's
``avg_pool2d(3, 1, 1)``, ``count_include_pad=True``), the 3x3 stride-2 max
pools are unpadded. Takes (B, 299, 299, 3) NHWC tiles (75 px is the least
its strides allow); feature mode (``num_classes=0``) gives the 2048-d pooled
features. The training-time auxiliary classifier is left out, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.models.resnet import BatchNorm2d


class BasicConv2d(nn.Module):
    """Bias-free conv + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm2d(cout, momentum=0.9, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], dim=1)


def transform_input(x: torch.Tensor) -> torch.Tensor:
    """torchvision's legacy ``_transform_input`` on NHWC tiles: ImageNet-
    normalized channels re-mapped to the normalization to [-1, 1] that the
    TF-slim weights expect."""
    ch = [x[..., i:i + 1] * (s / 0.5) + (m - 0.5) / 0.5
          for i, (m, s) in enumerate(((0.485, 0.229), (0.456, 0.224), (0.406, 0.225)))]
    return torch.cat(ch, dim=-1)


class InceptionV3(nn.Module):
    """(B, 299, 299, 3) NHWC -> (B, 2048) features (logits with
    ``num_classes``)."""

    def __init__(self, num_classes: int = 0, transform_input: bool = False) -> None:
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        for i, c7 in zip("bcde", (128, 160, 160, 192)):
            self.add_module(f"Mixed_6{i}", InceptionC(768, c7))
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.num_classes = num_classes
        if num_classes:
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform_input:
            x = transform_input(x)
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3s2(x)))
        x = _maxpool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.fc(x) if self.num_classes else x


def inception_v3(num_classes: int = 0, **kwargs) -> InceptionV3:
    return InceptionV3(num_classes=num_classes, **kwargs)
