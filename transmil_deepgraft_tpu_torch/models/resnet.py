"""The ResNet family (port of ``models/resnet.py``).

The RetCCL ResNet50 (2048-d pooled features, ``retccl_resnet50``), the CLAM
baseline truncated after layer3 (1024-d), ResNet18 (512-d, the
``resnet18`` backbone of ``models/backbones``), ResNet34, and with
``in_channels`` the spatial ResNet50 MIL head's trunk
(``models/spatial_resnet.py``). The reference's extensions are there as in
JAX (ref ``ResNet.py:119-245``): a classifier (``num_classes``, a Linear or
the ``NormedLinear`` cosine classifier), the ``mlp`` and ``two_branch``
instance/group heads, the sigmoid spatial ``attention`` branch after
layer4, and the forward's ``return_pyramid`` (the per-stage pooled
features, for MONAI's ``att_trans_pyramid``) and ``return_spatial`` (the
last stage's map, the GradCAM target). BatchNorm
is :class:`BatchNorm2d`: the running statistics in eval mode, flax's
train-mode rule otherwise. Inputs are NHWC, as in the JAX package; the
convolutions run in NCHW (a channels-last view of the same memory). Module
names follow the flax module names (``conv1``, ``bn1``, ``layer1_0.conv1``,
``layer2_0.downsample_conv``, ...), so
:func:`~transmil_deepgraft_tpu_torch.utils.jax_params.resnet_state_dict_from_jax`
maps the flax variables one to one.

The slide pipeline uses the ResNet50 for its bf16 route (``calib_tiles=None``),
feature extraction for its float32 route, and the int8 backbone is held to
it as the float yardstick.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


# the process group train-mode BatchNorm reduces its batch moments over, or None
_BATCH_STATS_GROUP: list = [None]


@contextlib.contextmanager
def batch_stats_reduced_over(group):
    """Inside, every train-mode :class:`BatchNorm2d` normalises with the
    moments of the whole data-parallel batch: sum x and sum x^2 are
    ``all_reduce``d over ``group`` (differentiably), so dp training equals
    one-process training. None leaves them per process."""
    prev = _BATCH_STATS_GROUP[0]
    _BATCH_STATS_GROUP[0] = group
    try:
        yield
    finally:
        _BATCH_STATS_GROUP[0] = prev


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``nn.BatchNorm``'s train-mode semantics,
    written as flax computes them: the batch's mean and its variance
    ``max(0, E[x^2] - E[x]^2)`` normalize, ``y = (x - mean) * (rsqrt(var +
    eps) * scale) + bias``, and the running statistics move by ``ra =
    momentum * ra + (1 - momentum) * batch``, the variance biased too
    (torch's own rule keeps the unbiased one and calls ``1 - momentum`` its
    momentum). ``momentum`` is flax's: 0.99 its default, 0.9 in the ResNets.
    Eval mode uses the running statistics."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = BN_EPS) -> None:
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = _BATCH_STATS_GROUP[0]
        if group is None:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        else:  # the global batch's moments: sum x and sum x^2 over the group
            from torch.distributed.nn.functional import all_reduce

            count = x.numel() // x.shape[1] * dist.get_world_size(group)
            sums = all_reduce(torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]),
                              group=group)
            mean = sums[0] / count
            var = (sums[1] / count - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        return y


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, momentum=0.9)


class NormedLinear(nn.Module):
    """Cosine classifier ``normalize(x) @ normalize(W, axis=0)`` (ref
    ``ResNet.py:119-128``); ``weight`` is (in, out), as in the reference and
    flax. Initialized U[0, 2), flax's ``uniform(scale=2.0)``."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.rand(in_features, out_features) * 2.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
        wn = self.weight / (self.weight.norm(dim=0, keepdim=True) + 1e-12)
        return xn @ wn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False) -> None:
        super().__init__()
        self.conv1, self.bn1 = _conv(in_planes, planes, 3, stride), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _bn(planes)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(in_planes, planes, 1, stride)
            self.downsample_bn = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


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


class AttentionBranch(nn.Module):
    """The sigmoid spatial attention after layer4 (ref ``ResNet.py:236-245``):
    ``n_blocks`` blocks at stride 1, then 1x1 convs to a one-channel map."""

    def __init__(self, block: type, in_planes: int, planes: int = 512, n_blocks: int = 3) -> None:
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"block{i}", block(in_planes, planes))
        self.att_conv1, self.att_bn1 = _conv(in_planes, 128, 1), _bn(128)
        self.att_conv2, self.att_bn2 = _conv(128, 1, 1), _bn(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i in range(self.n_blocks):
            out = getattr(self, f"block{i}")(out)
        out = F.relu(self.att_bn1(self.att_conv1(out)))
        return torch.sigmoid(self.att_bn2(self.att_conv2(out)))


class ResNet(nn.Module):
    """NHWC ResNet: (B, H, W, in_channels) -> (B, C) pooled features, or
    logits with ``num_classes`` (feature mode, fc = Identity, at 0). JAX's
    ``attention_layers`` is not here: JAX never reads it (the branch always
    has 3 blocks)."""

    def __init__(self, block: type = Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 truncate_after: int = 4, in_channels: int = 3, *, num_classes: int = 0,
                 normlinear: bool = False, two_branch: bool = False, mlp: bool = False,
                 attention: bool = False) -> None:
        super().__init__()
        self.truncate_after = truncate_after
        self.num_classes, self.two_branch, self.mlp = num_classes, two_branch, mlp
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.stages: list[list[str]] = []  # the block names of each stage
        in_planes = 64
        for stage in range(truncate_after):
            planes, stride = (64, 128, 256, 512)[stage], (1, 2, 2, 2)[stage]
            self.stages.append([])
            for b in range(layers[stage]):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or in_planes != planes * block.expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(in_planes, planes, s, ds))
                self.stages[-1].append(name)
                in_planes = planes * block.expansion
        self.feature_dim = in_planes
        self.attention = attention and truncate_after == 4
        if self.attention:
            self.att_branch = AttentionBranch(block, in_planes)
        if not num_classes:
            return

        def linear(name: str, cin: int) -> None:
            self.add_module(name, NormedLinear(cin, num_classes) if normlinear
                            else nn.Linear(cin, num_classes))

        if mlp:
            self.fc_mlp0 = nn.Linear(in_planes, 2048)
            linear("instDis", 2048)
        else:
            linear("fc", in_planes)
        if two_branch:
            linear("groupDis", 2048 if mlp else in_planes)

    def forward(self, x: torch.Tensor, return_pyramid: bool = False,
                return_spatial: bool = False):
        """(B, H, W, C) NHWC -> (B, D) pooled features or logits (a pair of
        them with ``two_branch``). ``return_pyramid`` also gives the tuple of
        the stages' pooled features (pooled, pyramid); ``return_spatial``
        gives the last stage's (B, h, w, C) map before the pool instead."""
        out = x.permute(0, 3, 1, 2)  # NHWC memory seen as channels-last NCHW
        out = F.relu(self.bn1(self.conv1(out)))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        pyramid = []
        for names in self.stages:
            for name in names:
                out = getattr(self, name)(out)
            if return_pyramid:
                pyramid.append(out.mean(dim=(2, 3)))
        if self.attention:
            out = out + self.att_branch(out) * out
        if return_spatial:
            return out.permute(0, 2, 3, 1)
        out = out.mean(dim=(2, 3))
        if return_pyramid:
            return out, tuple(pyramid)
        if not self.num_classes:
            return out
        if self.mlp:
            out = F.relu(self.fc_mlp0(out))
            x1 = self.instDis(out)
        else:
            x1 = self.fc(out)
        return (x1, self.groupDis(out)) if self.two_branch else x1


def resnet18(**kwargs) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kwargs)


def resnet34(**kwargs) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kwargs)


def resnet50(truncate_after: int = 4, **kwargs) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), truncate_after=truncate_after, **kwargs)


def retccl_resnet50() -> ResNet:
    """The RetCCL feature extractor: ResNet50 in feature mode (2048-d); its
    trained weights convert from ``retccl_best_ckpt.pth``."""
    return resnet50()


def resnet50_baseline() -> ResNet:
    """CLAM baseline: ResNet50 truncated after layer3, avg-pooled -> 1024-d."""
    return ResNet(Bottleneck, (3, 4, 6, 3), truncate_after=3)
