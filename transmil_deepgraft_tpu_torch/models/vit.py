"""DINO-style Vision Transformer backbone (port of ``models/vit.py``).

The reference's vendored DINO ViT (``code/models/vision_transformer.py:
26-330``): a p x p conv patch embed, a cls token, learned position
embeddings (resized bicubically for another grid), pre-norm encoder blocks
with the exact (erf) GELU, and the cls token's features out. It is the
'dino'/'vit' backbone (``MyBackbone/backbone_factory.py:13-22`` loads
facebook/dino-vitb16; ``utils/torch_weights.convert_vit_state_dict`` reads
those names). Module names are the flax ones (``patch_embed``,
``block<i>.qkv``, ``norm``), so ``utils/jax_params`` carries the flax
variables one to one.

The blocks' attention is ``ops/attention.softmax_attention`` (SDPA on the
card, its explicit formula on the CPU or under ``plain_route()``);
:meth:`VisionTransformer.get_last_selfattention` computes the last block's
probabilities with the explicit softmax, which SDPA does not give.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.ops.attention import softmax_attention

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


def _trunc_normal(*shape: int) -> nn.Parameter:
    """flax ``truncated_normal(0.02)``: N(0, 0.02) cut at two deviations,
    rescaled to keep the deviation."""
    std = 0.02 / 0.87962566103423978
    return nn.Parameter(nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def _qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, n, dim = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, self.heads, dim // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each (b, heads, n, dh)
        return q, k, v

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        """The (b, heads, n, n) attention probabilities, explicitly."""
        q, k, _ = self._qkv(x)
        return torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape
        q, k, v = self._qkv(x)
        out = softmax_attention(q, k, v, q.shape[-1] ** -0.5)
        x = x + self.proj(out.transpose(1, 2).reshape(b, n, dim))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


def _interpolate_pos_embed(pos_patches: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1, side^2, dim) -> (1, gh * gw, dim): the grid resized bicubically
    as ``jax.image.resize`` does, which (antialiased when it shrinks) is
    ``F.interpolate(..., antialias=True)``; the same grid passes as it is."""
    _, n, dim = pos_patches.shape
    side = int(round(n ** 0.5))
    if side * side == gh * gw and side == gh:
        return pos_patches
    grid = pos_patches.reshape(1, side, side, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False,
                         antialias=True)
    return grid.permute(0, 2, 3, 1).reshape(1, gh * gw, dim)


def _same_pad(size: int, p: int) -> tuple[int, int]:
    """flax's 'SAME' padding of a p x p, stride-p conv along one axis."""
    total = max((math.ceil(size / p) - 1) * p + p - size, 0)
    return total // 2, total - total // 2


class VisionTransformer(nn.Module):
    """(B, H, W, 3) NHWC -> (B, dim) cls features (or logits with
    ``num_classes``). ``img_size`` sets the position grid; inputs of
    another size resize it."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12, heads: int = 12,
                 mlp_ratio: float = 4.0, num_classes: int = 0, img_size: int = 224) -> None:
        super().__init__()
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = _trunc_normal(1, 1, dim)
        self.pos_embed = _trunc_normal(1, (img_size // patch_size) ** 2 + 1, dim)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, heads, mlp_ratio))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.num_classes = num_classes
        if num_classes:
            self.head = nn.Linear(dim, num_classes)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The patch tokens with their position embeddings, after the cls
        token: (B, 1 + gh * gw, dim)."""
        p = self.patch_size
        x = x.permute(0, 3, 1, 2)
        (t, bot), (left, right) = _same_pad(x.shape[2], p), _same_pad(x.shape[3], p)
        if t or bot or left or right:
            x = F.pad(x, (left, right, t, bot))
        feat = self.patch_embed(x)
        b, _, gh, gw = feat.shape
        feat = feat.flatten(2).transpose(1, 2)
        feat = feat + _interpolate_pos_embed(self.pos_embed[:, 1:], gh, gw)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, 1, self.dim)
        return torch.cat([cls, feat], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.tokens(x)
        for i in range(self.depth):
            feat = getattr(self, f"block{i}")(feat)
        cls_out = self.norm(feat)[:, 0]
        return self.head(cls_out) if self.num_classes else cls_out

    def get_last_selfattention(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's (B, heads, n, n) attention probabilities (ref
        ``vision_transformer.py``'s DINO visualization getter)."""
        feat = self.tokens(x)
        for i in range(self.depth - 1):
            feat = getattr(self, f"block{i}")(feat)
        return getattr(self, f"block{self.depth - 1}").attention(feat)


def vit_tiny(**kw) -> VisionTransformer:
    return VisionTransformer(**{"dim": 192, "depth": 12, "heads": 3, **kw})


def vit_small(**kw) -> VisionTransformer:
    return VisionTransformer(**{"dim": 384, "depth": 12, "heads": 6, **kw})


def vit_base(**kw) -> VisionTransformer:
    return VisionTransformer(**{"dim": 768, "depth": 12, "heads": 12, **kw})
