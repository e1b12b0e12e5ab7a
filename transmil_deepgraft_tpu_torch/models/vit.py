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

Options, each off by default (the DINO ViT), give timm's newer layouts:
register tokens (``reg_tokens``: learned tokens after the cls token, before
the patches), a position embedding over the patch tokens only
(``no_embed_class``), LayerScale (``init_values``: a per-channel gain
``ls{1,2}.gamma`` on each branch before its residual add) and the packed
SwiGLU MLP (``mlp_layer="swiglu_packed"``: ``fc1`` to ``hidden``, then
``SiLU(first half) * second half``, ``fc2`` from ``hidden / 2``; timm's
``GluMlp(gate_last=False)``). :func:`uni2_h` is UNI2-h (Chen et al., Nature
Medicine 2024; the MahmoodLab/UNI2-h model card's ``timm_kwargs``).

Precision: float32 throughout unless :meth:`VisionTransformer.cast_matmuls`
puts the patch embed's and every Linear's weights in bf16. Then those
layers and the attention run in bf16, and the residual stream, every
LayerNorm, the LayerScale products and the output stay float32: the
numerics of timm's model under ``torch.autocast("cuda", torch.bfloat16)``.

The blocks' float32 attention is ``ops/attention.softmax_attention`` (SDPA
on the card, its explicit formula on the CPU or under ``plain_route()``);
bf16 attention is SDPA (FlashAttention on the card).
:meth:`VisionTransformer.get_last_selfattention` computes the last block's
probabilities with the explicit softmax, which SDPA does not give.

Spans (``utils/profiling``): ``backbone.vit`` a forward, ``vit.attn`` and
``vit.mlp`` each block's two residual branches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.ops.attention import softmax_attention
from transmil_deepgraft_tpu_torch.utils.profiling import span

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


def _trunc_normal(*shape: int) -> nn.Parameter:
    """flax ``truncated_normal(0.02)``: N(0, 0.02) cut at two deviations,
    rescaled to keep the deviation."""
    std = 0.02 / 0.87962566103423978
    return nn.Parameter(nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std))


class LayerScale(nn.Module):
    """timm's LayerScale: ``x * gamma``, ``gamma`` of shape (dim,). A bf16
    ``x`` times the float32 ``gamma`` is float32."""

    def __init__(self, dim: int, init_values: float) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


MLP_LAYERS = ("gelu", "swiglu_packed")


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 init_values: float | None = None, mlp_layer: str = "gelu") -> None:
        super().__init__()
        if mlp_layer not in MLP_LAYERS:
            raise ValueError(f"mlp_layer must be one of {MLP_LAYERS}, got {mlp_layer!r}")
        self.heads = heads
        self.mlp_layer = mlp_layer
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden // 2 if mlp_layer == "swiglu_packed" else hidden, dim)
        self.ls1 = self.ls2 = None
        if init_values is not None:
            self.ls1, self.ls2 = LayerScale(dim, init_values), LayerScale(dim, init_values)

    def _qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, n, dim = x.shape
        h = self.norm1(x).to(self.qkv.weight.dtype)
        qkv = self.qkv(h).reshape(b, n, 3, self.heads, dim // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each (b, heads, n, dh)
        return q, k, v

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        """The (b, heads, n, n) attention probabilities, explicitly."""
        q, k, _ = self._qkv(x)
        return torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)

    def _attn(self, x: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape
        q, k, v = self._qkv(x)
        scale = q.shape[-1] ** -0.5
        if q.dtype == torch.float32:
            out = softmax_attention(q, k, v, scale)
        else:
            out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        out = self.proj(out.transpose(1, 2).reshape(b, n, dim))
        return out if self.ls1 is None else self.ls1(out)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(self.norm2(x).to(self.fc1.weight.dtype))
        if self.mlp_layer == "swiglu_packed":
            gate, value = h.chunk(2, dim=-1)  # the gate is fc1's first half
            h = F.silu(gate) * value
        else:
            h = F.gelu(h)
        out = self.fc2(h)
        return out if self.ls2 is None else self.ls2(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vit.attn"):
            x = x + self._attn(x)
        with span("vit.mlp"):
            return x + self._mlp(x)


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
    another size resize it. ``reg_tokens``, ``no_embed_class``,
    ``init_values`` and ``mlp_layer`` as the module's docstring says;
    register tokens come with ``no_embed_class`` (timm's other layout gives
    them position embeddings, which this module does not)."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12, heads: int = 12,
                 mlp_ratio: float = 4.0, num_classes: int = 0, img_size: int = 224,
                 reg_tokens: int = 0, no_embed_class: bool = False,
                 init_values: float | None = None, mlp_layer: str = "gelu") -> None:
        super().__init__()
        if reg_tokens and not no_embed_class:
            raise ValueError("register tokens need no_embed_class=True")
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.no_embed_class = no_embed_class
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = _trunc_normal(1, 1, dim)
        self.reg_token = _trunc_normal(1, reg_tokens, dim) if reg_tokens else None
        grid = (img_size // patch_size) ** 2
        self.pos_embed = _trunc_normal(1, grid if no_embed_class else grid + 1, dim)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, heads, mlp_ratio, init_values, mlp_layer))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.num_classes = num_classes
        if num_classes:
            self.head = nn.Linear(dim, num_classes)

    def cast_matmuls(self, dtype: torch.dtype) -> "VisionTransformer":
        """Put the patch embed's and every Linear's weights and biases in
        ``dtype`` (bf16: the card's route); the LayerNorms, LayerScales,
        tokens and position embeddings stay float32."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.to(dtype)
        return self

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The cls token, the register tokens, then the patch tokens with
        their position embeddings: (B, 1 + R + gh * gw, dim)."""
        p = self.patch_size
        x = x.permute(0, 3, 1, 2)
        (t, bot), (left, right) = _same_pad(x.shape[2], p), _same_pad(x.shape[3], p)
        if t or bot or left or right:
            x = F.pad(x, (left, right, t, bot))
        feat = self.patch_embed(x.to(self.patch_embed.weight.dtype))
        b, _, gh, gw = feat.shape
        feat = feat.flatten(2).transpose(1, 2)
        if self.no_embed_class:
            feat = feat + _interpolate_pos_embed(self.pos_embed, gh, gw)
            prefix = [self.cls_token.expand(b, 1, self.dim)]
        else:
            feat = feat + _interpolate_pos_embed(self.pos_embed[:, 1:], gh, gw)
            prefix = [(self.cls_token + self.pos_embed[:, :1]).expand(b, 1, self.dim)]
        if self.reg_token is not None:
            prefix.append(self.reg_token.expand(b, -1, self.dim))
        return torch.cat(prefix + [feat], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("backbone.vit"):
            feat = self.tokens(x)
            for i in range(self.depth):
                feat = getattr(self, f"block{i}")(feat)
            # the cls row alone: a view of the whole normed sequence would keep
            # it (265 float32 tokens a tile for UNI2-h) alive with the feature
            cls_out = self.norm(feat[:, 0])
            if not self.num_classes:
                return cls_out
            return self.head(cls_out.to(self.head.weight.dtype)).float()

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


def uni2_h(**kw) -> VisionTransformer:
    """UNI2-h, ViT-H/14 with 8 register tokens (MahmoodLab/UNI2-h's
    ``timm_kwargs``): patch 14 at 224, dim 1536, depth 24, 24 heads of 64,
    the packed SwiGLU MLP at ``mlp_ratio`` 2.66667 * 2 (``fc1`` 1536 -> 8192,
    ``fc2`` 4096 -> 1536), LayerScale (init 1e-5), ``no_embed_class``, qkv
    bias, LayerNorm eps 1e-6, no classifier: 1536-d cls features."""
    return VisionTransformer(**{"patch_size": 14, "dim": 1536, "depth": 24, "heads": 24,
                                "mlp_ratio": 2.66667 * 2, "reg_tokens": 8, "no_embed_class": True,
                                "init_values": 1e-5, "mlp_layer": "swiglu_packed", **kw})
