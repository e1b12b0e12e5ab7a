"""UNI2-h's forward in plain PyTorch, float32: the plain reference of the
port's ``models/vit.uni2_h``.

UNI2-h is a timm ``VisionTransformer`` (Chen et al., "Towards a
general-purpose foundation model for computational pathology", Nature
Medicine 2024; huggingface.co/MahmoodLab/UNI2-h, whose ``timm_kwargs`` are
``img_size`` 224, ``patch_size`` 14, ``depth`` 24, ``num_heads`` 24,
``init_values`` 1e-5, ``embed_dim`` 1536, ``mlp_ratio`` 2.66667 * 2,
``num_classes`` 0, ``no_embed_class`` True, ``mlp_layer`` SwiGLUPacked,
``act_layer`` SiLU, ``reg_tokens`` 8, ``dynamic_img_size`` True). Written
from those settings and timm's defaults (qkv and projection biases,
LayerNorm eps 1e-6, the cls token's features after the final norm), with
the module names of timm, so that ``state_dict()`` is a checkpoint in
timm's names:

- ``patch_embed.proj``: a p x p, stride-p convolution;
- tokens ``[cls, reg_0 .. reg_{R-1}, patches]``; ``pos_embed`` (1, gh * gw,
  D) is added to the patches alone (``no_embed_class``), resized bicubically
  with antialiasing for another grid (``dynamic_img_size``);
- each of ``blocks``: ``x + ls1.gamma * attn.proj(softmax(q k^T / sqrt(64))
  v)`` on ``norm1(x)``, then ``x + ls2.gamma * mlp.fc2(SiLU(a) * b)`` with
  ``a, b`` the first and second halves of ``mlp.fc1(norm2(x))``
  (``GluMlp(gate_last=False)``);
- ``norm``, and the cls row out (``num_classes`` 0: no head).

The only departure from the model card is the absent classifier, which
``num_classes`` 0 leaves out too. Attention is the explicit formula. TF32
is off for as long as :func:`forward_features` runs.

``gemm="fp8"`` rounds both operands of every product (the patch embed, each
Linear, q k^T and the probabilities times v) to float8 e4m3 with a
per-tensor scale before a float32 product: the next precision below the
port's bf16 route, for a control.

It imports nothing of the port. This file is the benchmark's copy of the
test suite's ``tests/torch_ref/uni2h_torch.py``, so that a change to the
benchmark cannot move what the tests hold the port to; a benchmark test
holds the two copies to the same features.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
GEMMS = ("float32", "fp8")
# the model card's normalization (ImageNet's)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def normalize(tiles: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 tiles -> (B, 3, H, W) normalized float32."""
    x = tiles.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(MEAN, device=x.device)[:, None, None]
    std = torch.tensor(STD, device=x.device)[:, None, None]
    return (x - mean) / std


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale, as float32."""
    scale = t.abs().amax().float().clamp_min(1e-30) / 448.0
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


class _Gemm:
    """The operands of a product: as they are, or rounded to fp8."""

    def __init__(self, mode: str) -> None:
        if mode not in GEMMS:
            raise ValueError(f"gemm must be one of {GEMMS}, got {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return fp8(t) if self.mode == "fp8" else t


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))


class GluMlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden // 2, dim)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, init_values: float) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = GluMlp(dim, hidden)
        self.ls2 = LayerScale(dim, init_values)


class UNI2h(nn.Module):
    """The model's parameters under timm's names; :func:`forward_features`
    is its forward. Defaults are UNI2-h's widths."""

    def __init__(self, img_size: int = 224, patch_size: int = 14, embed_dim: int = 1536,
                 depth: int = 24, num_heads: int = 24, mlp_ratio: float = 2.66667 * 2,
                 reg_tokens: int = 8, init_values: float = 1e-5) -> None:
        super().__init__()
        grid = img_size // patch_size
        self.patch_size, self.grid = patch_size, grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.reg_token = nn.Parameter(torch.zeros(1, reg_tokens, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, embed_dim))
        hidden = int(embed_dim * mlp_ratio)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, hidden, init_values)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


@contextlib.contextmanager
def _no_tf32():
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, torch.backends.cudnn.allow_tf32
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _linear(x: torch.Tensor, layer: nn.Linear, g: _Gemm) -> torch.Tensor:
    return g(x) @ g(layer.weight).t() + layer.bias


def _pos_embed(model: UNI2h, gh: int, gw: int) -> torch.Tensor:
    """timm's ``resample_abs_pos_embed`` with no prefix tokens."""
    pos = model.pos_embed
    if (gh, gw) == (model.grid, model.grid):
        return pos
    grid = pos.reshape(1, model.grid, model.grid, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True)
    return grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)


def _attention(x: torch.Tensor, attn: Attention, g: _Gemm) -> torch.Tensor:
    b, n, dim = x.shape
    d = dim // attn.heads
    qkv = _linear(x, attn.qkv, g).reshape(b, n, 3, attn.heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    p = torch.softmax((g(q) @ g(k).transpose(-1, -2)) * d ** -0.5, dim=-1)
    out = (g(p) @ g(v)).transpose(1, 2).reshape(b, n, dim)
    return _linear(out, attn.proj, g)


def _mlp(x: torch.Tensor, mlp: GluMlp, g: _Gemm) -> torch.Tensor:
    gate, value = _linear(x, mlp.fc1, g).chunk(2, dim=-1)
    return _linear(F.silu(gate) * value, mlp.fc2, g)


@torch.no_grad()
def forward_features(model: UNI2h, x: torch.Tensor, gemm: str = "float32") -> torch.Tensor:
    """(B, 3, H, W) normalized float32 tiles -> (B, D) cls features, float32."""
    g = _Gemm(gemm)
    with _no_tf32():
        proj = model.patch_embed.proj
        feat = F.conv2d(g(x.float()), g(proj.weight), proj.bias, stride=model.patch_size)
        b, dim, gh, gw = feat.shape
        feat = feat.flatten(2).transpose(1, 2) + _pos_embed(model, gh, gw)
        h = torch.cat([model.cls_token.expand(b, -1, -1), model.reg_token.expand(b, -1, -1),
                       feat], dim=1)
        for blk in model.blocks:
            h = h + blk.ls1.gamma * _attention(F.layer_norm(h, (dim,), blk.norm1.weight,
                                                            blk.norm1.bias, LN_EPS), blk.attn, g)
            h = h + blk.ls2.gamma * _mlp(F.layer_norm(h, (dim,), blk.norm2.weight,
                                                      blk.norm2.bias, LN_EPS), blk.mlp, g)
        h = F.layer_norm(h, (dim,), model.norm.weight, model.norm.bias, LN_EPS)
    return h[:, 0]
