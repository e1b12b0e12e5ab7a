"""RoFormerMIL: position-aware transformer MIL through 2-D rotary
embeddings (port of ``models/roformer_mil.py``).

The trunk is TransformerMIL's fc1 and a pre-norm encoder; the attention
rotates q and k by the tiles' grid coordinates, axially: the first half of
the head dimension by x, the second by y, each as interleaved-pair RoPE.
The logits then depend on coordinate differences alone. The cls token sits
at (0, 0) (no rotation) and the tiles at their coordinates + 1, after each
bag's per-axis minimum is subtracted, so a bag gives the same logits
translated or not, and padded (``data/coords.normalize_pad_coords``) or
exact.

``num_landmarks=0`` is exact softmax attention (``ops/attention``: its plain
version, or ``scaled_dot_product_attention`` on the card);
``num_landmarks>0`` is rotary Nystrom attention through the plain
``ops/nystrom.nystrom_attention``, as in the JAX head (the rotations commute
with the landmark segment means). ``return_attn`` gives the last layer's
cls-query row as a :class:`TransMILAttention`.

Parameter names follow the flax paths: ``fc1.<i>`` (TransformerMIL's
indices), ``cls_token``, ``attn_norm_<i>``, ``attn_<i>.to_qkv``,
``attn_<i>.to_out``, ``ff_norm_<i>``, ``ff_<i>.{0,2}`` (flax ``Dense_<2i>``,
``Dense_<2i+1>``), ``norm``, ``fc2``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.data.coords import grid_coords
from transmil_deepgraft_tpu_torch.models.layers import GELU, Dropout
from transmil_deepgraft_tpu_torch.models.transmil import TransMILAttention
from transmil_deepgraft_tpu_torch.ops.attention import attention_row, softmax_attention
from transmil_deepgraft_tpu_torch.ops.nystrom import nystrom_attention, pad_to_landmark_multiple


def _rotary_cos_sin(pos: torch.Tensor, dim: int, base: float = 10000.0):
    """cos/sin tables of interleaved-pair RoPE: (b, n) positions -> two
    (b, 1, n, dim // 2) tensors."""
    inv_freq = base ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim)
    angles = pos[:, :, None].float() * inv_freq
    return torch.cos(angles)[:, None], torch.sin(angles)[:, None]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def apply_axial_rotary(x: torch.Tensor, coords: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Axial 2-D RoPE on (b, h, n, d): the first d/2 rotated by
    ``coords[..., 0]``, the second by ``coords[..., 1]``; coords (b, n, 2)."""
    half = x.shape[-1] // 2
    cx, sx = _rotary_cos_sin(coords[..., 0], half, base)
    cy, sy = _rotary_cos_sin(coords[..., 1], half, base)
    return torch.cat([_rotate(x[..., :half], cx, sx), _rotate(x[..., half:], cy, sy)], dim=-1)


def default_grid_coords(n_tokens: int, batch: int, device=None) -> torch.Tensor:
    """Row-major positions on the ``ceil(sqrt(N))`` square grid for bags
    without coordinates: (b, n, 2) float32."""
    return torch.from_numpy(grid_coords(n_tokens, batch)).to(device)


class RotaryAttention(nn.Module):
    """Multi-head self-attention with axial 2-D rotary q/k, exact
    (``num_landmarks=0``) or Nystrom (``num_landmarks>0``)."""

    def __init__(self, dim: int = 512, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.1, rope_base: float = 10000.0, num_landmarks: int = 0,
                 pinv_iterations: int = 6) -> None:
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.rope_base, self.num_landmarks = rope_base, num_landmarks
        self.pinv_iterations = pinv_iterations
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim)
        self.dropout = Dropout(dropout)

    def _qk_rotated(self, x: torch.Tensor, coords: torch.Tensor):
        b, n, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads, self.dim_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return (apply_axial_rotary(q, coords, self.rope_base),
                apply_axial_rotary(k, coords, self.rope_base), v)

    def forward(self, x: torch.Tensor, coords: torch.Tensor, return_attn_row: bool = False):
        """x (b, n, dim), coords (b, n, 2) -> out, or (out, (row, pad)) with
        ``return_attn_row``: the cls query's attention over all (front-padded)
        keys and the front pad (0 in exact mode)."""
        b, n, _ = x.shape
        if self.num_landmarks:
            # front-pad to a landmark multiple; pad rows project to zero q/k/v
            x_p, pad = pad_to_landmark_multiple(x, self.num_landmarks)
            q, k, v = self._qk_rotated(x_p, F.pad(coords, (0, 0, pad, 0)))
            result = nystrom_attention(q, k, v, num_landmarks=self.num_landmarks,
                                       pinv_iterations=self.pinv_iterations,
                                       return_row_index=pad if return_attn_row else None)
            out = result.out.transpose(1, 2)[:, pad:].reshape(b, n, -1)
            row = (result.cls_row, pad)
        else:
            q, k, v = self._qk_rotated(x, coords)
            scale = self.dim_head ** -0.5
            out = softmax_attention(q, k, v, scale).transpose(1, 2).reshape(b, n, -1)
            row = (attention_row(q, k, 0, scale) if return_attn_row else None, 0)
        out = self.dropout(self.to_out(out))
        return (out, row) if return_attn_row else out


class RoFormerMIL(nn.Module):
    """TransformerMIL's trunk with rotary position-aware attention; the
    forward takes ``coords`` (b, n, 2), the tile grid positions (None: the
    square-grid fallback)."""

    # the trainer and the bundles give a coord-aware head the tile
    # coordinates as its second argument; the attention query is the cls row
    coord_aware = True
    attn_query = "cls"
    flax_classifier = "fc2"  # the flax name of the (width, n_classes) classifier
    gives_attention = True  # return_attn gives the cls row

    def __init__(self, n_classes: int, in_features: int = 2048, out_features: int = 512,
                 depth: int = 4, heads: int = 8, dim_head: int = 64, mlp_dim: int = 512,
                 pool: str = "cls", dropout: float = 0.1, emb_dropout: float = 0.5,
                 rope_base: float = 10000.0, num_landmarks: int = 0) -> None:
        super().__init__()
        self.depth, self.pool = depth, pool
        if in_features >= 2048:
            half = in_features // 2
            self.fc1 = nn.Sequential(nn.Linear(in_features, half), GELU(), Dropout(0.6),
                                     nn.LayerNorm(half, eps=1e-5),
                                     nn.Linear(half, out_features), GELU())
        else:
            self.fc1 = nn.Sequential(nn.Linear(in_features, out_features), GELU())
        self.cls_token = nn.Parameter(torch.randn(1, 1, out_features))
        self.emb_dropout = Dropout(emb_dropout)
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", nn.LayerNorm(out_features, eps=1e-5))
            self.add_module(f"attn_{i}", RotaryAttention(out_features, heads, dim_head, dropout,
                                                         rope_base, num_landmarks))
            self.add_module(f"ff_norm_{i}", nn.LayerNorm(out_features, eps=1e-5))
            self.add_module(f"ff_{i}", nn.Sequential(nn.Linear(out_features, mlp_dim), GELU(),
                                                     nn.Linear(mlp_dim, out_features)))
        self.ff_dropout = Dropout(dropout)
        self.norm = nn.LayerNorm(out_features, eps=1e-5)
        self.fc2 = nn.Linear(out_features, n_classes)

    def forward(self, x: torch.Tensor, coords: Optional[torch.Tensor] = None,
                return_attn: bool = False):
        if x.dim() == 2:
            x = x[None]
        b, n, _ = x.shape
        h = self.fc1(x.float())
        if coords is None:
            coords = default_grid_coords(n, b, x.device)
        elif coords.dim() == 2:
            coords = coords[None]
        coords = coords.float().expand(b, n, 2)
        # anchor the bag at its bounding box, so that the cls token's absolute
        # (0, 0) sees a translated slide as the same slide
        coords = coords - coords.min(dim=1, keepdim=True).values
        h = torch.cat([self.cls_token.expand(b, -1, -1), h], dim=1)
        coords = torch.cat([coords.new_zeros(b, 1, 2), coords + 1.0], dim=1)
        h = self.emb_dropout(h)

        attn_row, attn_pad = None, 0
        for i in range(self.depth):
            want_row = return_attn and i == self.depth - 1
            out = getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(h), coords,
                                             return_attn_row=want_row)
            if want_row:
                out, (attn_row, attn_pad) = out
            h = h + out
            ff = getattr(self, f"ff_{i}")(getattr(self, f"ff_norm_{i}")(h))
            h = h + self.ff_dropout(ff)

        pooled = h.mean(dim=1) if self.pool == "mean" else h[:, 0]
        logits = self.fc2(self.norm(pooled))
        if return_attn:
            return logits, TransMILAttention(row=attn_row, pad=attn_pad, n_tokens=n)
        return logits
