"""Layers of the TransMIL head (port of ``models/layers.py``).

- :class:`NystromAttentionLayer` / :class:`TransLayer` - the Nystrom-attention
  block (ref ``code/models/TransMIL.py:19-57``), on the XLA path's semantics.
- :class:`PPEG` - pyramid position encoding generator, folded to one 7x7
  depthwise conv (ref ``TransMIL.py:60-75``).
- :func:`make_fc1` - the per-in_features input MLP variants.

Parameter names follow the reference torch modules (``to_qkv``,
``to_out.0``, ``res_conv``, ``proj``/``proj1``/``proj2``, ``_fc1.<i>``), so a
reference checkpoint's state dict loads as it is and
``utils/torch_weights.convert_transmil_state_dict`` of the JAX package maps
this state dict onto the flax tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.ops.depthwise import depthwise_conv1d, depthwise_conv2d
from transmil_deepgraft_tpu_torch.ops.nystrom import (
    nystrom_attention,
    nystrom_attention_row,
    pad_to_landmark_multiple,
)
from transmil_deepgraft_tpu_torch.ops.nystrom_kernel import nystrom_attention_fused_packed
from transmil_deepgraft_tpu_torch.ops.translayer_kernel import value_residual_kernel


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask comes from ``generator`` when one is set, so
    that a trainer can give the model a random stream seeded of its own."""

    generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0 or self.generator is None:
            return super().forward(x)
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x * keep / (1.0 - self.p)


class NystromAttentionLayer(nn.Module):
    """Self-attention via the Nystrom approximation (dim 512, 8 heads of 64, 256
    landmarks, 6 pinv iterations, 33-tap depthwise value residual, out-proj
    dropout 0.7), as the reference's ``nystrom_attention`` dependency.

    ``use_pallas=True`` runs the attention through the fused landmark kernels
    (:func:`~transmil_deepgraft_tpu_torch.ops.nystrom_kernel.nystrom_attention_fused_packed`,
    B5/B6 on the card, analytic backward) on the packed qkv; ``None`` or
    ``False`` runs the plain op, as in JAX."""

    def __init__(self, dim: int = 512, heads: int = 8, dim_head: int = 64,
                 num_landmarks: int = 256, pinv_iterations: int = 6,
                 residual_kernel_size: int = 33, dropout: float = 0.7,
                 use_pallas: Optional[bool] = None) -> None:
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks, self.pinv_iterations = num_landmarks, pinv_iterations
        self.use_pallas = use_pallas
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), Dropout(dropout))
        ks = residual_kernel_size
        self.res_conv = nn.Conv2d(heads, heads, (ks, 1), padding=(ks // 2, 0),
                                  groups=heads, bias=False)

    def forward(self, x: torch.Tensor, return_row_index: Optional[int] = None):
        """x: (B, N, dim). Returns (out (B, N, dim), attn_row, pad).

        ``return_row_index`` indexes the *padded* sequence; ``attn_row`` is
        (B, heads, N_padded)."""
        b, n, _ = x.shape
        inner = self.heads * self.dim_head
        x_p, pad = pad_to_landmark_multiple(x, self.num_landmarks)
        np_ = x_p.shape[1]
        qkv = self.to_qkv(x_p).reshape(b, np_, 3, self.heads, self.dim_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if self.use_pallas:
            out_bnhd = nystrom_attention_fused_packed(qkv, self.num_landmarks,
                                                      self.pinv_iterations)
            cls_row = None
            if return_row_index is not None:
                cls_row = nystrom_attention_row(q, k, num_landmarks=self.num_landmarks,
                                                pinv_iterations=self.pinv_iterations,
                                                row_index=return_row_index)
        else:
            result = nystrom_attention(q, k, v, num_landmarks=self.num_landmarks,
                                       pinv_iterations=self.pinv_iterations,
                                       return_row_index=return_row_index)
            out_bnhd, cls_row = result.out.transpose(1, 2), result.cls_row
        out = out_bnhd.reshape(b, np_, inner)
        # one depthwise conv over all value columns: torch Conv2d(h, h, (33, 1),
        # groups=h) on (b, h, n, d), run as the JAX package runs it
        kern = value_residual_kernel(self.res_conv.weight, self.dim_head)
        out = out + depthwise_conv1d(qkv[:, :, 2].reshape(b, np_, inner), kern)
        out = self.to_out(out)
        return out[:, -n:], cls_row, pad


class TransLayer(nn.Module):
    """Pre-norm residual Nystrom-attention block (ref ``TransMIL.py:19-57``)."""

    def __init__(self, dim: int = 512, use_pallas: Optional[bool] = None) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = NystromAttentionLayer(dim=dim, heads=8, dim_head=dim // 8,
                                          num_landmarks=dim // 2, use_pallas=use_pallas)

    def forward(self, x: torch.Tensor, return_row_index: Optional[int] = None):
        out, attn_row, pad = self.attn(self.norm(x), return_row_index=return_row_index)
        return x + out, attn_row, pad


class PPEG(nn.Module):
    """Pyramid Position Encoding Generator: the cls token bypasses; feature
    tokens on an H x W grid get identity + depthwise 7x7 + 5x5 + 3x3 convs,
    summed. The sum is one 7x7 depthwise conv with kernel
    ``w7 + pad(w5) + pad(w3) + center_delta`` and bias ``b7 + b5 + b3``; the
    parameters keep the reference's three convs."""

    def __init__(self, dim: int = 512) -> None:
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 7, 1, 3, groups=dim)
        self.proj1 = nn.Conv2d(dim, dim, 5, 1, 2, groups=dim)
        self.proj2 = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        cls_token, feat = x[:, :1], x[:, 1:]
        combined = (self.proj.weight + F.pad(self.proj1.weight, (1, 1, 1, 1))
                    + F.pad(self.proj2.weight, (2, 2, 2, 2)))  # (C, 1, 7, 7), a new tensor
        combined[:, :, 3, 3] += 1.0  # the identity
        bias = self.proj.bias + self.proj1.bias + self.proj2.bias
        out = depthwise_conv2d(feat.reshape(b, h, w, c), combined.permute(2, 3, 1, 0)) + bias
        return torch.cat([cls_token, out.reshape(b, h * w, c)], dim=1)


def make_fc1(in_features: int, out_features: int) -> nn.Sequential:
    """Input-projection MLP per in_features (ref ``TransMIL.py:100-133``, with
    the 1024 branch's LayerNorm widths corrected as in the JAX package):
      2048: Linear(2048,1024) GELU LN(1024) Linear(1024,512) GELU
      1024: Linear(1024,1024) GELU Drop(.2) LN(1024) Linear(1024,512) GELU Drop(.6) LN(512)
      768:  Linear(768,768)  GELU Drop(.6) LN(768)  Linear(768,512)  GELU Drop(.6) LN(512)
      else: Linear(in,512)   GELU
    The Sequential indices match the reference's ``_fc1.<i>`` keys."""
    if in_features == 2048:
        half = in_features // 2
        return nn.Sequential(nn.Linear(in_features, half), nn.GELU(), nn.LayerNorm(half),
                             nn.Linear(half, out_features), nn.GELU())
    if in_features in (1024, 768):
        drop0 = 0.2 if in_features == 1024 else 0.6
        return nn.Sequential(
            nn.Linear(in_features, in_features), nn.GELU(), Dropout(drop0),
            nn.LayerNorm(in_features), nn.Linear(in_features, out_features), nn.GELU(),
            Dropout(0.6), nn.LayerNorm(out_features),
        )
    return nn.Sequential(nn.Linear(in_features, out_features), nn.GELU())
