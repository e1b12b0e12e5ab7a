"""Layers of the TransMIL head (port of ``models/layers.py``).

- :class:`NystromAttentionLayer` / :class:`TransLayer` - the Nystrom-attention
  block (ref ``code/models/TransMIL.py:19-57``), on the XLA path's semantics.
- :class:`PPEG` - pyramid position encoding generator, folded to one 7x7
  depthwise conv (ref ``TransMIL.py:60-75``).
- :func:`make_fc1` - the per-in_features input MLP variants.

``dtype=torch.bfloat16`` is the JAX package's mixed precision: the Dense
layers, the value residual and PPEG compute in bfloat16 from float32
parameters, as flax's ``dtype=`` does; LayerNorm, softmax, the pinv and the
residual stream stay float32.

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


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``Dense(dtype=)``:
    input, weight and bias cast to it; the parameters stay float32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x.float(), self.weight, self.bias)
        # flax rounds the product to bfloat16, then adds the rounded bias
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class GELU(nn.GELU):
    """Exact GELU; on a bfloat16 input it is jax.nn.gelu's formula,
    ``0.5 * x * erfc(-x * sqrt(0.5))``, each op rounded to bfloat16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return super().forward(x)
        return 0.5 * x * torch.erfc(-x * torch.tensor(0.5 ** 0.5, dtype=x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the float32 value of its input (flax LayerNorm
    with float32 parameters normalizes a bfloat16 input in float32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


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
                 use_pallas: Optional[bool] = None, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks, self.pinv_iterations = num_landmarks, pinv_iterations
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.to_qkv = Linear(dim, inner * 3, bias=False, compute_dtype=dtype)
        self.to_out = nn.Sequential(Linear(inner, dim, compute_dtype=dtype), Dropout(dropout))
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
        kern = value_residual_kernel(self.res_conv.weight, self.dim_head).to(self.dtype)
        out = out + depthwise_conv1d(qkv[:, :, 2].reshape(b, np_, inner), kern).float()
        out = self.to_out(out)
        return out[:, -n:], cls_row, pad


class TransLayer(nn.Module):
    """Pre-norm residual Nystrom-attention block (ref ``TransMIL.py:19-57``)."""

    def __init__(self, dim: int = 512, use_pallas: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = NystromAttentionLayer(dim=dim, heads=8, dim_head=dim // 8,
                                          num_landmarks=dim // 2, use_pallas=use_pallas,
                                          dtype=dtype)

    def forward(self, x: torch.Tensor, return_row_index: Optional[int] = None):
        out, attn_row, pad = self.attn(self.norm(x), return_row_index=return_row_index)
        return x + out.to(x.dtype), attn_row, pad


class PPEG(nn.Module):
    """Pyramid Position Encoding Generator: the cls token bypasses; feature
    tokens on an H x W grid get identity + depthwise 7x7 + 5x5 + 3x3 convs,
    summed. The sum is one 7x7 depthwise conv with kernel
    ``w7 + pad(w5) + pad(w3) + center_delta`` and bias ``b7 + b5 + b3``; the
    parameters keep the reference's three convs."""

    def __init__(self, dim: int = 512, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
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
        dt = self.dtype
        out = (depthwise_conv2d(feat.reshape(b, h, w, c).to(dt), combined.permute(2, 3, 1, 0).to(dt))
               + bias.to(dt))
        return torch.cat([cls_token, out.to(x.dtype).reshape(b, h * w, c)], dim=1)


def make_fc1(in_features: int, out_features: int,
             dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """Input-projection MLP per in_features (ref ``TransMIL.py:100-133``, with
    the 1024 branch's LayerNorm widths corrected as in the JAX package):
      2048: Linear(2048,1024) GELU LN(1024) Linear(1024,512) GELU
      1024: Linear(1024,1024) GELU Drop(.2) LN(1024) Linear(1024,512) GELU Drop(.6) LN(512)
      768:  Linear(768,768)  GELU Drop(.6) LN(768)  Linear(768,512)  GELU Drop(.6) LN(512)
      else: Linear(in,512)   GELU
    The Sequential indices match the reference's ``_fc1.<i>`` keys. The
    Linears compute in ``dtype``; the LayerNorms return float32."""
    def linear(i: int, o: int) -> Linear:
        return Linear(i, o, compute_dtype=dtype)

    if in_features == 2048:
        half = in_features // 2
        return nn.Sequential(linear(in_features, half), GELU(), LayerNorm(half),
                             linear(half, out_features), GELU())
    if in_features in (1024, 768):
        drop0 = 0.2 if in_features == 1024 else 0.6
        return nn.Sequential(
            linear(in_features, in_features), GELU(), Dropout(drop0),
            LayerNorm(in_features), linear(in_features, out_features), GELU(),
            Dropout(0.6), LayerNorm(out_features),
        )
    return nn.Sequential(linear(in_features, out_features), GELU())
