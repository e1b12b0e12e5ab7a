"""TransMIL: Nystrom-attention transformer MIL head (port of
``models/transmil.py``).

Architecture (ref ``code/models/TransMIL.py:78-211``):
  fc1 MLP -> duplicate-pad bag to ceil(sqrt(N))^2 -> prepend cls token ->
  TransLayer1 -> PPEG -> TransLayer2 -> LayerNorm -> cls-token logits.

In eval mode without ``return_attn`` both TransLayers run through
:func:`~transmil_deepgraft_tpu_torch.ops.translayer_kernel.fused_translayer`:
its two CUDA kernels on a CUDA input, their plain versions on a CPU input.
Training and ``return_attn`` run the standard layers (same parameters), as in
the JAX package; with ``use_pallas=True`` their attention goes through the
fused landmark kernels (B5/B6 on the card, analytic backward). ``return_attn=True`` also returns the layer-2 attention row
for heatmaps, computed in O(N*m); ``attn_query='ref'`` reproduces the
reference's ``padding+1`` row index, ``'cls'`` uses the true cls row.

``dtype=torch.bfloat16`` (``create_model(precision='16-mixed')``) is the JAX
model's mixed precision: the bag enters the fc1 MLP in bfloat16, and the
Dense layers, the value residual and PPEG compute in bfloat16, while the
residual stream is float32 from the cls-token concat on (jnp.concatenate
promotes it, and so does the port). The kernels are the same: K1/K2 and
B5/B6 take float32 operands (a bfloat16 qkv upcast, which is exact).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from transmil_deepgraft_tpu_torch.models.layers import PPEG, TransLayer, make_fc1
from transmil_deepgraft_tpu_torch.ops.padding import duplicate_pad_square
from transmil_deepgraft_tpu_torch.ops.translayer_kernel import fused_translayer, landmark_pad


class TransMILAttention(NamedTuple):
    """Attention payload for visualization.

    ``row``: (B, heads, N_pad_lm) layer-2 attention of the query row over all
    padded keys. ``pad``: the landmark front-pad. ``n_tokens``: number of real
    (pre-duplicate-pad) bag tokens.
    """

    row: torch.Tensor
    pad: int
    n_tokens: int

    def tile_scores(self) -> torch.Tensor:
        """(B, heads, n_tokens) attention over the real tiles, reproducing the
        reference slice ``attn[0, :, pad+1, pad+1 : pad+1+H]``."""
        start = self.pad + 1
        return self.row[..., start:start + self.n_tokens]


class TransMIL(nn.Module):
    def __init__(self, n_classes: int, in_features: int = 2048, out_features: int = 512,
                 attn_query: str = "ref", fused_inference: bool = True,
                 use_pallas: Optional[bool] = None, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.out_features = out_features
        self.attn_query = attn_query
        self.fused_inference = fused_inference
        self.dtype = dtype
        self.pos_layer = PPEG(dim=out_features, dtype=dtype)
        self._fc1 = make_fc1(in_features, out_features, dtype)
        self.cls_token = nn.Parameter(torch.randn(1, 1, out_features))
        self.layer1 = TransLayer(dim=out_features, use_pallas=use_pallas, dtype=dtype)
        self.layer2 = TransLayer(dim=out_features, use_pallas=use_pallas, dtype=dtype)
        self.norm = nn.LayerNorm(out_features, eps=1e-5)
        self._fc = nn.Linear(out_features, n_classes)

    def _run_layer(self, layer: TransLayer, h: torch.Tensor, fused: bool,
                   row_index: Optional[int]):
        if fused:
            attn = layer.attn
            y = fused_translayer(
                h, layer.norm.weight, layer.norm.bias, attn.to_qkv.weight,
                attn.to_out[0].weight, attn.to_out[0].bias, attn.res_conv.weight,
                heads=attn.heads, dim_head=attn.dim_head,
                num_landmarks=attn.num_landmarks, pinv_iterations=attn.pinv_iterations,
            )
            return y, None
        out, attn_row, _ = layer(h, return_row_index=row_index)
        return out, attn_row

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        if x.dim() == 2:
            x = x[None]
        h = self._fc1(x.to(self.dtype))
        n_tokens = h.shape[1]
        h, grid_h, grid_w = duplicate_pad_square(h)
        h = torch.cat([self.cls_token.expand(h.shape[0], -1, -1), h.float()], dim=1)

        fused = self.fused_inference and not self.training and not return_attn
        h, _ = self._run_layer(self.layer1, h, fused, None)
        h = self.pos_layer(h, grid_h, grid_w)

        # the landmark front-pad of the (grid_h*grid_w + 1)-token sequence
        pad = landmark_pad(h.shape[1], self.out_features // 2)
        row_index = None
        if return_attn:
            row_index = pad + (1 if self.attn_query == "ref" else 0)
        h, attn_row = self._run_layer(self.layer2, h, fused, row_index)

        logits = self._fc(self.norm(h)[:, 0])
        if return_attn:
            return logits, TransMILAttention(row=attn_row, pad=pad, n_tokens=n_tokens)
        return logits
