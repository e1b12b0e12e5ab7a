"""Bag-level reduction ops of the AttMIL and Chowder heads (port of
``ops/pooling.py``).

- :func:`gated_attention_pool` - Ilse-style gated attention
  ``A = w^T (tanh(V h) * sigmoid(U h))`` softmaxed over instances, then
  ``M = A h`` (ref ``code/models/AttMIL.py:72-107``).
- :func:`topk_minmax_scores` - Chowder's bottom-R min and top-R max instance
  scores (ref ``code/models/Chowder.py:19-50``).
"""

from __future__ import annotations

from typing import Optional

import torch


def gated_attention_pool(
    h: torch.Tensor,
    v_w: torch.Tensor,
    u_w: torch.Tensor,
    w_w: torch.Tensor,
    *,
    v_b: Optional[torch.Tensor] = None,
    u_b: Optional[torch.Tensor] = None,
    w_b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated attention pooling over instances.

    h: (..., N, L) instance features; v_w, u_w: (L, D) tanh and sigmoid
    branch weights; w_w: (D, K) attention head weight (K = 1 for AttMIL);
    mask: optional (..., N) bool, False positions score -inf.

    Returns (pooled (..., K, L), attn (..., K, N) post-softmax weights)."""
    av = torch.tanh(h @ v_w + (0 if v_b is None else v_b))
    au = torch.sigmoid(h @ u_w + (0 if u_b is None else u_b))
    scores = ((av * au) @ w_w + (0 if w_b is None else w_b)).transpose(-1, -2)  # (..., K, N)
    if mask is not None:
        scores = scores.masked_fill(~mask[..., None, :], float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    return attn @ h, attn


def topk_minmax_scores(scores: torch.Tensor, r: int) -> torch.Tensor:
    """(..., N) instance scores -> (..., 2R): the bottom R ascending, then
    the top R descending (the reference's ``cat((min, max))`` order).
    ``topk(largest=False)`` returns the bottom values ascending, the order
    JAX's ``-top_k(-s)`` gives."""
    top = torch.topk(scores, r, dim=-1).values
    bottom = torch.topk(scores, r, dim=-1, largest=False).values
    return torch.cat([bottom, top], dim=-1)
