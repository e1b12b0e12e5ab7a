"""Dense softmax attention of the transformer heads: the einsum of JAX's
``SoftmaxAttention``, ``RotaryAttention`` (exact mode) and
``TorchEncoderLayer``, ``softmax(q k^T * scale) @ v`` in float32.

The plain version is that formula over blocks of query rows, so that one
block's (b, h, rows, n) logits stay within :data:`PLAIN_BLOCK_BYTES` (a bag
of a few thousand tiles is one block). Rows are independent, so the blocks
change the memory and not the function.

On a CUDA tensor the same function runs through
``torch.nn.functional.scaled_dot_product_attention`` with its
memory-efficient backend alone, which never holds the b*h*n^2 logits: at
a 40,960-tile bag (65,537 tokens after the bucket pad and the cls token)
they would be 137 GB. Inside :func:`plain_route` the card runs the plain
version too, which is what the card path is held against.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F

PLAIN_BLOCK_BYTES = 2 << 30  # float32 logits a block of query rows may hold
_PLAIN = False


@contextlib.contextmanager
def plain_route() -> Iterator[None]:
    """Run :func:`softmax_attention` as its plain version on every device."""
    global _PLAIN
    before, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = before


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                      ) -> torch.Tensor:
    """(b, h, n, d) float32 q, k, v -> (b, h, n, d) attention output.
    ``dropout`` (applied to the attention weights, as the torch encoder
    layer does) takes the plain version."""
    if q.is_cuda and not _PLAIN and dropout is None:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, scale=scale)
    b, h, n, _ = q.shape
    rows = max(1, PLAIN_BLOCK_BYTES // (4 * b * h * k.shape[-2]))
    outs = []
    for start in range(0, n, rows):
        attn = torch.softmax((q[:, :, start:start + rows] @ k.transpose(-1, -2)) * scale, dim=-1)
        if dropout is not None:
            attn = dropout(attn)
        outs.append(attn @ v)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def attention_row(q: torch.Tensor, k: torch.Tensor, index: int, scale: float) -> torch.Tensor:
    """The attention weights of query ``index`` over all keys,
    ``softmax(q[index] k^T * scale)``: (b, h, n), from that row alone."""
    return torch.softmax((q[:, :, index, None] @ k.transpose(-1, -2))[:, :, 0] * scale, dim=-1)
