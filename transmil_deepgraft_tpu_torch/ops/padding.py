"""Static-shape padding / bucketing utilities (port of ``ops/padding.py``).

Bags are padded to a bucket length so each shape repeats, and inside TransMIL
they are *duplicate-padded* to a perfect square so tokens form an H x W grid
for PPEG (ref ``code/models/TransMIL.py:176-180``).
"""

from __future__ import annotations

import math

import torch

# Default bag-length buckets: powers of two from 256 to 65536.
DEFAULT_BUCKETS: tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def bucket_for_length(n: int, buckets: tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (last bucket if n exceeds all)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def square_pad_length(n: int) -> tuple[int, int, int]:
    """(H, W, add_length) for duplicate-padding n tokens to ceil(sqrt(n))^2."""
    side = int(math.ceil(math.sqrt(n)))
    return side, side, side * side - n


def duplicate_pad_square(h: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """Duplicate-pad (B, N, C) tokens to (B, H*W, C) with H = W = ceil(sqrt(N)).

    The pad repeats the first ``add_length`` tokens, as the reference does with
    ``torch.cat([h, h[:, :add_length]], dim=1)``.
    """
    side, _, add = square_pad_length(h.shape[1])
    if add:
        h = torch.cat([h, h[:, :add]], dim=1)
    return h, side, side
