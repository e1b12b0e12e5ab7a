"""Nystrom linear attention: the op underneath TransMIL's TransLayer (port of
``ops/nystrom.py``).

Semantics, as in the reference's ``nystrom_attention`` dependency:
  * sequences are front-padded with zeros to a multiple of ``m``; no mask is
    applied, so pad tokens take part in attention;
  * landmarks are contiguous-segment means over the padded sequence;
  * ``out = softmax(q k_lm^T) @ pinv(softmax(q_lm k_lm^T)) @ (softmax(q_lm k^T) @ v)``
    with q pre-scaled by ``dim_head**-0.5``.

Tensors are (b, h, n, d), as in the JAX package. Inputs in bfloat16 follow
the JAX op's mixed precision: the products take bfloat16 operands (rounded
where JAX casts) with float32 sums and results; softmax and the pinv run in
float32. Float32 inputs compute in float32 throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from transmil_deepgraft_tpu_torch.ops.pinv import newton_schulz_pinv


class NystromOutput(NamedTuple):
    out: torch.Tensor  # (b, h, n_padded, d) attention output (pre out-projection)
    cls_row: Optional[torch.Tensor]  # (b, h, n_padded) attention row for one query


def pad_to_landmark_multiple(x: torch.Tensor, num_landmarks: int) -> tuple[torch.Tensor, int]:
    """Front-pad the sequence axis (-2) with zeros to a multiple of
    num_landmarks. Returns (padded, pad_amount)."""
    pad = (num_landmarks - x.shape[-2] % num_landmarks) % num_landmarks
    if pad:
        x = F.pad(x, (0, 0, pad, 0))
    return x, pad


def _segment_means(x: torch.Tensor, m: int) -> torch.Tensor:
    """Contiguous segment means along axis -2: (..., n, d) -> (..., m, d)."""
    *lead, n, d = x.shape
    return x.reshape(*lead, m, n // m, d).mean(dim=-2)


def nystrom_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_landmarks: int = 256,
    pinv_iterations: int = 6,
    return_row_index: Optional[int] = None,
) -> NystromOutput:
    """Nystrom attention over pre-projected q, k, v of shape (b, h, n, d).

    ``n`` must already be a multiple of ``num_landmarks``. If
    ``return_row_index`` is given, also returns the attention row of that
    (padded) query position, ``(attn1[idx] @ pinv) @ attn3``, in O(n*m).
    """
    n, d = q.shape[-2:]
    m = num_landmarks
    if n % m != 0:
        raise ValueError(f"sequence length {n} not a multiple of landmarks {m}")
    dt = q.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        """Round to the input dtype, compute on in float32 (exact products)."""
        return t.to(dt).float()

    q = rnd(q * torch.tensor(d ** -0.5, dtype=dt))
    k, v = k.float(), v.float()
    q_lm = rnd(_segment_means(q, m))
    k_lm = rnd(_segment_means(k, m))

    attn1 = torch.softmax(q @ k_lm.transpose(-1, -2), dim=-1)  # (b, h, n, m)
    attn2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)  # (b, h, m, m)
    attn3 = torch.softmax(q_lm @ k.transpose(-1, -2), dim=-1)  # (b, h, m, n)
    attn2_inv = newton_schulz_pinv(attn2, pinv_iterations)

    left = rnd(attn1) @ rnd(attn2_inv)  # (b, h, n, m)
    out = rnd(left) @ rnd(rnd(attn3) @ v)

    cls_row = None
    if return_row_index is not None:
        cls_row = (left[:, :, return_row_index, None, :] @ attn3)[:, :, 0]
    return NystromOutput(out=out, cls_row=cls_row)


def nystrom_attention_row(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    num_landmarks: int = 256,
    pinv_iterations: int = 6,
    row_index: int,
) -> torch.Tensor:
    """Just the attention ROW of one query position,
    ``(attn1[idx] @ pinv(attn2)) @ attn3``, with no value matmuls.
    q, k: (b, h, n, d) with n a multiple of num_landmarks. Returns (b, h, n)."""
    d = q.shape[-1]
    m = num_landmarks
    qf = q.float() * d ** -0.5
    kf = k.float()
    q_lm = _segment_means(qf, m)
    k_lm = _segment_means(kf, m)
    attn1_row = torch.softmax(qf[:, :, row_index, None, :] @ k_lm.transpose(-1, -2), dim=-1)
    attn2 = torch.softmax(q_lm @ k_lm.transpose(-1, -2), dim=-1)
    attn3 = torch.softmax(q_lm @ kf.transpose(-1, -2), dim=-1)
    return (attn1_row @ newton_schulz_pinv(attn2, pinv_iterations) @ attn3)[:, :, 0]
