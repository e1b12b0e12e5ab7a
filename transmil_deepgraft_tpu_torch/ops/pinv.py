"""Iterative Moore-Penrose pseudo-inverse (Newton-Schulz, order-3 variant).

Port of ``ops/pinv.py``: the Nystromformer paper's iteration

    Z_0   = A^T / (max_i sum_j |A_ij| * max_j sum_i |A_ij|)
    Z_t+1 = 1/4 * Z_t (13 I - A Z_t (15 I - A Z_t (7 I - A Z_t)))

The init divisor is ONE global max over every batch/head (a single scalar),
as in the reference dependency's ``torch.max`` over the whole tensor; it is
detached, as the JAX version stops its gradient.

Under data parallelism the batch is split over processes, while JAX's dp
mesh takes that max over the whole sharded batch (GSPMD reduces it across
devices). Inside :func:`divisor_reduced_over` the two maxima are
``all_reduce``d (MAX) over the group, so every process divides by the
global batch's divisor and dp training equals one-device training. The
setting is process-wide (not per thread), because the analytic backward of
the fused attention recomputes the pinv on autograd's own thread.
"""

from __future__ import annotations

import contextlib

import torch

# the process group the divisor is reduced over, or None
_DIVISOR_GROUP: list = [None]


@contextlib.contextmanager
def divisor_reduced_over(group):
    """Reduce the init divisor of every pinv inside over ``group`` (a
    ``torch.distributed`` process group; None leaves it per process). Every
    process of the group must then run the same pinv calls in the same
    order, as data-parallel train steps do."""
    prev = _DIVISOR_GROUP[0]
    _DIVISOR_GROUP[0] = group
    try:
        yield
    finally:
        _DIVISOR_GROUP[0] = prev


def _init_divisor(abs_a: torch.Tensor) -> torch.Tensor:
    row, col = abs_a.sum(dim=-1).max(), abs_a.sum(dim=-2).max()
    group = _DIVISOR_GROUP[0]
    if group is not None:
        import torch.distributed as dist

        maxes = torch.stack([row, col]).detach()
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=group)
        row, col = maxes[0], maxes[1]
    return (row * col).detach()


def newton_schulz_pinv(a: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Approximate pseudo-inverse of ``a`` (shape ``(..., m, m)``), in float32."""
    orig_dtype = a.dtype
    a32 = a.float()
    z = a32.transpose(-1, -2) / _init_divisor(a32.abs())
    eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
    for _ in range(iters):
        az = a32 @ z
        inner = 7.0 * eye - az
        inner = 15.0 * eye - az @ inner
        inner = 13.0 * eye - az @ inner
        z = 0.25 * (z @ inner)
    return z.to(orig_dtype)
