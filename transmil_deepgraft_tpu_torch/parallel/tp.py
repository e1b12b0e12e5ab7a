"""Tensor parallelism for the TransMIL head (port of ``parallel/tp.py``).

Megatron-style column and row parallelism over a ``tp`` mesh dim, as the
JAX package's ``PartitionSpec``s declare it (there GSPMD inserts the
collectives; here they are written out):

  to_qkv kernel, flax (d, 3*inner)  -> P(None, 'tp')  column parallel
  to_out kernel, flax (inner, d)    -> P('tp', None)  row parallel
  everything else                   -> P()            replicated

A torch ``Linear`` keeps the transposed (out, in) weight, so the column
split is dim 0 of ``to_qkv.weight`` and the row split dim 1 of
``to_out.0.weight``. :func:`tp_shard` keeps each process's blocks of those
two weights. Its ``to_qkv`` all-gathers its columns before the attention,
which then runs whole on every process of the group (the value residual
conv included); its ``to_out`` takes this process's rows of the input, and
the products are summed (``all_reduce``) with the bias added once.

The collectives are autograd functions in Megatron's pairing, so the
gradients land on the shards and every replicated parameter gets the whole
gradient on every process: the input of ``to_qkv`` passes unchanged forward
and is summed backward (each process's columns give part of its gradient);
the gather of the columns takes this process's slice of the (whole,
identical) gradient backward; the slice taken before ``to_out`` gathers the
slices' gradients backward, so the attention's backward sees the whole
gradient; the row-parallel sum passes it unchanged backward.
``torch.distributed.nn.functional``'s collectives pair otherwise (its
``all_reduce`` sums again in its backward, which would count the replicated
gradient once per process; its ``all_gather`` backward is a reduce-scatter,
through ``alltoall`` on gloo, which gloo lacks for CUDA tensors), so these
four are written on ``all_reduce`` and ``all_gather`` alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank, axis_size

def transmil_tp_specs(model: nn.Module, axis: str = "tp") -> dict[str, tuple]:
    """Parameter name -> JAX's ``PartitionSpec`` for it, as a tuple in the
    flax layout: ``(None, axis)`` for the ``to_qkv`` kernels, ``(axis,
    None)`` for the ``to_out`` kernels, ``()`` (replicated) for the rest."""

    def spec(name: str) -> tuple:
        parts = name.split(".")
        if "to_qkv" in parts and parts[-1] == "weight":
            return (None, axis)
        if "to_out" in parts and parts[-1] == "weight":
            return (axis, None)
        return ()

    return {name: spec(name) for name, _ in model.named_parameters()}


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _own_block(x: torch.Tensor, group) -> torch.Tensor:
    w = x.shape[-1] // dist.get_world_size(group)
    r = dist.get_rank(group)
    return x[..., r * w:(r + 1) * w].contiguous()


class _GatherLastDim(torch.autograd.Function):
    """The group's blocks concatenated along the last dim forward; this
    process's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.group), None


class _SplitLastDim(torch.autograd.Function):
    """This process's block of the last dim forward; the blocks' gradients
    gathered backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_block(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


class _SumOverGroup(torch.autograd.Function):
    """The group's sum forward; the gradient unchanged backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelLinear(nn.Module):
    """A bias-free ``Linear`` whose output features are split over the
    group: this process keeps ``weight`` rows ``[r*o/T, (r+1)*o/T)`` and the
    forward returns the gathered, whole output."""

    def __init__(self, full: nn.Linear, group, rank: int, size: int) -> None:
        super().__init__()
        if full.bias is not None:
            raise ValueError("the column-parallel to_qkv takes no bias (TransMIL's has none)")
        out = full.weight.shape[0]
        if out % size:
            raise ValueError(f"{out} output features do not split over tp={size}")
        step = out // size
        self.weight = nn.Parameter(full.weight.detach()[rank * step:(rank + 1) * step].clone())
        self.compute_dtype = getattr(full, "compute_dtype", torch.float32)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToGroup.apply(x, self.group)
        dt = self.compute_dtype
        y = F.linear(x.to(dt) if dt != torch.float32 else x.float(), self.weight.to(dt))
        return _GatherLastDim.apply(y, self.group)


class RowParallelLinear(nn.Module):
    """A ``Linear`` whose input features are split over the group: this
    process keeps ``weight`` columns ``[r*i/T, (r+1)*i/T)`` and multiplies
    its slice of the input; the products are summed over the group and the
    (replicated) bias added once."""

    def __init__(self, full: nn.Linear, group, rank: int, size: int) -> None:
        super().__init__()
        width = full.weight.shape[1]
        if width % size:
            raise ValueError(f"{width} input features do not split over tp={size}")
        step = width // size
        self.weight = nn.Parameter(full.weight.detach()[:, rank * step:(rank + 1) * step].clone())
        self.bias = None if full.bias is None else nn.Parameter(full.bias.detach().clone())
        self.compute_dtype = getattr(full, "compute_dtype", torch.float32)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = _SplitLastDim.apply(x, self.group)
        y = F.linear(x.to(dt) if dt != torch.float32 else x.float(), self.weight.to(dt))
        y = _SumOverGroup.apply(y, self.group)
        return y if self.bias is None else y + self.bias.to(dt)


def tp_shard(model: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """Split ``model``'s Nystrom attention projections over mesh dim
    ``axis`` in place and return it: every ``to_qkv`` becomes a
    :class:`ColumnParallelLinear`, every ``to_out``'s Linear a
    :class:`RowParallelLinear`, holding this process's block. Parameter
    names are kept (``...to_qkv.weight``, ``...to_out.0.weight``/``bias``).
    The fused K1/K2 inference route reads whole weights, so it is turned
    off: the sharded model runs the standard layers (the fused landmark
    kernels under ``use_pallas``). With the batch split over a ``dp`` dim
    too, run the forward and backward inside
    ``ops.pinv.divisor_reduced_over(mesh.get_group("dp"))``, as the
    Trainer's train step does, so that the Newton-Schulz divisor is the
    global batch's (the analytic backward recomputes it)."""
    from transmil_deepgraft_tpu_torch.models.layers import NystromAttentionLayer

    group, rank, size = mesh.get_group(axis), axis_rank(mesh, axis), axis_size(mesh, axis)
    for module in model.modules():
        if isinstance(module, NystromAttentionLayer):
            module.to_qkv = ColumnParallelLinear(module.to_qkv, group, rank, size)
            module.to_out[0] = RowParallelLinear(module.to_out[0], group, rank, size)
    if hasattr(model, "fused_inference"):
        model.fused_inference = False
    return model
