"""Tile-parallel slide embedding: the tile batch split over processes (port
of ``parallel/tile_parallel.py``).

Tiles are independent, so the embed stage splits over the mesh's ``dp``
processes: the (N, H, W, 3) batch is zero-padded to a multiple of dp, each
process embeds its contiguous shard with the same backbone (the int8
ResNet50, ~25 MB, on every card) and the (N, D) features are either
all-gathered to every process (one collective of N*D*4 bytes) or left
sharded. Per-tile arithmetic does not depend on the split, so the result is
bit-identical to one process's embed.

JAX writes this as sharding annotations on a ``jit``; here each process
slices its shard and the gather is an explicit ``all_gather`` (its list
form, which gloo also runs on CUDA tensors).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank, axis_size


def pad_to_multiple(tiles, k: int) -> tuple[Any, int]:
    """Zero-pad the batch dim up to a multiple of ``k``; returns (padded, n).
    numpy stays numpy, a tensor stays a tensor."""
    n = tiles.shape[0]
    pad = (-n) % k
    if pad:
        if torch.is_tensor(tiles):
            tiles = torch.cat([tiles, tiles.new_zeros((pad, *tiles.shape[1:]))])
        else:
            tiles = np.concatenate([tiles, np.zeros((pad, *tiles.shape[1:]), tiles.dtype)])
    return tiles, n


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's (n_r, ...) tensors, equal in shape, concatenated in rank
    order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def make_tile_parallel_embed(
    embed_fn: Callable[[Any, Any], torch.Tensor],
    mesh,
    *,
    axis: str = "dp",
    gather: bool = True,
) -> Callable[[Any, Any], torch.Tensor]:
    """``embed_fn(static, tiles) -> features`` with the tiles split over mesh
    dim ``axis``: the returned ``run(static, tiles)`` (every process passes
    the whole batch, numpy or a tensor) pads it to a multiple of the dim's
    size, embeds this process's contiguous shard, and with ``gather=True``
    returns the whole (N, D) features on every process, padding stripped;
    with ``gather=False`` this process's shard of the padded batch."""
    shards, index = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = mesh.get_group(axis)

    def run(static: Any, tiles: Any) -> torch.Tensor:
        padded, n = pad_to_multiple(tiles, shards)
        step = padded.shape[0] // shards
        feats = embed_fn(static, padded[index * step:(index + 1) * step])
        if not gather:
            return feats
        return gather_rows(feats, group)[:n]

    return run


# One runner per (embed_fn, mesh, axis), as JAX keeps its jitted runners: a
# bounded LRU, so a caller that makes a new function for every slide does not
# pin each runner (and the weights it captures) for ever.
_RUN_CACHE_MAX = 8
_RUN_CACHE: dict = {}  # insertion-ordered; re-inserted on a hit


def tile_parallel_slide_embed(
    embed_fn: Callable[[Any, Any], torch.Tensor],
    static: Any,
    tiles: Any,
    mesh,
    *,
    chunk: Optional[int] = None,
    axis: str = "dp",
) -> torch.Tensor:
    """One slide's tiles embedded over the mesh, in fixed steps of ``chunk *
    axis size`` tiles when ``chunk`` is given (each process embeds ``chunk``
    a step, the serving pattern of ``SlideInferencePipeline``). Returns the
    whole (N, D) features on every process."""
    shards = axis_size(mesh, axis)
    key = (embed_fn, mesh, axis)
    run = _RUN_CACHE.pop(key, None)
    if run is None:
        run = make_tile_parallel_embed(embed_fn, mesh, axis=axis)
        while len(_RUN_CACHE) >= _RUN_CACHE_MAX:
            _RUN_CACHE.pop(next(iter(_RUN_CACHE)))
    _RUN_CACHE[key] = run  # (re-)inserted at the end: LRU order
    if chunk is None:
        return run(static, tiles)
    step = chunk * shards
    padded, n = pad_to_multiple(tiles, step)
    outs = [run(static, padded[i:i + step]) for i in range(0, padded.shape[0], step)]
    return torch.cat(outs)[:n]
