"""Process groups, device meshes and batch sharding (port of ``parallel/mesh.py``).

The JAX package joins processes with ``jax.distributed`` and shards with a
``jax.sharding.Mesh`` over the chips; GSPMD inserts the collectives. Here it
is PyTorch's own idiom: one process per card, joined by
``torch.distributed`` (NCCL between cards, gloo on the CPU or wherever the
caller names it), a ``DeviceMesh`` with dims ``("dp", "sp")`` whose
sub-groups carry the explicit collectives, and each process holding its own
contiguous slice of the batch (:func:`shard_batch`).

``batch_sharding`` and ``replicated_sharding`` return :class:`Sharding`
descriptors: which mesh dim a batch dim is split over (``"dp"``) or none.
They mean what JAX's ``NamedSharding(mesh, P("dp"))`` and
``NamedSharding(mesh, P())`` mean; :func:`shard_batch` applies the first.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

_CLUSTER_VARS = ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "WORLD_SIZE")


def _cluster_env_detected() -> bool:
    """Does the environment look like a multi-process job (a launcher's
    world size above 1)?"""
    for var in _CLUSTER_VARS:
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def local_rank() -> int:
    """This process's index on its host: torchrun's ``LOCAL_RANK``, else its
    global rank, else 0."""
    for var in ("LOCAL_RANK", "RANK"):
        if var in os.environ:
            return int(os.environ[var])
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device() -> torch.device:
    """The card of this process (``cuda:LOCAL_RANK``), or the CPU without one."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> tuple[int, int]:
    """Join the process group; returns ``(rank, world)``.

    Explicit arguments (``coordinator_address`` as ``host:port`` or
    ``tcp://host:port``, ``num_processes``, ``process_id``) win; otherwise
    torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    are read (``env://``). A single-process run with nothing asked is a
    no-op, ``(0, 1)``; a second call returns the group already joined.

    As in JAX, a join that was asked for (an address, or more than one
    process), or whose cluster was detected (``SLURM_NTASKS``,
    ``OMPI_COMM_WORLD_SIZE``, ``PMI_SIZE`` or ``WORLD_SIZE`` above 1), raises
    when it fails: N processes never carry on as N independent jobs, each
    seeing the whole dataset.

    The backend is NCCL when the processes hold CUDA devices, gloo on the
    CPU, unless ``backend`` names one; NCCL with more ranks on a host than
    it has cards raises. Under NCCL the process's current device becomes
    ``cuda:LOCAL_RANK``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = bool(coordinator_address) or (num_processes or 1) > 1
    detected = _cluster_env_detected()
    if not explicit and not detected:
        return 0, 1  # a plain single-process run
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", -1))
    if rank < 0 or not (coordinator_address or "MASTER_ADDR" in os.environ):
        raise RuntimeError(
            "a multi-process join was requested or detected (world size "
            f"{world}) but this process has no rank or coordinator: launch with torchrun "
            "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or pass coordinator_address, "
            "num_processes and process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        lr = int(os.environ.get("LOCAL_RANK", rank))
        if lr >= cards:
            raise RuntimeError(
                f"NCCL takes one card a process: local rank {lr} of world {world} on a host "
                f"with {cards} card(s); launch at most {cards} processes a host, or pass "
                "backend='gloo'")
        torch.cuda.set_device(lr)
    if coordinator_address:
        addr = coordinator_address
        init_method = addr if "://" in addr else f"tcp://{addr}"
    else:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(dp: Optional[int] = None, sp: int = 1, *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every process with dims ``("dp", "sp")``;
    default all of them on ``dp``. Ranks fill it row-major: the ``sp`` group
    of a rank is its contiguous run of ``sp`` ranks. Every process must call
    it (its sub-groups are created collectively). ``device_type`` defaults
    to ``"cuda"`` where a card is present."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) != device count ({n})")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return init_device_mesh(device_type, (dp, sp), mesh_dim_names=("dp", "sp"))


def axis_size(mesh, axis: str) -> int:
    """The size of a mesh dim (1 for no mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This process's index along a mesh dim (0 for no mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


class Sharding(NamedTuple):
    """Where the leading (batch) dim of an array lives: split contiguously
    over mesh dim ``axis``, or on every process (``axis`` None)."""

    mesh: Any
    axis: Optional[str]


def batch_sharding(mesh) -> Sharding:
    """Shard the leading (batch) dim over dp, replicate the rest."""
    return Sharding(mesh, "dp")


def replicated_sharding(mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_rows(x, parts: int, index: int):
    """Rows ``[n*index//parts, n*(index+1)//parts)`` of ``x`` when ``parts``
    divides its length n; raises otherwise, as a sharded ``device_put``
    does."""
    n = x.shape[0]
    if n % parts:
        raise ValueError(f"a batch of {n} does not split evenly over {parts} shards")
    step = n // parts
    return x[index * step:(index + 1) * step]


def shard_batch(batch: Any, mesh, device: Optional[torch.device] = None) -> Any:
    """This process's contiguous 1/dp slice of every array's batch dim, as
    tensors on ``device`` (default :func:`rank_device`). ``batch`` is an
    array, a tensor, or a list, tuple or dict of them (other leaves pass
    through), as JAX maps ``device_put`` over a pytree."""
    device = device or rank_device()
    spec = batch_sharding(mesh)
    parts, index = axis_size(mesh, spec.axis), axis_rank(mesh, spec.axis)

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if torch.is_tensor(x):
            return shard_rows(x, parts, index).to(device)
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return x

    return put(batch)
