"""Multi-process parallelism (port of ``parallel/``): process groups and
meshes (``mesh``), the tile-parallel embed (``tile_parallel``),
sequence-parallel Nystrom attention (``sp_nystrom``) and tensor-parallel
TransMIL (``tp``)."""

from transmil_deepgraft_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    init_multihost,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
