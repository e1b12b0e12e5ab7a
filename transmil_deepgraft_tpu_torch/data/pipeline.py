"""Host-side input pipeline: a background prefetch thread and host-to-device
copies that overlap compute (port of ``data/pipeline.py``; the reference's
DALI pipeline, ``datasets/dali_dataloader.py:26-255``).

A daemon thread produces the next batches while the device computes
(:func:`prefetch`); :func:`device_prefetch` also copies each batch's arrays
to the device on that thread, from pinned host memory with ``non_blocking``
copies on a side CUDA stream, and the consumer's stream waits for the copy
before it uses the tensors. :func:`shard_for_host` gives each process its
contiguous range of items, as DALI's slide-range shard (``:76-78``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch


def shard_for_host(items: Sequence[Any], host_id: int | None = None,
                   n_hosts: int | None = None) -> Sequence[Any]:
    """The contiguous range ``items[n*id//hosts : n*(id+1)//hosts]`` of this
    process (default: its ``torch.distributed`` rank and world size, else
    the only one)."""
    import torch.distributed as dist

    ready = dist.is_available() and dist.is_initialized()
    host_id = (dist.get_rank() if ready else 0) if host_id is None else host_id
    n_hosts = (dist.get_world_size() if ready else 1) if n_hosts is None else n_hosts
    n = len(items)
    return items[n * host_id // n_hosts:n * (host_id + 1) // n_hosts]


def prefetch(iterator: Iterable[Any], size: int = 2,
             transform: Callable[[Any], Any] | None = None) -> Iterator[Any]:
    """Run ``iterator`` (and ``transform`` on each item) in a daemon thread,
    keeping up to ``size`` items ready. An exception in the thread is raised
    in the consumer; a consumer that stops early releases the thread."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()  # the consumer is gone
    err: list[BaseException] = []

    def _put(item) -> bool:
        """A put that gives up once the consumer is gone, so that an
        abandoned generator does not pin the thread (and the batches it
        staged) on a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in iterator:
                if transform is not None:
                    item = transform(item)
                if not _put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def to_device(arrays: Sequence[np.ndarray | None], device: torch.device,
              stream: torch.cuda.Stream | None = None) -> tuple:
    """numpy arrays (or None) -> tensors on ``device``. With a CUDA
    ``stream``, each array is pinned and copied ``non_blocking`` on it."""
    if stream is None:
        return tuple(None if a is None else torch.from_numpy(a).to(device) for a in arrays)
    with torch.cuda.stream(stream):
        return tuple(None if a is None else torch.from_numpy(a).pin_memory().to(
            device, non_blocking=True) for a in arrays)


def device_prefetch(batches: Iterable[Any], device: torch.device,
                    arrays: Callable[[Any], Sequence[np.ndarray | None]],
                    size: int = 2, mesh=None) -> Iterator[tuple]:
    """Prefetch ``batches`` on a thread that also copies ``arrays(batch)`` to
    ``device``; yields ``(batch, *tensors)``. On a CUDA device the copies run
    on a side stream from pinned memory, and the current stream waits for
    them before the batch is yielded. With a ``mesh`` (``parallel.mesh``)
    each array is first cut to this process's contiguous 1/dp slice of its
    batch dim, as JAX's ``shard_batch`` places it."""
    if mesh is not None:
        from transmil_deepgraft_tpu_torch.parallel.mesh import axis_rank, axis_size, shard_rows

        whole, parts, index = arrays, axis_size(mesh, "dp"), axis_rank(mesh, "dp")
        arrays = lambda b: tuple(None if a is None else shard_rows(a, parts, index)  # noqa: E731
                                 for a in whole(b))
    if device.type != "cuda":
        return prefetch(batches, size, lambda b: (b, *to_device(arrays(b), device)))
    stream = torch.cuda.Stream(device)

    def stage(b):
        tensors = to_device(arrays(b), device, stream)
        done = torch.cuda.Event()
        done.record(stream)
        return b, tensors, done

    def consume():
        for b, tensors, done in prefetch(batches, size, stage):
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for t in tensors:
                if t is not None:  # memory the side stream allocated, used on this one
                    t.record_stream(current)
            yield (b, *tensors)

    return consume()
