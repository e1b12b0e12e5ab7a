"""Host time a chunk that ``inference.embed_chunk``'s host-to-device copy of
the chunk's tiles holds the thread (the program's ``slide.copy`` span over
its calls), ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("slide.copy")
    if not s or not s["calls"]:
        return None
    return s["host_s"] / s["calls"] * 1e3
