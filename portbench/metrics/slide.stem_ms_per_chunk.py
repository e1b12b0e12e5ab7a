"""Stream time a chunk of the int8 backbone's stem (``models/resnet_int8.
_stem_q``: quantize, space-to-depth, the float64 stem convolution, requant,
max-pool), from the program's ``backbone.stem`` span over its calls, ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("backbone.stem")
    if not s or not s["calls"]:
        return None
    return s["device_s"] / s["calls"] * 1e3
