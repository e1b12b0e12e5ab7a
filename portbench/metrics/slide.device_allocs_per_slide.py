"""Device allocations (``cudaMalloc`` calls of the caching allocator) a
slide of ``SlideInferencePipeline.predict_slide``, from the program's
``slide.device_allocs`` counter over the window's slides."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    counters = profiling.snapshot()["counters"] if hasattr(profiling, "snapshot") else {}
    n = counters.get("slide.device_allocs")
    if n is None or not ctx.work["slides"]:
        return None
    return n / len(ctx.work["slides"])
