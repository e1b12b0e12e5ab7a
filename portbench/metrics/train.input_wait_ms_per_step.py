"""Host time an optimizer step that the step waited for its next staged
batch (``data/pipeline.prefetch``'s consumer, the program's ``data.wait``
span), ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("data.wait")
    if not s or not ctx.work["steps"]:
        return None
    return s["host_s"] / ctx.work["steps"] * 1e3
