"""Stream time an optimizer step of the backward (``loss.backward()``:
autograd and the analytic Nystrom backward, the pinv's recompute in it),
from the program's ``train.backward`` span, ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("train.backward")
    if not s or not ctx.work["steps"]:
        return None
    return s["device_s"] / ctx.work["steps"] * 1e3
