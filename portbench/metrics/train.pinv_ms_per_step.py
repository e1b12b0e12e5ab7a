"""Stream time an optimizer step of the forward's Newton-Schulz pinvs
(``ops/pinv.newton_schulz_pinv``, the program's ``pinv`` span; the
backward's recompute is not in it), ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("pinv")
    if not s or not ctx.work["steps"]:
        return None
    return s["device_s"] / ctx.work["steps"] * 1e3
