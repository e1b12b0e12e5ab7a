"""Stream time a chunk of the ViT blocks' MLP branches (``models/vit.
ViTBlock``: norm2, fc1, SiLU times the second half, fc2, ls2 and the
residual add; the program's ``vit.mlp`` span, every block) over the
window's chunks, ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("vit.mlp")
    chunks = sum(-(-n // ctx.work["chunk"]) for n in ctx.work["slides"])
    if not s or not chunks:
        return None
    return s["device_s"] / chunks * 1e3
