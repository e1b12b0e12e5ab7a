"""Stream time a chunk of the ViT blocks' attention branches (``models/vit.
ViTBlock``: norm1, qkv, SDPA, proj, ls1 and the residual add; the program's
``vit.attn`` span, every block) over the window's chunks, ms."""

from transmil_deepgraft_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s = spans.get("vit.attn")
    chunks = sum(-(-n // ctx.work["chunk"]) for n in ctx.work["slides"])
    if not s or not chunks:
        return None
    return s["device_s"] / chunks * 1e3
