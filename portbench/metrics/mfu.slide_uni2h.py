"""The UNI2-h slide path's share of the chip's peak: the window's real
tiles through the ViT (``costs/vit.vit_tile_ops``) and TransMIL on each
slide's 1536-d features (``costs/vit.transmil_ops``), at the float rate,
over the traced window, %."""

from portbench.costs import vit


def read(ctx):
    w, c = ctx.work, ctx.costs
    if not w.get("slides") or "backbone" not in w:
        return None
    flt = sum(w["slides"]) * vit.vit_tile_ops(w["hw"], **w["backbone"]) \
        + sum(vit.transmil_ops(n, w["in_features"]) for n in w["slides"])
    return 100.0 * c.ops_s(float_ops=flt) / ctx.trace.window_s
