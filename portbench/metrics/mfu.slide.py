"""The whole slide's share of the chip's peak: the least time of the
window's tiles (the int8 ResNet50 at the int8 rate, TransMIL at the float
rate) over the traced window, %."""


def read(ctx):
    w, c = ctx.work, ctx.costs
    if not w["slides"]:
        return None
    int8 = sum(w["slides"]) * c.r50_tile_ops(w["hw"])
    flt = sum(c.transmil_ops(n, w["in_features"]) for n in w["slides"])
    return 100.0 * c.ops_s(int8, flt) / ctx.trace.window_s
