"""The training step's share of the chip's peak: forward and backward,
counted as three forwards, of every bag of the window at the float rate,
over the traced window, %."""


def read(ctx):
    w, c = ctx.work, ctx.costs
    if not w["micro_steps"]:
        return None
    ops = 3 * w["micro_steps"] * w["batch"] * c.transmil_ops(w["bag"], w["in_features"])
    return 100.0 * c.ops_s(float_ops=ops) / ctx.trace.window_s
