"""The int8 stage kernels' share of their roofline (``csrc/qstage.cu``,
B7/B8): the least time of every chunk's stage 1 and entry and interior
segments of stages 2-4 on its real tiles, over the kernels' device time, %."""

from portbench.trace import is_port


def read(ctx):
    w, c = ctx.work, ctx.costs
    spent = ctx.trace.total_s(lambda name: is_port(name, "qstage"))
    if spent <= 0:
        return None
    least = sum(c.qstage_least_s(min(w["chunk"], n - s), w["hw"])
                for n in w["slides"] for s in range(0, n, w["chunk"]))
    return 100.0 * least / spent
