"""The TransLayer kernels' share of their roofline in the slide path (K1/K2:
``csrc/translayer.cu`` and the landmark kernels of ``csrc/nystrom.cu``, run
once a slide by the head): the least time of K1 and K2 of both layers at
each slide's tokens, over the kernels' device time, %."""

from portbench.trace import is_port


def read(ctx):
    spent = ctx.trace.total_s(lambda name: is_port(name, "translayer") or is_port(name, "nystrom"))
    if spent <= 0 or not ctx.work["slides"]:
        return None
    return 100.0 * sum(ctx.costs.translayer_least_s(n) for n in ctx.work["slides"]) / spent
