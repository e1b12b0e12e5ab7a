"""The landmark kernels' share of their roofline in training
(``csrc/nystrom.cu``, B5/B6): the least time of one B5 and one B6 a
TransLayer and micro-step at the batch's landmark-padded length, over the
kernels' device time, %."""

from portbench.trace import is_port


def read(ctx):
    w, c = ctx.work, ctx.costs
    spent = ctx.trace.total_s(lambda name: is_port(name, "nystrom"))
    if spent <= 0 or not w["micro_steps"]:
        return None
    _, np_ = c.transmil_tokens(w["bag"])
    return 100.0 * w["micro_steps"] * 2 * c.nystrom_least_s(w["batch"], np_) / spent
