"""Device time an optimizer step of kernels that are neither the port's own
nor copies: the model's torch ops, the pinv, the analytic backward and the
optimizer's update, ms."""

from portbench.trace import is_torch_op


def read(ctx):
    if not ctx.work["steps"]:
        return None
    return ctx.trace.total_s(is_torch_op) / ctx.work["steps"] * 1e3
