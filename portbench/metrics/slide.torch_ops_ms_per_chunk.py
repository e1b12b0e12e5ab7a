"""Device time a chunk of kernels that are neither the port's own
(``csrc/*.cu``) nor copies: the int8 backbone's stem, quantization and pool
and the head's library calls, ms."""

from portbench.trace import is_torch_op


def read(ctx):
    chunks = sum(-(-n // ctx.work["chunk"]) for n in ctx.work["slides"])
    if not chunks:
        return None
    return ctx.trace.total_s(is_torch_op) / chunks * 1e3
