"""Device time of host-to-device copies a chunk of the slide pipeline
(``inference.embed_chunk`` ships each chunk's uint8 tiles), ms."""

from portbench.trace import is_copy


def read(ctx):
    chunks = sum(-(-n // ctx.work["chunk"]) for n in ctx.work["slides"])
    if not chunks:
        return None
    return ctx.trace.total_s(lambda name: is_copy(name, "HtoD")) / chunks * 1e3
