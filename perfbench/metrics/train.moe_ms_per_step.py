"""Device time under the program's ``moe.experts`` range (the held-expert
block's routing, sort, grouped products and combine, in the forward and
in its recompute, and each grouped product's backward; the backward of
the gather, the activation and the combine runs outside it) a training
step of the traced sub-window, in ms."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.range_s("moe.experts")
    return ctx.ms_per_step(s) if s > 0 else None
