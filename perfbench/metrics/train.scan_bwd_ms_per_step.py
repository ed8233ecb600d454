"""Device time under the program's ``linear_scan.backward`` range (the
scan's backward: recomputed through the plain chunked scan under
autograd) a training step of the traced sub-window, in ms."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.range_s("linear_scan.backward")
    return ctx.ms_per_step(s) if s > 0 else None
