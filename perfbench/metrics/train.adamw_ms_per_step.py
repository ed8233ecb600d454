"""Device time under the program's ``adamw.update`` range (clipping and
the update of every leaf) a training step of the traced sub-window, in
ms."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.range_s("adamw.update")
    return ctx.ms_per_step(s) if s > 0 else None
