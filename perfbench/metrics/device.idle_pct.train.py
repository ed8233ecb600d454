"""Share of the traced training steps in which no kernel, copy or memset
ran on the device (the union of their intervals, not their sum) over
those steps' own seconds, in %: a reading of the trace alone.  The traced
steps are whole steps of the run's loop, taken right after the measured
window; at this cell's size the card paces them, traced or not."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
