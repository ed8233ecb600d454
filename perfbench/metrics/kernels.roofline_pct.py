"""The forward's least time a request (the benchmark's own count at the
card's peaks) over the device time a request of every kernel the forward
launched in the traced sub-window, copies and memsets excluded, in %."""
from bench import count


def read(ctx):
    per = ctx.ms_per_request(ctx.trace.kernel_s()) if ctx.trace else None
    if not per:
        return None
    least_ms = count.least_s_per_request(ctx.config, ctx.batch) * 1e3
    return 100.0 * least_ms / per
