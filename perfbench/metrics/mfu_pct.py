"""The whole forward's share of the card's peak: the FLOPs a request needs
(the benchmark's own count) times the requests completed in the traced
sub-window, over its seconds at the peak rate of peaks.json, in %."""
from bench import count


def read(ctx):
    if ctx.trace is None or not ctx.trace.requests or \
            ctx.trace.window_s <= 0:
        return None
    flops = count.flops_per_request(ctx.config) * ctx.trace.requests
    return 100.0 * flops / (ctx.trace.window_s * count.peaks()["flops_per_s"])
