"""The forward's least time a request over the device time a request of
the GEMM kernel (``rir_matmul`` and its split-K reduce: the 'gemm' class of
kernel_classes.json), in %.  The GEMM does all of the forward's
multiply-adds, so the forward's least time bounds it."""
from bench import count


def read(ctx):
    per = ctx.ms_per_request(ctx.trace.class_s("gemm")) if ctx.trace \
        else None
    if not per:
        return None
    least_ms = count.least_s_per_request(ctx.config, ctx.batch) * 1e3
    return 100.0 * least_ms / per
