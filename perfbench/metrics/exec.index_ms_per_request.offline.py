"""Device time of the executor's index kernels (gathers, scatters,
concatenations, block permutations: the 'index' class of
kernel_classes.json) a completed request, in ms."""


def read(ctx):
    return ctx.ms_per_request(ctx.trace.class_s("index")) if ctx.trace \
        else None
