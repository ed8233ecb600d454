"""Device time of the host-to-device copies (the assembled batch's one
copy) a completed request, in ms."""


def read(ctx):
    return ctx.ms_per_request(ctx.trace.class_s("copy_h2d")) if ctx.trace \
        else None
