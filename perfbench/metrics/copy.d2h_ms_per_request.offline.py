"""Device time of the device-to-host copies (a batch's answers, copied
back before they are handed to the clients) a completed request, in ms."""


def read(ctx):
    return ctx.ms_per_request(ctx.trace.class_s("copy_d2h")) if ctx.trace \
        else None
