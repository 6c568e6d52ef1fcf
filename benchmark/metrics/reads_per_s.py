"""reads_per_s: reads mapped in the window over the window's seconds."""


def read(ctx):
    return ctx.work("reads") / ctx.window_s
