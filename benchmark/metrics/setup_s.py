"""setup_s: process start to the first timed call (imports, the kernels'
build or load, the inputs, the warm calls on every input)."""


def read(ctx):
    return ctx.setup_s
