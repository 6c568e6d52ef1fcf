"""gcups: the sum of Q x T over the pairs completed in the window, over the
window's seconds, in 1e9 cells a second: whole-pair DP accounting, as
edlib_tpu_torch.utils.profiling.gcups counts it."""


def read(ctx):
    return ctx.work("cells") / ctx.window_s / 1e9
