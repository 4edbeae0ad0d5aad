"""Device milliseconds a round of the kernels launched inside the
``fl/backward`` ranges (autograd's backward to the gradients, remat's
recompute included, one a client and local step), over the profiled
rounds."""


def read(ctx):
    _, dev_s, count = ctx.trace.range_totals("fl/backward")
    return 1e3 * dev_s / ctx.profiled_rounds if count and dev_s > 0 else None
