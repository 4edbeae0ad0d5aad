"""Device milliseconds a round of the kernels launched inside the
``fl/optimizer`` ranges (one a client and local step), over the profiled
rounds."""


def read(ctx):
    _, dev_s, count = ctx.trace.range_totals("fl/optimizer")
    return 1e3 * dev_s / ctx.profiled_rounds if count and dev_s > 0 else None
