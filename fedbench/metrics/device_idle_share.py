"""The share of the profiled rounds' wall time in which no kernel or copy
ran on the device, in %."""


def read(ctx):
    win = ctx.trace.window_s()
    return 100.0 * (1.0 - ctx.trace.busy_s() / win) if win > 0 else None
