"""Host milliseconds a round inside the trainer's ``train/batch`` range
(the data layer's batch), over the profiled rounds."""


def read(ctx):
    host_s, _, count = ctx.trace.range_totals("train/batch")
    return 1e3 * host_s / ctx.profiled_rounds if count else None
