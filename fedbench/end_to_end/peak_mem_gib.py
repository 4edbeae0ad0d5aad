"""The largest ``torch.cuda.max_memory_allocated()`` of any card over the
program's whole run, set-up included, read before the reference runs."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
