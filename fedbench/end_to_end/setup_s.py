"""From the process's start to the window's: imports, the trainer, the
weights, the kernels' build or load, and the rounds the comparison reads,
which warm up every shape the window runs."""


def read(ctx):
    return ctx.setup_s
