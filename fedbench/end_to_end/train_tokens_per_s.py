"""Tokens the window's rounds trained (K x batch x sequence x local steps
a round) over the window's wall time, which ends in a synchronize."""


def read(ctx):
    return ctx.tokens / ctx.window_s
