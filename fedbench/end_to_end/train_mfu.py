"""The window's model FLOPs (``flops.model_flops_per_token`` a token)
over the window's wall time times the chips' bf16 peak, in %."""
from fedbench import flops


def read(ctx):
    work = flops.model_flops_per_token(ctx.sizes, ctx.traffic["seq_len"]) \
        * ctx.tokens
    return 100.0 * work / (ctx.window_s * flops.PEAK_FLOPS_BF16 * ctx.chips)
