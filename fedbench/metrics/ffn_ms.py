"""Device milliseconds a round of the kernels whose innermost range is
``fl/ffn`` (``innermost``): the feed-forward block, the SwiGLU MLP or the
MoE layer (router, dispatch, expert products, combine), in the forward,
the backward and remat's recompute, over the profiled rounds."""
from fedbench.metrics import innermost


def read(ctx):
    return innermost.block_ms(ctx, "fl/ffn")
