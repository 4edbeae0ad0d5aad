"""Device milliseconds a round of the kernels whose innermost range is
``fl/attention`` (``innermost``): the attention block, from the first
norm's output through the output projection, in the forward, the backward
and remat's recompute, over the profiled rounds."""
from fedbench.metrics import innermost


def read(ctx):
    return innermost.block_ms(ctx, "fl/attention")
