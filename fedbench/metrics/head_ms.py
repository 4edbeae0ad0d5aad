"""Device milliseconds a round of the kernels whose innermost range is
``fl/head`` (``innermost``): the final norm's output through the logits to
the cross-entropy, in the forward and the backward, over the profiled
rounds."""
from fedbench.metrics import innermost


def read(ctx):
    return innermost.block_ms(ctx, "fl/head")
