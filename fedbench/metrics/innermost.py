"""The innermost-range rule of the local step's readers: a kernel of the
profiled rounds belongs to the one program range open at its launch that
opened last (``Trace._open_range``, the rule the idle breakdown uses).

The round step's phases (``fl/forward``, ``fl/backward``) hold the
decoder's blocks (``fl/attention``, ``fl/ffn``, ``fl/head``); under remat a
block's backward holds the forward ranges of the layer's recompute, which
it sets off.  The backward's blocks are ranges on autograd's thread while
the calling thread waits inside ``fl/backward``, so the range that opened
last is the innermost on either thread."""
from collections import defaultdict

OUTSIDE = "outside any range"


def device_s(trace) -> dict:
    """{range name: device seconds of the kernels whose innermost range it
    is}; kernels launched outside every range are left out."""
    out = defaultdict(float)
    for _, s, e, at in trace.kernels:
        if at is not None:
            out[trace._open_range(at)] += e - s
    out.pop(OUTSIDE, None)
    return dict(out)


def block_ms(ctx, name: str):
    """Device milliseconds a round whose innermost range is ``name``, over
    the profiled rounds; None where no kernel has it."""
    secs = device_s(ctx.trace).get(name)
    return 1e3 * secs / ctx.profiled_rounds if secs else None
