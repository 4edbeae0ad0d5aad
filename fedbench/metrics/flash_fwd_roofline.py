"""The attention forward kernel's share of its roofline: each launch's
least time (``flops.flash_fwd_cost`` from the cell's shapes) times the
launches, over the kernel's device time in the profiled rounds."""
from fedbench import flops

KERNEL = "flash_fwd"


def read(ctx):
    hits = [v for name, v in ctx.trace.kernel_totals().items()
            if KERNEL in name]
    secs, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches or secs <= 0:
        return None
    cost = flops.flash_fwd_cost(ctx.sizes, ctx.traffic["batch_per_client"],
                                ctx.traffic["seq_len"])
    return 100.0 * flops.bound_s(*cost) * launches / secs
