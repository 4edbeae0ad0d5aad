"""The round's model FLOPs (``flops.model_flops_per_token`` x the tokens
of a round: K x batch x sequence x local steps) over the bf16 peak, as a
share of the device time of the local step's phases, ``forward_ms`` +
``backward_ms``, in %.  Recompute and padding are not counted as work."""
from fedbench import flops
from fedbench.metrics import backward_ms, forward_ms


def read(ctx):
    fwd, bwd = forward_ms.read(ctx), backward_ms.read(ctx)
    if fwd is None or bwd is None:
        return None
    tr = ctx.traffic
    tokens = ctx.sizes["clients"] * tr["batch_per_client"] * tr["seq_len"] \
        * tr["local_steps"]
    need_s = flops.model_flops_per_token(ctx.sizes, tr["seq_len"]) \
        * tokens / flops.PEAK_FLOPS_BF16
    return 100.0 * need_s / ((fwd + bwd) / 1e3)
