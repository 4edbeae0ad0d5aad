"""The bytes a round's aggregation needs (``flops.aggregate_bytes``: the K
slots read and the mean written, and under ``compressed`` the int8
payloads and row scales written and read) over the HBM rate, as a share
of ``aggregate_ms``."""
from fedbench import flops
from fedbench.metrics import aggregate_ms


def read(ctx):
    ms = aggregate_ms.read(ctx)
    if not ms:
        return None
    need_s = flops.aggregate_bytes(ctx.sizes, ctx.traffic["schedule"]) \
        / flops.HBM_BYTES_PER_S
    return 100.0 * need_s / (ms / 1e3)
