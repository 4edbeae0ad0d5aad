"""The bytes a round's optimizer steps need (``flops.optimizer_bytes``)
over the HBM rate, as a share of the device time under ``fl/optimizer``."""
from fedbench import flops
from fedbench.metrics import optimizer_ms


def read(ctx):
    ms = optimizer_ms.read(ctx)
    if not ms:
        return None
    need_s = flops.optimizer_bytes(ctx.sizes) / flops.HBM_BYTES_PER_S
    return 100.0 * need_s / (ms / 1e3)
