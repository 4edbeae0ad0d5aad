"""Oracle for the SSD-form selective-SSM scan: the exact recurrence."""
from __future__ import annotations

from repro_torch.kernels.wkv6.ref import recurrent


def ssm_ref(C, Bk, x, w_log, s0=None):
    """SSD: h_t = a_t h_{t-1} + (dt B_t) x_t^T; y_t = C_t^T h_t.
    C/Bk: (B,T,H,N); x: (B,T,H,hd); w_log: (B,T,H,1) scalar-per-head decay.
    Returns (y, h_final)."""
    return recurrent(C, Bk, x, w_log, u=None, s0=s0)
