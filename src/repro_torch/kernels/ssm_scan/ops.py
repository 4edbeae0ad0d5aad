"""SSD-form selective-SSM scan: the WKV kernel (``csrc/wkv6.cu``) with
u=None (inclusive decay) and a per-head decay (B,T,H,1), which the kernel
reads without broadcasting it.  Hymba's SSM branch and RWKV6's WKV are the
same chunked decayed-linear-attention computation; its launches count in
``wkv6.ops.launches_ssd``."""
from __future__ import annotations

from repro_torch.kernels.wkv6.ops import DEFAULT_CHUNK, wkv


def ssm_scan(C, Bk, x, w_log, s0=None, chunk: int = DEFAULT_CHUNK):
    """C/Bk: (B,T,H,N); x: (B,T,H,hd); w_log: (B,T,H,1).
    Returns (y (B,T,H,hd) in x's dtype, h_final (B,H,N,hd) f32)."""
    return wkv(C, Bk, x, w_log, u=None, s0=s0, chunk=chunk)
