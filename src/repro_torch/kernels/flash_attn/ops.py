"""Dispatch for the flash-attention forward kernel (``csrc/flash_attn_fwd.cu``).

Takes the reference layout, q (B,Sq,H,hd) and k/v (B,Sk,Kv,hd); GQA is
resolved inside the kernel (kv head = h // (H // Kv)), so k and v are never
repeated in memory.  A CPU tensor takes the plain version in ``ref.py``; a
CUDA tensor launches the kernel or raises; a meta tensor (a dry run) gets
o and lse of their shapes and dtypes and launches nothing.  ``launches``
counts kernel launches; ``cost`` gives one launch's (FLOPs, bytes), which
each launch and each meta call reports to the active op counters
(``_build.record``)."""
from __future__ import annotations

import torch

import numpy as np

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import attention_ref

launches = 0

_FN = {torch.bfloat16: "flash_fwd_bf16", torch.float32: "flash_fwd_f32"}
MAX_HEAD_DIM = 128


def pairs(Sq: int, Sk: int, causal: bool, window=None, q_offset: int = 0,
          kv_offset: int = 0) -> int:
    """The (query, key) pairs the mask keeps: key position kp attends from
    query position qp where kp <= qp (causal) and qp - kp < window."""
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    lo = np.full(Sq, kv_offset, np.int64)
    hi = np.full(Sq, kv_offset + Sk - 1, np.int64)
    if causal:
        hi = np.minimum(hi, qp)
    if window is not None:
        lo = np.maximum(lo, qp - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(B: int, Sq: int, Sk: int, H: int, Kv: int, hd: int, dtype,
         causal: bool = True, window=None, q_offset: int = 0,
         kv_offset: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: 4 * hd FLOPs per kept (q, k) pair of
    each head (QK^T and PV); q, k and v read, o (q's shape and dtype) and
    the f32 lse written."""
    flops = 4.0 * B * H * hd * pairs(Sq, Sk, causal, window, q_offset,
                                     kv_offset)
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * Kv * hd) * dtype.itemsize \
        + B * H * Sq * 4
    return flops, float(nbytes)


def flash_fwd(q, k, v, causal: bool = True, window=None,
              q_offset: int = 0, kv_offset: int = 0):
    """-> (o (B,Sq,H,hd) in q's dtype, lse (B,H,Sq) f32)."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (B,S,H,hd)/(B,S,Kv,hd)")
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Kv:
        raise ValueError(f"flash_fwd: incompatible q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_fwd: window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window, q_offset, kv_offset)
    meta = q.device.type == "meta"
    if not meta:
        _build.check_device(q, "flash_fwd")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd kernel takes bf16 or f32 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd kernel takes hd <= {MAX_HEAD_DIM}, got {hd}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_fwd: q, k and v must lie on one card")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd kernel takes contiguous q, k and v")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if not meta:
        status = getattr(_build.load(), _FN[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Sq, Sk, H, Kv, hd, int(causal),
            -1 if window is None else int(window), int(q_offset),
            int(kv_offset), _build.stream_ptr(q))
        _build.check_status(status, "flash_fwd")
        launches += 1
    _build.record("flash_fwd", cost, B, Sq, Sk, H, Kv, hd, q.dtype, causal,
                  window, q_offset, kv_offset)
    return o, lse
