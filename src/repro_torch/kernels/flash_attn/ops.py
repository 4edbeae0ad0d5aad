"""Dispatch for the flash-attention forward kernel (``csrc/flash_attn_fwd.cu``).

Takes the reference layout, q (B,Sq,H,hd) and k/v (B,Sk,Kv,hd); GQA is
resolved inside the kernel (kv head = h // (H // Kv)), so k and v are never
repeated in memory.  A CPU tensor takes the plain version in ``ref.py``; a
CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import attention_ref

launches = 0

_FN = {torch.bfloat16: "flash_fwd_bf16", torch.float32: "flash_fwd_f32"}
MAX_HEAD_DIM = 128


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
    status = getattr(_build.load(), _FN[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, H, Kv, hd, int(causal), -1 if window is None else int(window),
        int(q_offset), int(kv_offset), _build.stream_ptr(q))
    _build.check_status(status, "flash_fwd")
    launches += 1
    return o, lse
