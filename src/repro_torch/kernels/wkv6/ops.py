"""Dispatch for the chunked WKV kernel (``csrc/wkv6.cu``), the port of the
JAX package's ``kernels/wkv6/ops.wkv`` over ``wkv_pallas``.

Takes the reference layout, r/k (B,T,H,dk), v (B,T,H,dv), w_log
broadcastable to r (per channel, or (B,T,H,1) per head), u (H,dk) or None,
s0 (B,H,dk,dv) or None.  The kernel reads that layout in place, so nothing
is transposed to (B·H, T, d) as the reference does for Pallas; a per-head
decay is read as one value per (b, t, h), not broadcast in memory.  A
ragged T is padded with k = 0 and w_log = 0.  The kernel's chunk-start
states and flags live in a scratch allocated here (its size from
``scratch_floats``, which the kernel checks).  A CPU tensor
takes the plain version (``ref.chunked``); a CUDA tensor launches the
kernel or raises; a meta tensor (a dry run) gets the outputs and the
scratch of their shapes and dtypes and launches nothing.  ``launches_u``
counts RWKV6 launches (u given) and ``launches_ssd`` SSD launches
(u=None); ``cost`` gives one launch's (FLOPs, bytes), which each launch
and each meta call reports to the active op counters (``_build.record``)
as ``wkv6`` or ``ssm_scan``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import chunked

DEFAULT_CHUNK = 64
MAX_DK, MAX_DV, MAX_CHUNK = 64, 128, 128

launches_u = 0
launches_ssd = 0

_FN = {torch.bfloat16: "wkv6_bf16", torch.float32: "wkv6_f32"}

# csrc/wkv6.cu's least kernel chunk (above it, kKernelChunk) and value tile
# (kVTile), which bound its scratch
_KERNEL_CHUNK, _VTILE = 64, 64


def scratch_floats(B: int, T: int, H: int, dk: int, dv: int, C: int) -> int:
    """The f32 scratch of one launch over a T padded to a multiple of C, on
    the card and on meta alike: a chunk state per kernel chunk, then the
    sync flags (a ticket, one a chunk and value tile).  The kernel computes
    in chunks of C rows, or of 64 where C's block would leave no room for a
    second one on its SM, so this sizes it for chunks of min(C, 64); the
    kernel refuses a launch that needs more."""
    n = -(-T // min(C, _KERNEL_CHUNK))
    return B * H * n * dk * dv + 1 + B * H * n * (-(-dv // _VTILE))


def work(B: int, T: int, H: int, dk: int, dv: int, C: int,
         use_u: bool) -> tuple[float, float]:
    """(FLOPs, exps) of one chunked WKV call in the plain chunked form, at
    chunk ``C``: per chunk and head the pairwise scores (3 per channel of
    each pair s < t, 2 per channel on the diagonal, one exp per channel of
    each pair s < t), r*exp(base) @ S, A @ v over s <= t and the state
    update.  The kernel factors most of the pairwise exps away."""
    n = -(-T // C)
    pairs = C * (C - 1) // 2
    per_chunk = (3 * pairs * dk + (3 if use_u else 2) * C * dk
                 + 2 * C * dk * dv + C * (C + 1) * dv + 2 * C * dk * dv)
    return float(B * H * n * per_chunk), float(B * H * n * pairs * dk)


def cost(B: int, T: int, H: int, dk: int, dv: int, chunk: int, wd: int,
         use_u: bool, with_s0: bool, dtype) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: ``work``'s FLOPs at chunk
    min(chunk, T); r, k and v read (each counted at r's size, B*T*H*dk),
    the f32 decay (B, T, H, wd), u and s0 where given, the f32 o and
    final state written."""
    flops = work(B, T, H, dk, dv, min(chunk, T), use_u)[0]
    nbytes = (3 * B * T * H * dk * dtype.itemsize + 4 * B * T * H * wd
              + (4 * H * dk if use_u else 0)
              + 4 * B * H * dk * dv * (2 if with_s0 else 1)
              + 4 * B * T * H * dv)
    return flops, float(nbytes)


def _check(r, k, v, w_log, u, s0, chunk):
    if r.dim() != 4 or k.shape != r.shape or v.dim() != 4 \
            or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (B,T,H,dk)/(B,T,H,dv)")
    B, T, H, dk = r.shape
    if w_log.shape[-1] not in (1, dk):
        raise ValueError(f"wkv: w_log {tuple(w_log.shape)} must end in 1 or "
                         f"dk = {dk}")
    if u is not None and tuple(u.shape) != (H, dk):
        raise ValueError(f"wkv: u {tuple(u.shape)} must be (H, dk)")
    if s0 is not None and tuple(s0.shape) != (B, H, dk, v.shape[3]):
        raise ValueError(f"wkv: s0 {tuple(s0.shape)} must be (B,H,dk,dv)")
    if chunk < 1:
        raise ValueError(f"wkv: chunk must be >= 1, got {chunk}")


def wkv_f32(r, k, v, w_log, u=None, s0=None, chunk: int = DEFAULT_CHUNK):
    """-> (o (B,T,H,dv) f32, s_final (B,H,dk,dv) f32)."""
    global launches_u, launches_ssd
    _check(r, k, v, w_log, u, s0, chunk)
    if r.device.type == "cpu":
        return chunked(r, k, v, w_log, u=u, s0=s0, chunk=chunk)
    meta = r.device.type == "meta"
    if not meta:
        _build.check_device(r, "wkv")
    if r.dtype not in _FN or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv kernel takes bf16 or f32 r/k/v of one dtype, "
                        f"got {r.dtype}/{k.dtype}/{v.dtype}")
    B, T, H, dk = r.shape
    dv = v.shape[3]
    C = min(chunk, T)
    if dk > MAX_DK or dv > MAX_DV or C > MAX_CHUNK:
        raise ValueError(f"wkv kernel takes dk <= {MAX_DK}, dv <= {MAX_DV} "
                         f"and chunk <= {MAX_CHUNK}, got {dk}, {dv}, {C}")
    tensors = [t for t in (k, v, w_log, u, s0) if t is not None]
    if any(t.device != r.device for t in tensors):
        raise ValueError("wkv: every input must lie on one card")
    wd = w_log.shape[-1]
    w = w_log.float().expand(B, T, H, wd)
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    pad = -T % C
    if pad:
        r, k, v, w = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, w))
    w = w.contiguous()
    uf = None if u is None else u.float().contiguous()
    s0f = None if s0 is None else s0.float().contiguous()
    Tp = T + pad
    o = torch.empty((B, Tp, H, dv), dtype=torch.float32, device=r.device)
    sf = torch.empty((B, H, dk, dv), dtype=torch.float32, device=r.device)
    floats = scratch_floats(B, Tp, H, dk, dv, C)
    scratch = torch.empty(floats, dtype=torch.float32, device=r.device)
    if not meta:
        status = getattr(_build.load(), _FN[r.dtype])(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            None if uf is None else uf.data_ptr(),
            None if s0f is None else s0f.data_ptr(),
            o.data_ptr(), sf.data_ptr(), scratch.data_ptr(), floats, B, Tp,
            H, dk, dv, wd, C, _build.stream_ptr(r))
        _build.check_status(status, "wkv")
        if u is None:
            launches_ssd += 1
        else:
            launches_u += 1
    _build.record("ssm_scan" if u is None else "wkv6", cost, B, T, H, dk,
                  dv, chunk, wd, u is not None, s0 is not None, r.dtype)
    return (o[:, :T] if pad else o), sf


def wkv(r, k, v, w_log, u=None, s0=None, chunk: int = DEFAULT_CHUNK):
    """-> (o (B,T,H,dv) in v's dtype, s_final (B,H,dk,dv) f32), as the
    reference op returns them."""
    o, sf = wkv_f32(r, k, v, w_log, u=u, s0=s0, chunk=chunk)
    return o.to(v.dtype), sf
