"""Generalized decayed linear attention: the shared computational core of
RWKV6 ("Finch", data-dependent per-channel decay, bonus u) and the Hymba
SSM branch (SSD form, scalar per-head decay, u=None).

``recurrent`` (the exact time-step recurrence, the oracle), ``decode_step``
(one step of it) and ``chunked``
(the chunked form the kernel computes, each chunk under
``torch.utils.checkpoint``) are plain PyTorch; they live beside the kernel
in ``kernels/wkv6/ref.py`` as its plain version and are re-exported here.

``linear_attention(impl="chunked")`` runs the ``WKV`` autograd Function:
its forward is ``kernels/wkv6/ops.wkv_f32`` (the hand-written kernel on a
CUDA tensor, ``chunked`` on the CPU), and its backward is plain PyTorch:
the chunk-start states are recomputed by a cheap state-only scan, then
each chunk's forward is recomputed with autograd from its start state, in
reverse, carrying the state's gradient.  Only one chunk's (B,C,C,H,dk)
pairwise-decay tensor is alive at a time.  ``o`` is f32, as the JAX
package's chunked form returns it.  Serving's decode step is T = 1 with
the cached state as ``s0``, through the same kernel, as the reference's
families call ``chunked`` with ``chunk=1``.

The reference's mesh pinning waits for multi-GPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import (chunk_state, chunk_step, chunked,
                                          recurrent)

__all__ = ["recurrent", "decode_step", "chunked", "WKV", "linear_attention"]


def decode_step(r, k, v, w_log, S, u=None):
    """One token of the recurrence.  r,k: (B,H,dk); v: (B,H,dv); w_log
    (B,H,dk) or (B,H,1); S: (B,H,dk,dv) f32.  Returns (o (B,H,dv) in r's
    dtype, S_new f32)."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    decay = torch.exp(w_log.float().expand(rf.shape))[..., None]
    kv = kf[..., :, None] * vf[..., None, :]
    if u is not None:
        att = S + u[None, :, :, None] * kv
    else:
        att = decay * S + kv
    o = torch.einsum("bhk,bhkv->bhv", rf, att)
    return o.to(r.dtype), decay * S + kv


def _wkv_bwd(r, k, v, w_log, u, s0, C, do, dsf):
    """Gradients of (o, s_final) = chunked(r, k, v, w_log, u, s0, C), one
    chunk at a time.  w_log is (B,T,H,1) or (B,T,H,dk); its gradient has
    its shape."""
    B, T, H, dk = r.shape
    pad = -T % C
    n = (T + pad) // C

    def prep(a):                                    # f32, padded along T
        a = a.float()
        return F.pad(a, (0, 0, 0, 0, 0, pad)) if pad else a
    rf, kf, vf, wf, dof = (prep(a) for a in (r, k, v, w_log, do))
    uf = None if u is None else u.float()
    sl = [slice(c * C, (c + 1) * C) for c in range(n)]

    def full(wb):
        return wb.expand(B, wb.shape[1], H, dk)

    starts = [torch.zeros((B, H, dk, v.shape[3]), dtype=torch.float32,
                          device=r.device) if s0 is None else s0.float()]
    for c in range(n - 1):
        starts.append(chunk_state(starts[-1], kf[:, sl[c]], vf[:, sl[c]],
                                  torch.cumsum(full(wf[:, sl[c]]), dim=1)))
    dr, dk_, dv, dw = (torch.empty_like(a) for a in (rf, kf, vf, wf))
    du = None if uf is None else torch.zeros_like(uf)
    dS = dsf.float()
    for c in reversed(range(n)):
        with torch.enable_grad():
            ins = [a[:, sl[c]].detach().requires_grad_()
                   for a in (rf, kf, vf, wf)]
            ins.append(starts[c].detach().requires_grad_())
            if uf is not None:
                ins.append(uf.detach().requires_grad_())
            o, S = chunk_step(ins[4], ins[0], ins[1], ins[2], full(ins[3]),
                              ins[5] if uf is not None else None)
            g = torch.autograd.grad((o, S), ins, (dof[:, sl[c]], dS))
        for out, gi in zip((dr, dk_, dv, dw), g):
            out[:, sl[c]] = gi
        dS = g[4]
        if du is not None:
            du += g[5]
        starts[c] = None
    return (dr[:, :T].to(r.dtype), dk_[:, :T].to(k.dtype),
            dv[:, :T].to(v.dtype), dw[:, :T].to(w_log.dtype),
            None if u is None else du.to(u.dtype),
            None if s0 is None else dS.to(s0.dtype))


class WKV(torch.autograd.Function):
    """Kernel forward (o f32, s_final) + per-chunk recomputing backward."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, s0, chunk):
        o, sf = wkv_ops.wkv_f32(r, k, v, w_log, u=u, s0=s0, chunk=chunk)
        ctx.save_for_backward(r, k, v, w_log, u, s0)
        ctx.chunk = min(chunk, r.shape[1])
        return o, sf

    @staticmethod
    def backward(ctx, do, dsf):
        r, k, v, w_log, u, s0 = ctx.saved_tensors
        return (*_wkv_bwd(r, k, v, w_log, u, s0, ctx.chunk, do, dsf), None)


def linear_attention(r, k, v, w_log, u=None, s0=None, chunk: int = 64,
                     impl: str = "chunked"):
    """r,k: (B,T,H,dk); v: (B,T,H,dv); w_log broadcastable to r.
    Returns (o (B,T,H,dv) f32, s_final (B,H,dk,dv) f32)."""
    if impl == "recurrent":
        return recurrent(r, k, v, w_log, u=u, s0=s0)
    # a per-head decay stays (B,T,H,1); autograd sums the expand's gradient
    w_log = w_log.expand(*r.shape[:3], w_log.shape[-1])
    return WKV.apply(r, k, v, w_log, u, s0, chunk)
