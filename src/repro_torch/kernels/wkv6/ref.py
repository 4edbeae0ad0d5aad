"""Plain PyTorch versions of the chunked WKV kernel (``csrc/wkv6.cu``):
generalized decayed linear attention, the shared core of RWKV6 (per-channel
decay, bonus ``u``) and Hymba's SSM branch (SSD form, ``u=None``).

Per batch b and head h, with S a (dk, dv) f32 state:

    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)     (u given: RWKV6)
    o_t = r_t^T S_t                               (u=None: SSD)

``w_log`` (<= 0) is the log-decay, broadcastable to r: (B,T,H,dk) per
channel or (B,T,H,1) per head.  Everything is computed in f32 and ``o``
is returned in f32, as the JAX package's ``models/linear_attn.py`` does.

``recurrent`` is the exact time-step recurrence, the oracle (``wkv_ref``).
``chunked`` is what the kernel computes: a loop over chunks of C steps
whose in-chunk part uses pairwise decay differences (every exponent is of
a number <= 0), with the state carried between chunks.  The masked pairwise
decay is ``exp(where(lower, diff, -inf))``, never ``where(lower, exp(diff),
0)``: above the diagonal diff > 0 can overflow, and the gradient would be
0 * inf = NaN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def recurrent(r, k, v, w_log, u=None, s0=None):
    """r,k: (B,T,H,dk); v: (B,T,H,dv); w_log broadcastable to r;
    u: (H,dk) or None.  Returns (o (B,T,H,dv) f32, s_final (B,H,dk,dv))."""
    B, T, H, dk = r.shape
    dv = v.shape[-1]
    w = torch.broadcast_to(w_log, r.shape).float()
    rf, kf, vf = r.float(), k.float(), v.float()
    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # (B,H,dk,dv)
        decay = torch.exp(w[:, t])[..., None]
        att = S + u.float()[None, :, :, None] * kv if u is not None \
            else decay * S + kv
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], att))
        S = decay * S + kv
    return torch.stack(outs, dim=1), S


wkv_ref = recurrent


def chunk_state(S, kb, vb, cum):
    """The state after one chunk: S (B,H,dk,dv); kb (B,C,H,dk); vb
    (B,C,H,dv); cum (B,C,H,dk) the inclusive cumsum of the log-decay."""
    cum_last = cum[:, -1]                                       # (B,H,dk)
    k_eff = kb * torch.exp(cum_last[:, None] - cum)
    return S * torch.exp(cum_last)[..., None] + torch.einsum(
        "bchk,bchv->bhkv", k_eff, vb)


def chunk_step(S, rb, kb, vb, wb, u=None):
    """One chunk, all f32: rb,kb,wb (B,C,H,dk); vb (B,C,H,dv); S
    (B,H,dk,dv); u (H,dk) or None.  Returns (o (B,C,H,dv), S_new)."""
    C = rb.shape[1]
    cum = torch.cumsum(wb, dim=1)                  # inclusive log-decay
    # RWKV (u given) reads S before the t-update: exclusive decay; SSD
    # (u=None) reads it after: inclusive decay.
    base = cum - wb if u is not None else cum
    o_inter = torch.einsum("bchk,bhkv->bchv", rb * torch.exp(base), S)
    # diff[t,s] = base[t] - cum[s] <= 0 for s < t; masked before the exp
    lower = torch.ones((C, C), dtype=torch.bool, device=rb.device).tril(-1)
    diff = base[:, :, None] - cum[:, None]                      # (B,t,s,H,dk)
    decay = torch.exp(torch.where(lower[:, :, None, None], diff,
                                  float("-inf")))
    A = (rb[:, :, None] * kb[:, None] * decay).sum(-1)          # (B,t,s,H)
    diag = (rb * u * kb).sum(-1) if u is not None else (rb * kb).sum(-1)
    eye = torch.eye(C, dtype=torch.float32, device=rb.device)
    A = A + diag[:, :, None] * eye[None, :, :, None]
    o_intra = torch.einsum("btsh,bshv->bthv", A, vb)
    return o_inter + o_intra, chunk_state(S, kb, vb, cum)


def chunked(r, k, v, w_log, u=None, s0=None, chunk: int = 64):
    """Same contract as ``recurrent``, in chunks of C = min(chunk, T).  A
    ragged T is padded with k = 0 (adds nothing) and w_log = 0 (keeps the
    state).  Under autograd each chunk is a ``torch.utils.checkpoint``, so
    the (B,C,C,H,dk) pairwise-decay tensor is never saved for backward."""
    B, T, H, dk = r.shape
    dv = v.shape[-1]
    C = min(chunk, T)
    w = torch.broadcast_to(w_log, r.shape).float()
    rf, kf, vf = r.float(), k.float(), v.float()
    pad = -T % C
    if pad:
        rf, kf, vf, w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (rf, kf, vf, w))
    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = None if u is None else u.float()
    remat = torch.is_grad_enabled()
    outs = []
    for c0 in range(0, T + pad, C):
        sl = slice(c0, c0 + C)
        args = (S, rf[:, sl], kf[:, sl], vf[:, sl], w[:, sl], uf)
        o, S = (checkpoint(chunk_step, *args, use_reentrant=False) if remat
                else chunk_step(*args))
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :T], S
