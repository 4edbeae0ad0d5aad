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


# --------------------------------------------------------------------------
# The kernel's algorithm, step by step (tests only; no path calls it)
# --------------------------------------------------------------------------

SUB = 16  # rows of a sub-block


def tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does."""
    b = x.float().contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (b & ~0x7FFFFFFF)).view(torch.float32)


def split_mm(a, b):
    """a @ b as the kernel's tensor-core product: each f32 operand split into
    TF32 hi + lo, summed as hi@lo + lo@hi + hi@hi (lo@lo dropped).  A
    product of two TF32 numbers is exact in f32, so only the sums round."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def chunked_tc(r, k, v, w_log, u=None, s0=None, chunk: int = 64):
    """Same contract as ``chunked``, computed as ``csrc/wkv6.cu`` does, in
    chunks of C = min(chunk, T) rows (the kernel's own chunk) and 16-row
    sub-blocks i.  With cum the in-chunk cumsum of w, start_i the cum
    before sub-block i (0 for the first), end_j the cum at the end of
    sub-block j and cum_last the chunk's last cum, every exponent <= 0:
    - per-channel decay: R = r exp(base - start_i), K = k exp(end_j - cum),
      tables E_i = exp(start_i), F_ij = exp(start_i - end_j) (j < i),
      G_j = exp(cum_last - end_j); scores of an earlier sub-block j are
      (R F_ij) @ K^T, the chunk's inter term (R E_i) @ S_c and its state
      contribution (K G_j)^T @ v;
    - per-head decay (w's last dim 1): scores (r @ k^T) exp(base - cum),
      inter term (r exp(base)) @ S_c, state contribution
      (k exp(cum_last - cum))^T @ v;
    - the diagonal sub-blocks pairwise (exp only where s < t), with the u
      bonus (or r.k) on the diagonal;
    - the chunk-start states in order: S_{c+1} = S_c exp(cum_last) + U_c.
    Every product goes through ``split_mm``.  A ragged T and a ragged chunk
    are padded with zeros (w = 0).  Tests only; no path calls it."""
    B, T, H, dk = r.shape
    dv = v.shape[-1]
    C = min(chunk, T)
    scalar = w_log.shape[-1] == 1
    w = torch.broadcast_to(w_log, r.shape).float()
    rf, kf, vf = r.float(), k.float(), v.float()
    pad = -T % C
    if pad:
        rf, kf, vf, w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (rf, kf, vf, w))
    n = (T + pad) // C
    Cp = -(-C // SUB) * SUB
    NS = Cp // SUB

    def chunks(a):  # (B, T, H, d) -> (B, H, n, Cp, d), rows past C zero
        a = a.reshape(B, n, C, H, a.shape[-1]).permute(0, 3, 1, 2, 4)
        return F.pad(a, (0, 0, 0, Cp - C))

    rc, kc, vc, wc = (chunks(a) for a in (rf, kf, vf, w))
    cum = torch.cumsum(wc, dim=3)
    base = cum - wc if u is not None else cum
    zero = torch.zeros_like(cum[:, :, :, :1])
    start = torch.cat([zero, cum[:, :, :, SUB - 1:Cp - 1:SUB]], dim=3)
    end = cum[:, :, :, SUB - 1::SUB]                    # (B,H,n,NS,dk)
    cum_last = cum[:, :, :, -1:]
    rows = lambda a: a.repeat_interleave(SUB, dim=3)    # sub-block -> rows
    if scalar:
        R, K = rc, kc
        Ktil = kc * torch.exp(cum_last - cum)
        Rinter = rc * torch.exp(base)
    else:
        R = rc * torch.exp(base - rows(start))
        K = kc * torch.exp(rows(end) - cum)
        Ktil = K * rows(torch.exp(cum_last - end))
        Rinter = R * rows(torch.exp(start))
    U = split_mm(Ktil.transpose(-1, -2), vc)            # (B,H,n,dk,dv)
    decay = torch.exp(cum_last).transpose(-1, -2)       # (B,H,n,dk,1)

    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    starts = []
    for c in range(n):
        starts.append(S)
        S = S * decay[:, :, c] + U[:, :, c]
    o = split_mm(Rinter, torch.stack(starts, dim=2))    # (B,H,n,Cp,dv)

    uf = (u.float()[None, :, None, None, :] if u is not None
          else torch.ones((1, 1, 1, 1, dk), device=r.device))
    lower = torch.ones((SUB, SUB), dtype=torch.bool,
                       device=r.device).tril(-1)
    eye = torch.eye(SUB, dtype=torch.float32, device=r.device)
    blocks = []
    for i in range(NS):
        ti = slice(i * SUB, (i + 1) * SUB)
        acc = o[..., ti, :]
        for j in range(i):
            sj = slice(j * SUB, (j + 1) * SUB)
            if scalar:
                A = split_mm(R[..., ti, :], K[..., sj, :].transpose(-1, -2)) \
                    * torch.exp(base[..., ti, :1]
                                - cum[..., sj, :1].transpose(-1, -2))
            else:
                Fij = torch.exp(start[..., i:i + 1, :] - end[..., j:j + 1, :])
                A = split_mm(R[..., ti, :] * Fij,
                             K[..., sj, :].transpose(-1, -2))
            acc = acc + split_mm(A, vc[..., sj, :])
        r_i, k_i = rc[..., ti, :], kc[..., ti, :]
        diff = base[..., ti, None, :] - cum[..., None, ti, :]  # (t,s,dk)
        if scalar:
            D = (r_i @ k_i.transpose(-1, -2)) * torch.exp(
                torch.where(lower, diff[..., 0], float("-inf")))
        else:
            D = (r_i[..., :, None, :] * k_i[..., None, :, :] * torch.exp(
                torch.where(lower[..., None], diff, float("-inf")))).sum(-1)
        D = D + ((r_i * uf * k_i).sum(-1))[..., None] * eye
        blocks.append(acc + split_mm(D, vc[..., ti, :]))
    o = torch.cat(blocks, dim=3)[:, :, :, :C]           # (B,H,n,C,dv)
    o = o.permute(0, 2, 3, 1, 4).reshape(B, n * C, H, dv)
    return o[:, :T], S
