"""Attention: GQA / MHA with optional sliding window; exact quadratic
attention for short sequences and flash attention above
``attn_chunk_threshold``.

Flash attention is a ``torch.autograd.Function``: its forward is the
hand-written kernel (``kernels/flash_attn``) on a CUDA tensor and its plain
version on the CPU, and returns ``o`` and the row log-sum-exp; its backward
is plain PyTorch and mirrors the reference ``_flash_bwd``: recompute the
probabilities from ``lse``, chunked over kv.  The reference has no Pallas
backward either.  Without autograd (serving's prefill, under
``torch.inference_mode``) the dispatch calls the kernel's forward directly
and keeps nothing for a backward.

``decode_attention`` attends one new token to a ring-buffer cache; it is
plain PyTorch, as the reference computes it outside any Pallas kernel.
``decode_block`` is a decode step's whole attention block on one device
or a rank, for each cache layout (``kvcache.CacheLayout``); over a cache
whose slots are split on the model axis it attends with
``split_decode_attention``: each rank's partial softmax over its slots,
merged across the ranks by their log-sum-exps (plain PyTorch too).

``project_qkv`` and ``project_out`` take an optional ``tp``
(``dist.tensor_parallel.ModelAxis``): the rank's local heads, projected
column-parallel, and the output projection row-parallel; the attention
between them runs on the local heads unchanged.  The encoder-decoder's
cross-attention projects its query and its keys and values from two
inputs (``project_q``, ``project_kv``), each column-parallel the same
way.  Where the heads do not divide the axis (``tensor_parallel.along(tp,
"heads")`` is None) they stay whole: the weights are whole on every rank
and both run the plain code.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.sharding import decl
from repro_torch.kernels.flash_attn.ops import flash_fwd
from repro_torch.models import kvcache as kvc
from repro_torch.models.layers import rope

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Declarations
# --------------------------------------------------------------------------

def attention_decl(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool = False):
    d = {
        "wq": decl((d_model, n_heads, head_dim), ("embed", "heads", None)),
        "wk": decl((d_model, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wv": decl((d_model, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wo": decl((n_heads, head_dim, d_model), ("heads", None, "embed")),
    }
    if qkv_bias:
        f32 = torch.float32
        d["bq"] = decl((n_heads, head_dim), ("heads", None), init="zeros", dtype=f32)
        d["bk"] = decl((n_kv, head_dim), ("kv_heads", None), init="zeros", dtype=f32)
        d["bv"] = decl((n_kv, head_dim), ("kv_heads", None), init="zeros", dtype=f32)
    return d


def project_heads(x, w):
    """x (B,S,D) @ w (D,H,hd) -> (B,S,H,hd), no bias and no RoPE."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def _kv_params(params, tp, local_heads: int):
    """``wk``/``wv`` (and ``bk``/``bv``) as this rank's heads read them,
    and the expansion of their keys and values to one kv head a local q
    head (None where there is none): as held where kv heads are split (or
    there is no model axis); where they stay whole, the kv heads its q
    heads read (``kv_read``), taken through ``copy_to_model`` so each
    weight's gradient is the sum of its ranks' parts."""
    names = [n for n in ("wk", "wv", "bk", "bv") if n in params]
    read = None if tp is None else tpar.kv_read(tp, local_heads)
    if read is None:
        return {n: params[n] for n in names}, None
    dev = params["wk"].device
    heads, expand = (None if t is None else t.to(dev) for t in read)
    # the kv axis: dim 1 of a weight (D, Kv, hd), dim 0 of a bias (Kv, hd)
    return {n: tpar.copy_to_model(params[n], tp).index_select(
        params[n].dim() - 2, heads) for n in names}, expand


def _expand(t, expand):
    """Keys or values (B, S, k, hd) -> one kv head a local q head, where
    the rank's q heads straddle kv groups (``expand``; the index_select's
    backward sums each kv head's copies)."""
    return t if expand is None else t.index_select(2, expand)


def project_qkv(params, x, positions, theta: float, *, apply_rope: bool = True,
                tp=None):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd).  With ``tp``, H is
    this rank's q heads and K the kv heads they read (one a q head where
    they straddle kv groups)."""
    tp = tpar.along(tp, "heads")
    x = _heads_input(x, tp)
    kv, expand = _kv_params(params, tp, params["wq"].shape[1])
    q = project_heads(x, params["wq"])
    k = project_heads(x, kv["wk"])
    v = project_heads(x, kv["wv"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + kv["bk"].to(k.dtype)
        v = v + kv["bv"].to(v.dtype)
    if apply_rope:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, _expand(k, expand), _expand(v, expand)


def _heads_input(x, tp):
    """x as a projection into ``tp``'s heads takes it: through
    ``copy_to_model``, so its gradient sums the ranks' parts."""
    return x if tp is None else tpar.copy_to_model(x, tp)


def project_q(params, x, tp=None):
    """The cross-attention's query: x (B,S,D) -> q (B,S,H,hd), no bias
    and no RoPE; with ``tp``, H is this rank's q heads."""
    tp = tpar.along(tp, "heads")
    return project_heads(_heads_input(x, tp), params["wq"])


def project_kv(params, x, tp=None):
    """The cross-attention's keys and values of the encoder's memory x
    (B,T,D) -> k, v (B,T,K,hd), no bias and no RoPE; with ``tp``, K is the
    kv heads this rank's q heads read (``_kv_params``; one a q head where
    they straddle kv groups)."""
    tp = tpar.along(tp, "heads")
    kv, expand = _kv_params(params, tp, params["wq"].shape[1])
    x = _heads_input(x, tp)
    return (_expand(project_heads(x, kv["wk"]), expand),
            _expand(project_heads(x, kv["wv"]), expand))


def project_out(params, o, tp=None):
    """o: (B, S, H, hd) -> (B, S, D); with ``tp``, row-parallel over this
    rank's heads."""
    tp = tpar.along(tp, "heads")
    H, hd, D = params["wo"].shape
    flat = o.reshape(*o.shape[:-2], H * hd)
    if tp is not None:
        return tpar.row_parallel(flat, params["wo"].reshape(H * hd, D), tp)
    return flat @ params["wo"].reshape(H * hd, D)


# --------------------------------------------------------------------------
# Masking
# --------------------------------------------------------------------------

def _mask_bias(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(Sq, Sk) additive bias from position constraints."""
    ok = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - kv_pos[None, :] < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


# --------------------------------------------------------------------------
# Full (quadratic) attention — short sequences
# --------------------------------------------------------------------------

def full_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                   window: Optional[int] = None):
    """q: (B,Sq,H,hd); k,v: (B,Sk,K,hd) with H % K == 0."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = scores + _mask_bias(q_pos, kv_pos, causal, window)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return o.reshape(B, Sq, H, hd)


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------

def _flash_bwd(q, k, v, o, lse, do, causal, window, chunk_k,
               q_offset, kv_offset):
    """Gradients of flash attention, recomputed from ``lse`` one kv chunk
    at a time (the reference ``_flash_bwd``), all in f32."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float().reshape(B, Sq, K, G, hd)
    dof = do.float().reshape(B, Sq, K, G, hd)
    D = (do.float() * o.float()).sum(dim=-1).reshape(B, Sq, K, G)
    Dt = D.permute(0, 2, 3, 1)[..., None]                  # (B,K,G,Sq,1)
    lse_e = lse.reshape(B, K, G, Sq)[..., None]             # (B,K,G,Sq,1)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    dq = torch.zeros((B, Sq, K, G, hd), dtype=torch.float32, device=dev)
    dk = torch.empty((B, Sk, K, hd), dtype=torch.float32, device=dev)
    dv = torch.empty((B, Sk, K, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, Sk, chunk_k):
        kb = k[:, j0:j0 + chunk_k].float()
        vb = v[:, j0:j0 + chunk_k].float()
        kv_pos = kv_offset + torch.arange(j0, j0 + kb.shape[1], device=dev)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kb) * scale
        s = s + _mask_bias(q_pos, kv_pos, causal, window)
        p = torch.exp(s - lse_e)
        dv[:, j0:j0 + chunk_k] = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
        dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vb)
        ds = p * (dp - Dt) * scale
        dq += torch.einsum("bkgqs,bskh->bqkgh", ds, kb)
        dk[:, j0:j0 + chunk_k] = torch.einsum("bkgqs,bqkgh->bskh", ds, qf)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Kernel forward (o, lse) + recomputing plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk_k, q_offset, kv_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, causal, window, q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, chunk_k, q_offset, kv_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window=None,
                    chunk_k: int = 1024, q_offset: int = 0,
                    kv_offset: int = 0):
    """Differentiable flash attention; ``chunk_k`` is the backward's kv
    chunk (the forward kernel picks its own tiles)."""
    return FlashAttention.apply(q, k, v, causal, window, chunk_k, q_offset,
                                kv_offset)


def attention(q, k, v, q_pos, kv_pos, *, causal: bool,
              window: Optional[int] = None, chunk: int = 1024,
              chunk_threshold: int = 1024):
    """Dispatch: exact quadratic for short kv, flash for long.  The flash
    path takes q_pos/kv_pos to be ``arange`` from 0 (always true for
    training calls)."""
    if k.shape[1] <= chunk_threshold:
        return full_attention(q, k, v, q_pos, kv_pos, causal=causal,
                              window=window)
    if not torch.is_grad_enabled():
        return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal, window)[0]
    return flash_attention(q, k, v, causal, window, chunk)


# --------------------------------------------------------------------------
# Single-token decode attention
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, kv_pos, pos, *,
                     window: Optional[int] = None):
    """q: (B,1,H,hd); caches: (B,S,K,hd); kv_pos: (B,S) absolute positions
    stored in each cache slot (-1 = empty); pos: (B,) current position.
    Scores and softmax in f32, probabilities in q's dtype for P @ V."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    s = s / math.sqrt(hd)
    s = torch.where(_valid(kv_pos, pos, window)[:, None, None, :], s,
                    NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(q.dtype))
    return o.reshape(B, 1, H, hd)


def _valid(kv_pos, pos, window):
    """(B, S) slots a query at ``pos`` reads; None where ``kv_pos`` is None
    (a cross cache: every slot valid, no position)."""
    if kv_pos is None:
        return None
    ok = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window is not None:
        ok &= pos[:, None] - kv_pos < window
    return ok


def split_decode_attention(q, k_cache, v_cache, kv_pos, pos, axis, *,
                           window: Optional[int] = None):
    """``decode_attention`` over a cache whose slots are split over
    ``axis``'s ranks: q (B,1,H,hd) every head, the rank's slots (B,Cl,K,hd)
    and their ``kv_pos`` (B,Cl).  Each rank computes, in f32, its
    unnormalised numerator over its valid slots, their running max and
    sum; one all-gather brings every rank's, and each merges them in rank
    order (equal on every rank).  A rank with no valid slot for a row (all
    -1, outside the window, or later than ``pos``) has a max of ``NEG_INF``
    and a sum of 0, so it adds exactly nothing.  ``kv_pos`` None: every
    slot is valid, unmasked (the encoder-decoder's cross cache).  ->
    (B,1,H,hd) in q's dtype."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) / math.sqrt(hd)
    ok = _valid(kv_pos, pos, window)
    if ok is not None:
        s = torch.where(ok[:, None, None, :], s, -math.inf)
    m = s.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, NEG_INF)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    part = torch.cat([o, m[..., None], p.sum(dim=-1)[..., None]], dim=-1)
    every = axis.all_gather(part[None], 0)              # (M, B, K, G, hd+2)
    mx = every[..., hd].amax(dim=0)
    w = torch.exp(every[..., hd] - mx)
    num = (w[..., None] * every[..., :hd]).sum(dim=0)
    den = (w * every[..., hd + 1]).sum(dim=0)
    return (num / den[..., None]).reshape(B, 1, H, hd).to(q.dtype)


def decode_block(params, h, k_l, v_l, kv_pos, pos, slots, theta: float,
                 window: Optional[int], lay, tp=None):
    """A decode step's attention block: the new token's q/k/v from ``h``
    (B,1,D) (with ``tp`` the rank's heads), its k/v written in place into
    the cache views ``k_l``/``v_l`` (B, lay.local, k, hd) at ``slots``
    (``kvcache.token_slot``; ``kv_pos`` already holds the token), attention
    over the cache, the output projection.  Under layout ``seq`` every
    rank gathers the heads' q, attends every head over its own slots
    (``split_decode_attention``) and keeps its heads' rows of the result;
    under ``heads`` it attends its heads over its kv heads; under
    ``whole`` with the q heads split, over the kv heads they read
    (``local_kv``)."""
    q, k, v = project_qkv(params, h, pos[:, None], theta, tp=tp)
    kvc.write_token(k_l, slots, kvc.cache_heads(k, tp, lay)[:, 0])
    kvc.write_token(v_l, slots, kvc.cache_heads(v, tp, lay)[:, 0])
    if lay.kind == "seq":
        o = seq_attention(q, k_l, v_l, kv_pos, pos, tp, window)
    else:
        k_l, v_l = local_kv(k_l, v_l, lay, tp, q.shape[2])
        o = decode_attention(q, k_l, v_l, kv_pos, pos, window=window)
    return project_out(params, o, tp)


def seq_attention(q, k_l, v_l, kv_pos, pos, tp, window=None):
    """One decode step's attention of q (B,1,h,hd), the rank's heads, over
    a cache split on its sequence: every rank gathers the heads' q,
    attends every head over its own slots (``split_decode_attention``;
    ``kv_pos`` None: all of them, unmasked) and keeps its heads' rows."""
    hp = tpar.along(tp, "heads")
    every = q if hp is None else tpar.gather_from_model(q, hp, 2)
    o = split_decode_attention(every, k_l, v_l, kv_pos, pos, tp,
                               window=window)
    return o if hp is None else o.narrow(2, hp.rank * q.shape[2],
                                         q.shape[2])


def local_kv(k_l, v_l, lay, tp, local_heads: int):
    """A rank's block of a cache under ``heads`` or ``whole`` as its
    ``local_heads`` q heads read it: as held, but under ``whole`` with the
    q heads split, the kv heads they read (``kv_index``: the one of their
    group, or one a q head where they straddle groups, selected from the
    cache each step)."""
    hp = tpar.along(tp, "heads")
    idx = None if hp is None or lay.kind == "heads" else \
        tpar.kv_index(hp, local_heads)
    if idx is None:
        return k_l, v_l
    idx = idx.to(k_l.device)
    return k_l.index_select(2, idx), v_l.index_select(2, idx)
