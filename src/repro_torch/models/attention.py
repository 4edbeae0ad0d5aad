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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist.sharding import decl
from repro_torch.kernels.flash_attn.ops import flash_fwd
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


def project_qkv(params, x, positions, theta: float, *, apply_rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd)."""
    q = project_heads(x, params["wq"])
    k = project_heads(x, params["wk"])
    v = project_heads(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if apply_rope:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def project_out(params, o):
    """o: (B, S, H, hd) -> (B, S, D)."""
    H, hd, D = params["wo"].shape
    return o.reshape(*o.shape[:-2], H * hd) @ params["wo"].reshape(H * hd, D)


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
    ok = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window is not None:
        ok &= pos[:, None] - kv_pos < window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(q.dtype))
    return o.reshape(B, 1, H, hd)
