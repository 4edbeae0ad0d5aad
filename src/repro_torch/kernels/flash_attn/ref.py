"""Plain PyTorch version of the flash-attention forward kernel: the same
online softmax over kv blocks, in f32, returning ``o`` and the row
log-sum-exp.

Masked scores are NEG_INF and their probabilities exactly 0, so a row
whose every key is masked gives o = 0 and lse ≈ NEG_INF (the kernel does
the same; such rows never occur on the training path)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True, window=None,
                  q_offset: int = 0, kv_offset: int = 0,
                  block_k: int = 128, round_p: bool = False):
    """q: (B,Sq,H,hd); k/v: (B,Sk,Kv,hd) with H % Kv == 0.
    Returns o (B,Sq,H,hd) in q's dtype and lse (B,H,Sq) f32.  With
    ``round_p`` the probabilities are rounded to bf16 before P @ V (the row
    sum keeps them in f32)."""
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float().reshape(B, Sq, Kv, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Kv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, G, Sq, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, Sk, block_k):
        kb = k[:, j0:j0 + block_k].float()
        vb = v[:, j0:j0 + block_k].float()
        kv_pos = kv_offset + torch.arange(j0, j0 + kb.shape[1], device=dev)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kb) * scale
        ok = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            ok &= q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            ok &= q_pos[:, None] - kv_pos[None, :] < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", pv, vb)
        m = m_new
    denom = torch.clamp(l, min=1e-30)
    lse = (m + torch.log(denom)).reshape(B, H, Sq)
    o = (acc / denom[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return o.to(q.dtype), lse


def attention_tc_ref(q, k, v, causal: bool = True, window=None,
                     q_offset: int = 0, kv_offset: int = 0):
    """What the bf16 kernel computes: 64-key tiles, f32 scores and row
    sums, P rounded to bf16 before P @ V.  Tests only; no path calls it."""
    return attention_ref(q, k, v, causal, window, q_offset, kv_offset,
                         block_k=64, round_p=True)
