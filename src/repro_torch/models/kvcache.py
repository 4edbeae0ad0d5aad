"""KV caches (full-length and sliding-window ring buffers) for serving.
Cache layout: stacked over layers, ``(L, B, S, K, hd)``, with one
``kv_pos`` (B, S) of the absolute position held in each slot (-1: empty).

The reference's decode scan returns a new cache each step; here decode
writes the token's keys, values and position into the cache's tensors in
place (one advanced-index assignment a layer), so a step copies nothing
of the cache.  The reference shards the cache's sequence axis over its
mesh; on one device the cache lives whole on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import decl


def kv_cache_decl(n_layers: int, batch: int, cache_len: int, n_kv: int,
                  head_dim: int, dtype=torch.bfloat16, prefix: str = ""):
    return {
        prefix + "k": decl((n_layers, batch, cache_len, n_kv, head_dim),
                           ("layers", "batch", "cache_seq", "kv_heads", None),
                           init="zeros", dtype=dtype),
        prefix + "v": decl((n_layers, batch, cache_len, n_kv, head_dim),
                           ("layers", "batch", "cache_seq", "kv_heads", None),
                           init="zeros", dtype=dtype),
        prefix + "kv_pos": decl((batch, cache_len), ("batch", "cache_seq"),
                                init="neg_ones", dtype=torch.int32),
    }


def cache_slot(pos: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Ring-buffer slot for absolute position ``pos`` (B,)."""
    return pos % cache_len


def update_kv_layer(k_l, v_l, new_k, new_v, slot):
    """Insert one token into a layer's cache, in place.  k_l: (B,S,K,hd);
    new_k: (B,1,K,hd); slot: (B,).  Returns (k_l, v_l)."""
    b = torch.arange(k_l.shape[0], device=k_l.device)
    k_l[b, slot.long()] = new_k[:, 0].to(k_l.dtype)
    v_l[b, slot.long()] = new_v[:, 0].to(v_l.dtype)
    return k_l, v_l


def update_kv_pos(kv_pos, pos, cache_len):
    """kv_pos: (B,S); pos: (B,) absolute position being written.  In
    place; returns kv_pos."""
    b = torch.arange(kv_pos.shape[0], device=kv_pos.device)
    kv_pos[b, cache_slot(pos, cache_len).long()] = pos.to(kv_pos.dtype)
    return kv_pos


def prefilled_pos(batch: int, seq: int, device, start: int = 0):
    """kv_pos of a prefilled cache holding positions start..start+seq-1."""
    pos = torch.arange(start, start + seq, dtype=torch.int32, device=device)
    return pos.expand(batch, seq).contiguous()


def pad_cache(cache: dict, max_len: int) -> dict:
    """Grow a prefilled cache's sequence capacity to ``max_len`` (empty
    slots marked kv_pos=-1).  Required before decoding past the prompt
    length on full-attention models; windowed caches wrap instead."""
    out = dict(cache)
    if "k" not in cache:
        return out                      # recurrent state (rwkv): nothing to do
    extra = max_len - cache["k"].shape[2]
    if extra <= 0:
        return out
    for key in ("k", "v"):
        out[key] = F.pad(cache[key], (0, 0, 0, 0, 0, extra))
    out["kv_pos"] = F.pad(cache["kv_pos"], (0, extra), value=-1)
    return out
