"""Encoder-decoder backbone (Whisper-small).

The audio frontend is a stub, as in the reference: the batch carries
precomputed conv-frame embeddings ``frames`` (B, n_frames, feat_dim).  The
backbone has Whisper's shape (LayerNorm, GELU MLP, MHA) with RoPE in place
of Whisper's position tables, as the reference has it.  The encoder attends
without a mask; each decoder layer attends causally to the tokens, then
without a mask to the encoder's output (cross-attention: plain projections,
no RoPE).

As in ``decoder.py``, the reference's ``lax.scan`` over stacked layers is a
loop over views of the stacked ``(L, ...)`` leaves, ``cfg.remat`` is
``torch.utils.checkpoint`` per layer, and ``decode_step`` writes the
self-attention cache in place.  Prefill returns each decoder layer's cross
keys and values (``cross_k``/``cross_v``, (L, B, n_frames, K, hd)); decode
reads them and never writes them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models.decoder import layer_views
from repro_torch.models.layers import (embed_decl, embed_lookup, gelu_mlp,
                                       gelu_mlp_decl, layernorm,
                                       layernorm_decl, logits_out)


def _enc_layer_decl(cfg: ArchConfig):
    return {
        "ln1": layernorm_decl(cfg.d_model),
        "attn": attn.attention_decl(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim),
        "ln2": layernorm_decl(cfg.d_model),
        "mlp": gelu_mlp_decl(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_decl(cfg: ArchConfig):
    d = _enc_layer_decl(cfg)
    d["ln_x"] = layernorm_decl(cfg.d_model)
    d["cross"] = attn.attention_decl(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim)
    return d


def param_decls(cfg: ArchConfig):
    fe = cfg.frontend
    return {
        "enc_in": {"w": decl((fe.feat_dim, cfg.d_model), (None, "embed"))},
        "enc_layers": stack(_enc_layer_decl(cfg), cfg.n_enc_layers),
        "enc_norm": layernorm_decl(cfg.d_model),
        "embed": embed_decl(cfg.vocab, cfg.d_model),
        "dec_layers": stack(_dec_layer_decl(cfg), cfg.n_layers),
        "final_norm": layernorm_decl(cfg.d_model),
    }


def cache_decl(cfg: ArchConfig, batch: int, cache_len: int):
    d = kvc.kv_cache_decl(cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                          cfg.head_dim)
    d.update(kvc.kv_cache_decl(cfg.n_layers, batch, cfg.frontend.n_tokens,
                               cfg.n_kv_heads, cfg.head_dim, prefix="cross_"))
    del d["cross_kv_pos"]
    return d


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _attend(cfg: ArchConfig, q, k, v, q_pos, kv_pos, causal: bool):
    return attn.attention(q, k, v, q_pos, kv_pos, causal=causal,
                          chunk=cfg.attn_chunk,
                          chunk_threshold=cfg.attn_chunk_threshold)


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def _enc_layer(cfg: ArchConfig, lp, x, positions):
    h = layernorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta)
    x = x + attn.project_out(lp["attn"], _attend(cfg, q, k, v, positions,
                                                 positions, causal=False))
    h = layernorm(lp["ln2"], x, cfg.norm_eps)
    return x + gelu_mlp(lp["mlp"], h)


def encode(cfg: ArchConfig, params, frames):
    """frames (B, T, feat_dim) -> memory (B, T, D).  The frames are rounded
    to bf16 first, whatever the weights' dtype, as the reference does."""
    w = params["enc_in"]["w"]
    x = frames.to(torch.bfloat16).to(w.dtype) @ w
    positions = _arange(x.shape[1], x.device)
    for lp in layer_views(params["enc_layers"]):
        if cfg.remat:
            x = checkpoint(_enc_layer, cfg, lp, x, positions,
                           use_reentrant=False)
        else:
            x = _enc_layer(cfg, lp, x, positions)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

def _cross_attend(cfg: ArchConfig, lp, x, mem_k, mem_v, dec_pos, enc_pos):
    h = layernorm(lp["ln_x"], x, cfg.norm_eps)
    q = attn.project_heads(h, lp["cross"]["wq"])
    o = _attend(cfg, q, mem_k, mem_v, dec_pos, enc_pos, causal=False)
    return x + attn.project_out(lp["cross"], o)


def _cross_kv(lp, mem):
    return (attn.project_heads(mem, lp["cross"]["wk"]),
            attn.project_heads(mem, lp["cross"]["wv"]))


def _dec_layer(cfg: ArchConfig, lp, x, mem, positions, enc_pos,
               kv_out=None):
    """One decoder layer; with ``kv_out`` (four (B,S,K,hd) views of a
    cache: self k, v, cross k, v) its keys and values are copied there
    (prefill)."""
    h = layernorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta)
    x = x + attn.project_out(lp["attn"], _attend(cfg, q, k, v, positions,
                                                 positions, causal=True))
    mk, mv = _cross_kv(lp, mem)
    if kv_out is not None:
        for dst, src in zip(kv_out, (k, v, mk, mv)):
            dst.copy_(src)
    x = _cross_attend(cfg, lp, x, mk, mv, positions, enc_pos)
    h = layernorm(lp["ln2"], x, cfg.norm_eps)
    return x + gelu_mlp(lp["mlp"], h)


def forward(cfg: ArchConfig, params, batch):
    """-> (logits (B,S,V), aux_loss 0).  Every decoder layer projects its
    cross keys and values from the memory anew."""
    mem = encode(cfg, params, batch["frames"])
    x = embed_lookup(params["embed"], batch["tokens"])
    positions = _arange(x.shape[1], x.device)
    enc_pos = _arange(mem.shape[1], x.device)
    for lp in layer_views(params["dec_layers"]):
        if cfg.remat:
            x = checkpoint(_dec_layer, cfg, lp, x, mem, positions, enc_pos,
                           use_reentrant=False)
        else:
            x = _dec_layer(cfg, lp, x, mem, positions, enc_pos)
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def prefill(cfg: ArchConfig, params, batch):
    """-> (last-token logits (B,V), cache {k, v (L,B,S,K,hd), kv_pos,
    cross_k, cross_v (L,B,T,K,hd)})."""
    mem = encode(cfg, params, batch["frames"])
    x = embed_lookup(params["embed"], batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = _arange(S, x.device)
    enc_pos = _arange(mem.shape[1], x.device)
    L, Kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    k = torch.empty((L, B, S, Kv, hd), dtype=x.dtype, device=x.device)
    v = torch.empty_like(k)
    ck = torch.empty((L, B, mem.shape[1], Kv, hd), dtype=mem.dtype,
                     device=x.device)
    cv = torch.empty_like(ck)
    for i, lp in enumerate(layer_views(params["dec_layers"])):
        x = _dec_layer(cfg, lp, x, mem, positions, enc_pos,
                       kv_out=(k[i], v[i], ck[i], cv[i]))
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_out(params["embed"], x[:, -1])
    return logits, {"k": k, "v": v,
                    "kv_pos": kvc.prefilled_pos(B, S, x.device),
                    "cross_k": ck, "cross_v": cv}


def decode_step(cfg: ArchConfig, params, cache, batch):
    """batch: {"token": (B,1) int32, "pos": (B,) int32} -> (logits (B,V),
    cache).  The self-attention cache is updated in place; the cross cache
    is only read."""
    token, pos = batch["token"], batch["pos"]
    x = embed_lookup(params["embed"], token)
    cache_len = cache["k"].shape[2]
    slot = kvc.cache_slot(pos, cache_len)
    kv_pos = kvc.update_kv_pos(cache["kv_pos"], pos, cache_len)
    enc_pos = _arange(cache["cross_k"].shape[2], x.device)
    q_pos = pos[:, None]
    for i, lp in enumerate(layer_views(params["dec_layers"])):
        k_l, v_l = cache["k"][i], cache["v"][i]
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.project_qkv(lp["attn"], h, q_pos, cfg.rope_theta)
        kvc.update_kv_layer(k_l, v_l, k, v, slot)
        o = attn.decode_attention(q, k_l, v_l, kv_pos, pos)
        x = x + attn.project_out(lp["attn"], o)
        x = _cross_attend(cfg, lp, x, cache["cross_k"][i],
                          cache["cross_v"][i], q_pos, enc_pos)
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h)
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x[:, -1]), cache
