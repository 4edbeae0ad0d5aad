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

Every entry point takes ``decoder.py``'s ``tp`` and ``dp``.  With ``tp``
(``dist.tensor_parallel.ModelAxis``) the parameters are this rank's
blocks of a client's, split over the ``model`` axis: the encoder's and the
decoder's self-attention through the tensor-parallel projections, the
GELU MLP column- and row-parallel (its replicated ``b_out`` added once,
after the sum), the embedding and the logits vocab-parallel, each where
its dim divides the axis and whole on every rank where it does not
(whisper-small's vocab at M = 3).  The cross-attention projects its
query from the decoder's stream and its keys and values from the
encoder's memory, each through ``copy_to_model``
(``attention.project_q``/``project_kv``, the kv heads a rank's q heads
read where the kv heads stay whole): the memory's gradient is summed over
the model group once a decoder layer that reads it.  ``enc_in``, the
LayerNorms and ``b_out`` are whole on ``model`` and get their whole
gradient on every rank.  With ``dp`` (``dist.fsdp.DataAxis``, shared
mode) each checkpointed layer gathers its weights on ``data``
(``fsdp.whole``), and so do ``enc_in`` and the embedding tables.

Serving on ranks holds two caches of two layouts
(``kvcache.layout_for``): the self-attention's (``layout``: ``seq``,
``heads`` or ``whole`` by its length) and the cross cache's
(``cross_layout``: 1500 frames split on their sequence where they divide
the model axis).  Prefill gathers each layer's cross keys and values over
the rank's heads (``kvcache.cache_heads``) before it keeps the rank's
frames; decode's cross-attention over a sequence-split cache is a
non-causal ``attention.split_decode_attention`` over slots that are all
valid (the cache has no ``cross_kv_pos``, as the reference's decl).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import fsdp
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models.decoder import layer_views
from repro_torch.models.layers import (embed_decl, embed_lookup, gelu_mlp,
                                       gelu_mlp_decl, last_logits,
                                       layernorm, layernorm_decl,
                                       logits_out)


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

def _enc_layer(cfg: ArchConfig, lp, x, positions, tp=None, dp=None):
    lp = fsdp.whole(dp, lp, "enc_layers", lead=1)
    h = layernorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta,
                               tp=tp)
    x = x + attn.project_out(lp["attn"], _attend(cfg, q, k, v, positions,
                                                 positions, causal=False), tp)
    h = layernorm(lp["ln2"], x, cfg.norm_eps)
    return x + gelu_mlp(lp["mlp"], h, tp)


def encode(cfg: ArchConfig, params, frames, tp=None, dp=None):
    """frames (B, T, feat_dim) -> memory (B, T, D).  The frames are rounded
    to bf16 first, whatever the weights' dtype, as the reference does."""
    w = fsdp.whole(dp, params["enc_in"], "enc_in")["w"]
    x = frames.to(torch.bfloat16).to(w.dtype) @ w
    positions = _arange(x.shape[1], x.device)
    for lp in layer_views(params["enc_layers"]):
        if cfg.remat:
            x = checkpoint(_enc_layer, cfg, lp, x, positions, tp, dp,
                           use_reentrant=False)
        else:
            x = _enc_layer(cfg, lp, x, positions, tp, dp)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

def _dec_layer(cfg: ArchConfig, lp, x, mem, positions, enc_pos, tp=None,
               dp=None, keep=None):
    """One decoder layer; with ``keep`` (prefill) its self keys and values
    and its cross keys and values, as the layer projects them, are handed
    to ``keep(k, v, cross_k, cross_v)``."""
    lp = fsdp.whole(dp, lp, "dec_layers", lead=1)
    h = layernorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta,
                               tp=tp)
    x = x + attn.project_out(lp["attn"], _attend(cfg, q, k, v, positions,
                                                 positions, causal=True), tp)
    mk, mv = attn.project_kv(lp["cross"], mem, tp)
    if keep is not None:
        keep(k, v, mk, mv)
    h = layernorm(lp["ln_x"], x, cfg.norm_eps)
    q = attn.project_q(lp["cross"], h, tp)
    o = _attend(cfg, q, mk, mv, positions, enc_pos, causal=False)
    x = x + attn.project_out(lp["cross"], o, tp)
    h = layernorm(lp["ln2"], x, cfg.norm_eps)
    return x + gelu_mlp(lp["mlp"], h, tp)


def forward(cfg: ArchConfig, params, batch, tp=None, dp=None):
    """-> (logits (B,S,V), aux_loss 0); with ``tp`` the logits are this
    rank's (B, S, V / M) vocab rows, with ``dp`` its rows of the client's
    batch.  Every decoder layer projects its cross keys and values from
    the memory anew."""
    mem = encode(cfg, params, batch["frames"], tp, dp)
    x = embed_lookup(params["embed"], batch["tokens"], tp, dp)
    positions = _arange(x.shape[1], x.device)
    enc_pos = _arange(mem.shape[1], x.device)
    for lp in layer_views(params["dec_layers"]):
        if cfg.remat:
            x = checkpoint(_dec_layer, cfg, lp, x, mem, positions, enc_pos,
                           tp, dp, use_reentrant=False)
        else:
            x = _dec_layer(cfg, lp, x, mem, positions, enc_pos, tp, dp)
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x, tp, dp), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def prefill(cfg: ArchConfig, params, batch, tp=None, dp=None, layout=None,
            cross_layout=None):
    """-> (last-token logits (B,V), cache {k, v (L,B,C,K,hd), kv_pos,
    cross_k, cross_v (L,B,T,K,hd)}).  ``layout`` (``kvcache.CacheLayout``)
    gives the self-attention cache's length C and this rank's part of it
    (by default the prompt's S slots, whole); the prompt's keys fill slots
    0..S-1.  ``cross_layout`` gives the rank's part of the cross cache's T
    frames (by default whole).  With ``tp`` and ``dp`` the layers run as
    ``forward``'s, each cache takes the kv heads its layout holds
    (``kvcache.cache_heads``), and the logits are gathered whole over the
    model axis."""
    mem = encode(cfg, params, batch["frames"], tp, dp)
    x = embed_lookup(params["embed"], batch["tokens"], tp, dp)
    B, S, T = x.shape[0], x.shape[1], mem.shape[1]
    lay = layout or kvc.CacheLayout("whole", S)
    clay = cross_layout or kvc.CacheLayout("whole", T)
    positions = _arange(S, x.device)
    enc_pos = _arange(T, x.device)
    L, Kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    k = torch.zeros((L, B, lay.local, lay.kv_heads(Kv), hd), dtype=x.dtype,
                    device=x.device)
    v = torch.zeros_like(k)
    ck = torch.empty((L, B, clay.local, clay.kv_heads(Kv), hd),
                     dtype=mem.dtype, device=x.device)
    cv = torch.empty_like(ck)
    for i, lp in enumerate(layer_views(params["dec_layers"])):
        def keep(kk, vv, mk, mv, i=i):
            for dst, src, at in ((k, kk, lay), (v, vv, lay), (ck, mk, clay),
                                 (cv, mv, clay)):
                kvc.prefill_kv(dst[i], kvc.cache_heads(src, tp, at), at)
        x = _dec_layer(cfg, lp, x, mem, positions, enc_pos, tp, dp, keep)
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), {
        "k": k, "v": v,
        "kv_pos": kvc.prefilled_layout_pos(B, S, lay, x.device),
        "cross_k": ck, "cross_v": cv}


def _cross_decode(cfg: ArchConfig, lp, x, ck, cv, pos, enc_pos, clay,
                  tp=None):
    """A decode step's cross-attention block over the rank's block ``ck``,
    ``cv`` (B, clay.local, k, hd) of the cross cache: split over its
    frames (``seq``) a non-causal ``attention.seq_attention`` over every
    slot; else the training path's attention on the rank's heads."""
    h = layernorm(lp["ln_x"], x, cfg.norm_eps)
    q = attn.project_q(lp["cross"], h, tp)
    if clay.kind == "seq":
        o = attn.seq_attention(q, ck, cv, None, pos, tp)
    else:
        ck, cv = attn.local_kv(ck, cv, clay, tp, q.shape[2])
        o = _attend(cfg, q, ck, cv, pos[:, None], enc_pos, causal=False)
    return x + attn.project_out(lp["cross"], o, tp)


def decode_step(cfg: ArchConfig, params, cache, batch, tp=None, dp=None,
                layout=None, cross_layout=None):
    """batch: {"token": (B,1) int32, "pos": (B,) int32} -> (logits (B,V),
    cache).  The self-attention cache is updated in place
    (``attention.decode_block``); the cross cache is only read.
    ``layout`` and ``cross_layout``: the caches' (``prefill``'s), by
    default whole; ``tp`` and ``dp`` as in ``prefill``."""
    token, pos = batch["token"], batch["pos"]
    x = embed_lookup(params["embed"], token, tp, dp)
    lay = layout or kvc.CacheLayout("whole", cache["k"].shape[2])
    clay = cross_layout or kvc.CacheLayout("whole",
                                           cache["cross_k"].shape[2])
    slots = kvc.token_slot(pos, lay)
    kv_pos = cache["kv_pos"]
    kvc.write_token(kv_pos, slots, pos)
    enc_pos = _arange(cache["cross_k"].shape[2], x.device)
    for i, lp in enumerate(layer_views(params["dec_layers"])):
        lp = fsdp.whole(dp, lp, "dec_layers", lead=1)
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        x = x + attn.decode_block(lp["attn"], h, cache["k"][i],
                                  cache["v"][i], kv_pos, pos, slots,
                                  cfg.rope_theta, None, lay, tp)
        x = _cross_decode(cfg, lp, x, cache["cross_k"][i],
                          cache["cross_v"][i], pos, enc_pos, clay, tp)
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        x = x + gelu_mlp(lp["mlp"], h, tp)
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), cache
