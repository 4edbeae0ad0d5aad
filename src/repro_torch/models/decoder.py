"""Decoder-only backbone, dense, MoE and VLM families: optional leading
dense layers (Kimi-K2 ``first_k_dense``), optional visual token injection
(InternVL2: projected patch embeddings fill the leading positions), GQA
attention with optional sliding window and QKV bias, RoPE, SwiGLU or MoE
FFN, vocab-parallel logits.

Three entry points: ``forward`` (train), ``prefill`` (last-token logits
and a filled KV cache) and ``decode_step`` (one token against the cache,
which it updates in place).

The reference's ``lax.scan`` over stacked layer parameters becomes a loop
over the layer index on views of the stacked ``(L, ...)`` leaves, and
``cfg.remat`` becomes ``torch.utils.checkpoint`` per layer in training.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models.layers import (embed_decl, embed_lookup, logits_out,
                                       rmsnorm, rmsnorm_decl, swiglu,
                                       swiglu_decl)
from repro_torch.models.moe import moe_apply, moe_decl


# --------------------------------------------------------------------------
# Declarations
# --------------------------------------------------------------------------

def _layer_decl(cfg: ArchConfig, kind: str):
    d = {
        "ln1": rmsnorm_decl(cfg.d_model),
        "attn": attn.attention_decl(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.qkv_bias),
        "ln2": rmsnorm_decl(cfg.d_model),
    }
    if kind == "moe":
        d["moe"] = moe_decl(cfg)
    else:
        ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.first_k_dense)
              else cfg.d_ff)
        d["mlp"] = swiglu_decl(cfg.d_model, ff)
    return d


def n_dense_layers(cfg: ArchConfig) -> int:
    return cfg.moe.first_k_dense if cfg.moe else 0


def param_decls(cfg: ArchConfig):
    decls = {
        "embed": embed_decl(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_decl(cfg.d_model),
    }
    nd = n_dense_layers(cfg)
    if nd:
        decls["dense_layers"] = stack(_layer_decl(cfg, "dense"), nd)
    kind = "moe" if cfg.moe else "dense"
    decls["layers"] = stack(_layer_decl(cfg, kind), cfg.n_layers - nd)
    if cfg.family == "vlm":
        fe = cfg.frontend
        decls["vis_proj"] = {
            "w": decl((fe.feat_dim, cfg.d_model), ("mlp", "embed")),
            "norm": rmsnorm_decl(fe.feat_dim),
        }
    return decls


def cache_decl(cfg: ArchConfig, batch: int, cache_len: int):
    return kvc.kv_cache_decl(cfg.n_layers, batch, cache_len,
                             cfg.n_kv_heads, cfg.head_dim)


# --------------------------------------------------------------------------
# Layer application
# --------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, lp, x, kind: str):
    if kind == "moe":
        return moe_apply(cfg, lp["moe"], x)
    return swiglu(lp["mlp"], x), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def _apply_layer(cfg: ArchConfig, lp, x, positions, kind: str, kv_out=None):
    """One layer; with ``kv_out`` (two (B,S,K,hd) views of a cache) its
    keys and values are copied there (prefill)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta)
    if kv_out is not None:
        kv_out[0].copy_(k)
        kv_out[1].copy_(v)
    o = attn.attention(q, k, v, positions, positions, causal=True,
                       window=cfg.window, chunk=cfg.attn_chunk,
                       chunk_threshold=cfg.attn_chunk_threshold)
    x = x + attn.project_out(lp["attn"], o)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    y, aux = _ffn(cfg, lp, h2, kind)
    return x + y, aux


def _apply_layer_decode(cfg: ArchConfig, lp, x, k_l, v_l, kv_pos, pos,
                        slot, kind: str):
    """x: (B,1,D); k_l/v_l: (B,S,K,hd) views of the cache, written in
    place; pos: (B,)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, pos[:, None], cfg.rope_theta)
    kvc.update_kv_layer(k_l, v_l, k, v, slot)
    o = attn.decode_attention(q, k_l, v_l, kv_pos, pos, window=cfg.window)
    x = x + attn.project_out(lp["attn"], o)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    y, _ = _ffn(cfg, lp, h2, kind)
    return x + y


# --------------------------------------------------------------------------
# Embedding (with optional modality injection)
# --------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params, batch):
    """Token embeddings; for the VLM family the RMS-normed, projected
    ``patches`` (B, n, feat_dim) replace the first n positions.  The
    projection runs in the weight's dtype (the reference's einsum promotes
    bf16 patches against f32 weights) and lands in the embedding's."""
    x = embed_lookup(params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        vp = params["vis_proj"]
        vis = rmsnorm(vp["norm"], batch["patches"], cfg.norm_eps)
        vis = (vis.to(vp["w"].dtype) @ vp["w"]).to(x.dtype)
        x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
    return x


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _stacks(cfg: ArchConfig, params):
    """[(stacked layer params, kind)] in layer order: Kimi's leading dense
    layers, then the uniform stack."""
    out = [(params["dense_layers"], "dense")] if n_dense_layers(cfg) else []
    return out + [(params["layers"], "moe" if cfg.moe else "dense")]


def layer_views(stacked):
    """Each layer's parameters, as views of the stacked leaves."""
    for i in range(T.leaves(stacked)[0].shape[0]):
        yield T.tree_map(lambda a: a[i], stacked)


def _layers(cfg: ArchConfig, params):
    """(layer params, kind) of every layer in order."""
    for stacked, kind in _stacks(cfg, params):
        for lp in layer_views(stacked):
            yield lp, kind


def _run_layers(cfg: ArchConfig, stacked, x, positions, kind: str):
    """The layers of one stack in order -> (x, their auxiliary losses
    summed from 0, in layer order, as the reference's scan carries it)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_views(stacked):
        if cfg.remat:
            x, a = checkpoint(_apply_layer, cfg, lp, x, positions, kind,
                              use_reentrant=False)
        else:
            x, a = _apply_layer(cfg, lp, x, positions, kind)
        aux = aux + a
    return x, aux


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward -> (logits (B,S,V), aux_loss)."""
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stacked, kind in _stacks(cfg, params):
        x, a = _run_layers(cfg, stacked, x, positions, kind)
        aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x), aux


def prefill(cfg: ArchConfig, params, batch):
    """-> (last-token logits (B,V), cache {k, v (L,B,S,K,hd), kv_pos})."""
    x = _embed_inputs(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    k = torch.empty(shape, dtype=x.dtype, device=x.device)
    v = torch.empty_like(k)
    for i, (lp, kind) in enumerate(_layers(cfg, params)):
        x, _ = _apply_layer(cfg, lp, x, positions, kind, kv_out=(k[i], v[i]))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_out(params["embed"], x[:, -1])
    return logits, {"k": k, "v": v,
                    "kv_pos": kvc.prefilled_pos(B, S, x.device)}


def decode_step(cfg: ArchConfig, params, cache, batch):
    """batch: {"token": (B,1) int32, "pos": (B,) int32} -> (logits (B,V),
    cache).  The cache's tensors are updated in place and returned."""
    token, pos = batch["token"], batch["pos"]
    x = embed_lookup(params["embed"], token)
    cache_len = cache["k"].shape[2]
    slot = kvc.cache_slot(pos, cache_len)
    kv_pos = kvc.update_kv_pos(cache["kv_pos"], pos, cache_len)
    for i, (lp, kind) in enumerate(_layers(cfg, params)):
        x = _apply_layer_decode(cfg, lp, x, cache["k"][i], cache["v"][i],
                                kv_pos, pos, slot, kind)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x[:, -1]), cache
