"""Decoder-only backbone, dense and MoE families: optional leading dense
layers (Kimi-K2 ``first_k_dense``), GQA attention with optional sliding
window and QKV bias, RoPE, SwiGLU or MoE FFN, vocab-parallel logits.

The reference's ``lax.scan`` over stacked layer parameters becomes a loop
over the layer index on views of the stacked ``(L, ...)`` leaves, and
``cfg.remat`` becomes ``torch.utils.checkpoint`` per layer.

VLM layers, ``prefill`` and ``decode_step`` wait for later slices.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import stack
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_decl, embed_lookup, logits_out,
                                       rmsnorm, rmsnorm_decl, swiglu,
                                       swiglu_decl)
from repro_torch.models.moe import moe_apply, moe_decl


def _check_family(cfg: ArchConfig):
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the decoder takes the "
            "dense and MoE families (see ROADMAP.md)")


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
    _check_family(cfg)
    decls = {
        "embed": embed_decl(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_decl(cfg.d_model),
    }
    nd = n_dense_layers(cfg)
    if nd:
        decls["dense_layers"] = stack(_layer_decl(cfg, "dense"), nd)
    kind = "moe" if cfg.moe else "dense"
    decls["layers"] = stack(_layer_decl(cfg, kind), cfg.n_layers - nd)
    return decls


# --------------------------------------------------------------------------
# Layer application
# --------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, lp, x, kind: str):
    if kind == "moe":
        return moe_apply(cfg, lp["moe"], x)
    return swiglu(lp["mlp"], x), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def _apply_layer(cfg: ArchConfig, lp, x, positions, kind: str):
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta)
    o = attn.attention(q, k, v, positions, positions, causal=True,
                       window=cfg.window, chunk=cfg.attn_chunk,
                       chunk_threshold=cfg.attn_chunk_threshold)
    x = x + attn.project_out(lp["attn"], o)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    y, aux = _ffn(cfg, lp, h2, kind)
    return x + y, aux


def _run_layers(cfg: ArchConfig, stacked, x, positions, kind: str):
    """The layers of one stack in order -> (x, their auxiliary losses
    summed from 0, in layer order, as the reference's scan carries it)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(T.leaves(stacked)[0].shape[0]):
        lp = T.tree_map(lambda a: a[i], stacked)
        if cfg.remat:
            x, a = checkpoint(_apply_layer, cfg, lp, x, positions, kind,
                              use_reentrant=False)
        else:
            x, a = _apply_layer(cfg, lp, x, positions, kind)
        aux = aux + a
    return x, aux


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward -> (logits (B,S,V), aux_loss)."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if n_dense_layers(cfg):
        x, a = _run_layers(cfg, params["dense_layers"], x, positions, "dense")
        aux = aux + a
    kind = "moe" if cfg.moe else "dense"
    x, a = _run_layers(cfg, params["layers"], x, positions, kind)
    aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x), aux
