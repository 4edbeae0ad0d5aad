"""Decoder-only backbone, dense family: GQA attention with optional sliding
window and QKV bias, RoPE, SwiGLU, vocab-parallel logits.

The reference's ``lax.scan`` over stacked layer parameters becomes a loop
over the layer index on views of the stacked ``(L, ...)`` leaves, and
``cfg.remat`` becomes ``torch.utils.checkpoint`` per layer.

MoE and VLM layers, ``prefill`` and ``decode_step`` wait for later slices.
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


def _check_dense(cfg: ArchConfig):
    if cfg.moe is not None or cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} (moe={cfg.moe is not None}) is not ported "
            "yet: only the dense decoder is (see ROADMAP.md)")


# --------------------------------------------------------------------------
# Declarations
# --------------------------------------------------------------------------

def _layer_decl(cfg: ArchConfig):
    return {
        "ln1": rmsnorm_decl(cfg.d_model),
        "attn": attn.attention_decl(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.qkv_bias),
        "ln2": rmsnorm_decl(cfg.d_model),
        "mlp": swiglu_decl(cfg.d_model, cfg.d_ff),
    }


def param_decls(cfg: ArchConfig):
    _check_dense(cfg)
    return {
        "embed": embed_decl(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_decl(cfg.d_model),
        "layers": stack(_layer_decl(cfg), cfg.n_layers),
    }


# --------------------------------------------------------------------------
# Layer application
# --------------------------------------------------------------------------

def _apply_layer(cfg: ArchConfig, lp, x, positions):
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta)
    o = attn.attention(q, k, v, positions, positions, causal=True,
                       window=cfg.window, chunk=cfg.attn_chunk,
                       chunk_threshold=cfg.attn_chunk_threshold)
    x = x + attn.project_out(lp["attn"], o)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2)


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward -> (logits (B,S,V), aux_loss)."""
    _check_dense(cfg)
    x = embed_lookup(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda a: a[i], stacked)
        if cfg.remat:
            x = checkpoint(_apply_layer, cfg, lp, x, positions,
                           use_reentrant=False)
        else:
            x = _apply_layer(cfg, lp, x, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_out(params["embed"], x), aux
