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
Each layer's attention and feed-forward run as the blocks ``fl/attention``
and ``fl/ffn`` (``obs.spans.block``: profiler ranges that follow them into
the backward); ``trunk`` is the forward up to the head, which
``model_api.loss_fn`` runs as ``fl/head``.

``forward`` takes an optional ``tp`` (``dist.tensor_parallel.ModelAxis``):
the parameters are then this rank's blocks of a client's, split over the
mesh's ``model`` axis, and the layers run tensor-parallel (the logits it
returns are the rank's vocab rows, or whole where the vocab stays whole):
the dense family, the MoE family with its leading dense layers, its
experts (expert or intra-expert parallelism, or whole) and its shared
expert, and the VLM family with its patch projection row-parallel over
``feat_dim`` (``_embed_inputs``).  Each block whose dim the axis leaves
whole runs its plain code on every rank (``tensor_parallel.along``).

It also takes an optional ``dp`` (``dist.fsdp.DataAxis``, the ``shared``
mode): the parameters are then also split over the client's ``data``
ranks on their ``embed`` dim, and the batch is the rank's rows of the
client's.  Each layer gathers its weights whole on ``data`` inside the
function that ``checkpoint`` wraps (remat gathers them again in the
backward), and the embedding tables are gathered where they are used;
the attention's projections and ``swiglu`` receive them gathered.  The
MoE layer routes the client's whole batch (``models/moe``).

``prefill`` and ``decode_step`` take the same ``tp`` and ``dp`` to serve
on ranks (``serve/engine.py``), and the cache's ``layout``
(``kvcache.CacheLayout``): prefill runs ``forward``'s layer code and lays
each layer's keys and values into the rank's block of the cache
(``kvcache.cache_heads``, ``prefill_kv``); decode writes the token's keys
on the rank that holds its slot and attends with
``attention.decode_block``.  The last-token logits are gathered whole over
the model axis (``layers.last_logits``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models.layers import (embed_decl, embed_lookup,
                                       last_logits, logits_out, rmsnorm,
                                       rmsnorm_decl, swiglu, swiglu_decl)
from repro_torch.models.moe import moe_apply, moe_decl
from repro_torch.obs import spans


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

def _ffn(x, cfg: ArchConfig, lp, kind: str, tp=None, dp=None):
    if kind == "moe":
        return moe_apply(cfg, lp["moe"], x, tp, dp)
    return swiglu(lp["mlp"], x, tp), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)


def _apply_layer(cfg: ArchConfig, lp, x, positions, kind: str, keep=None,
                 tp=None, dp=None, path: str = "layers"):
    """One layer; with ``keep`` (prefill) its keys and values are handed
    to ``keep(k, v)``.  With ``tp`` the layer's parameters are the rank's
    blocks (local heads and mlp columns); with ``dp`` they are also split
    on ``data``, and are gathered here (``path`` names the stack, whose
    leaves' specs say which dim)."""
    lp = fsdp.whole(dp, lp, path, lead=1)
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + spans.block("fl/attention", _attention, h, cfg, lp["attn"],
                        positions, keep, tp)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    y, aux = spans.block("fl/ffn", _ffn, h2, cfg, lp, kind, tp, dp)
    return x + y, aux


def _attention(h, cfg: ArchConfig, p, positions, keep=None, tp=None):
    """The attention block: the normed input ``h`` through the output
    projection."""
    q, k, v = attn.project_qkv(p, h, positions, cfg.rope_theta, tp=tp)
    if keep is not None:
        keep(k, v)
    o = attn.attention(q, k, v, positions, positions, causal=True,
                       window=cfg.window, chunk=cfg.attn_chunk,
                       chunk_threshold=cfg.attn_chunk_threshold)
    return attn.project_out(p, o, tp)


def _apply_layer_decode(cfg: ArchConfig, lp, x, k_l, v_l, kv_pos, pos,
                        slots, kind: str, lay, tp=None, dp=None,
                        path: str = "layers"):
    """x: (B,1,D); k_l/v_l: (B, lay.local, k, hd) views of the cache,
    written in place at ``slots``; pos: (B,)."""
    lp = fsdp.whole(dp, lp, path, lead=1)
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + attn.decode_block(lp["attn"], h, k_l, v_l, kv_pos, pos, slots,
                              cfg.rope_theta, cfg.window, lay, tp)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    y, _ = _ffn(h2, cfg, lp, kind, tp, dp)
    return x + y


# --------------------------------------------------------------------------
# Embedding (with optional modality injection)
# --------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params, batch, tp=None, dp=None):
    """Token embeddings; for the VLM family the RMS-normed, projected
    ``patches`` (B, n, feat_dim) replace the first n positions.  The
    projection runs in the weight's dtype (the reference's einsum promotes
    bf16 patches against f32 weights) and lands in the embedding's.  Its
    weight is declared (``mlp``, ``embed``): with ``tp`` splitting
    ``feat_dim`` it is row-parallel over the rank's ``feat_dim`` rows, the
    replicated norm's output taken through ``copy_to_model`` before the
    rank keeps its columns (so the norm gets its whole gradient on every
    rank), and where ``feat_dim`` stays whole every rank projects whole;
    with ``dp`` the weight is gathered on ``data`` first."""
    x = embed_lookup(params["embed"], batch["tokens"], tp, dp)
    if cfg.family == "vlm" and "patches" in batch:
        vp = fsdp.whole(dp, params["vis_proj"], "vis_proj")
        w = vp["w"]
        vis = rmsnorm(vp["norm"], batch["patches"], cfg.norm_eps).to(w.dtype)
        fp = tpar.along(tp, "vis")
        if fp is None:
            vis = vis @ w
        else:
            vis = tpar.copy_to_model(vis, fp).narrow(
                -1, fp.rank * w.shape[0], w.shape[0])
            vis = tpar.row_parallel(vis, w, fp)
        x = torch.cat([vis.to(x.dtype), x[:, vis.shape[1]:]], dim=1)
    return x


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _stacks(cfg: ArchConfig, params):
    """[(stacked layer params, kind, path)] in layer order: Kimi's leading
    dense layers, then the uniform stack."""
    out = [(params["dense_layers"], "dense", "dense_layers")] \
        if n_dense_layers(cfg) else []
    return out + [(params["layers"], "moe" if cfg.moe else "dense",
                   "layers")]


def layer_views(stacked):
    """Each layer's parameters, as views of the stacked leaves."""
    for i in range(T.leaves(stacked)[0].shape[0]):
        yield T.tree_map(lambda a: a[i], stacked)


def _layers(cfg: ArchConfig, params):
    """(layer params, kind, stack path) of every layer in order."""
    for stacked, kind, path in _stacks(cfg, params):
        for lp in layer_views(stacked):
            yield lp, kind, path


def _run_layers(cfg: ArchConfig, stacked, x, positions, kind: str,
                tp=None, dp=None, path: str = "layers"):
    """The layers of one stack in order -> (x, their auxiliary losses
    summed from 0, in layer order, as the reference's scan carries it)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_views(stacked):
        if cfg.remat:
            x, a = checkpoint(_apply_layer, cfg, lp, x, positions, kind,
                              None, tp, dp, path, use_reentrant=False)
        else:
            x, a = _apply_layer(cfg, lp, x, positions, kind, tp=tp, dp=dp,
                                path=path)
        aux = aux + a
    return x, aux


def trunk(cfg: ArchConfig, params, batch, tp=None, dp=None):
    """Full-sequence forward up to the head -> (the final norm's output
    (B,S,D), aux_loss); with ``dp`` the batch is this rank's rows of its
    client's, and so is the output."""
    x = _embed_inputs(cfg, params, batch, tp, dp)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stacked, kind, path in _stacks(cfg, params):
        x, a = _run_layers(cfg, stacked, x, positions, kind, tp, dp, path)
        aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux  # never on data


def forward(cfg: ArchConfig, params, batch, tp=None, dp=None):
    """Full-sequence forward -> (logits (B,S,V), aux_loss); with ``tp``
    the logits are this rank's (B, S, V / M) vocab rows; with ``dp`` the
    batch is this rank's rows of its client's, and so are the logits."""
    x, aux = trunk(cfg, params, batch, tp, dp)
    return logits_out(params["embed"], x, tp, dp), aux


def prefill(cfg: ArchConfig, params, batch, tp=None, dp=None, layout=None):
    """-> (last-token logits (B,V), cache {k, v (L,B,C,K,hd), kv_pos}).
    ``layout`` (``kvcache.CacheLayout``) gives the cache's length C and
    this rank's part of it (by default the prompt's S slots, whole); the
    prompt's keys fill slots 0..S-1, the rest stay empty.  With ``tp`` and
    ``dp`` the layers run as ``forward``'s, the rank's kv heads are laid
    into its block (``kvcache.cache_heads``), and the logits are gathered
    whole over the model axis."""
    x = _embed_inputs(cfg, params, batch, tp, dp)
    B, S = x.shape[0], x.shape[1]
    lay = layout or kvc.CacheLayout("whole", S)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    shape = (cfg.n_layers, B, lay.local, lay.kv_heads(cfg.n_kv_heads),
             cfg.head_dim)
    k = torch.zeros(shape, dtype=x.dtype, device=x.device)
    v = torch.zeros_like(k)
    for i, (lp, kind, path) in enumerate(_layers(cfg, params)):
        def keep(kk, vv, i=i):
            kvc.prefill_kv(k[i], kvc.cache_heads(kk, tp, lay), lay)
            kvc.prefill_kv(v[i], kvc.cache_heads(vv, tp, lay), lay)
        x, _ = _apply_layer(cfg, lp, x, positions, kind, keep, tp, dp, path)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), {
        "k": k, "v": v,
        "kv_pos": kvc.prefilled_layout_pos(B, S, lay, x.device)}


def decode_step(cfg: ArchConfig, params, cache, batch, tp=None, dp=None,
                layout=None):
    """batch: {"token": (B,1) int32, "pos": (B,) int32} -> (logits (B,V),
    cache).  The cache's tensors are updated in place and returned.
    ``layout``: the cache's (``prefill``'s), by default whole."""
    token, pos = batch["token"], batch["pos"]
    x = embed_lookup(params["embed"], token, tp, dp)
    lay = layout or kvc.CacheLayout("whole", cache["k"].shape[2])
    slots = kvc.token_slot(pos, lay)
    kv_pos = cache["kv_pos"]
    kvc.write_token(kv_pos, slots, pos)
    for i, (lp, kind, path) in enumerate(_layers(cfg, params)):
        x = _apply_layer_decode(cfg, lp, x, cache["k"][i], cache["v"][i],
                                kv_pos, pos, slots, kind, lay, tp, dp, path)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), cache
