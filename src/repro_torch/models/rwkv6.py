"""RWKV6 ("Finch"): attention-free LM with data-dependent per-channel decay.

Time-mix block: token-shift ddlerp (low-rank adapters) -> r/k/v/g/w
projections -> WKV linear attention (``linear_attn.linear_attention``: the
chunked WKV kernel on a card) -> per-head groupnorm, silu(g) gating, out
proj.  Channel-mix block: token-shift + squared-relu MLP.

As in ``decoder.py``, the reference's ``lax.scan`` over stacked layers is
a loop over views of the ``(L, ...)`` leaves, with ``cfg.remat`` as
``torch.utils.checkpoint`` per layer in training.  Serving carries a state
a layer: the WKV state ``S`` (f32) and the token shifts' previous
activations ``x_tm``/``x_cm`` (in the activations' dtype).  ``prefill``
returns it; ``decode_step`` runs the layer on one token with
``chunk=1`` and the cached state (the WKV kernel at T = 1 with ``s0``),
and writes the new state into the cache in place.

``forward`` takes an optional ``tp`` (``dist.tensor_parallel.ModelAxis``)
and ``dp`` (``dist.fsdp.DataAxis``), as ``decoder.forward`` does.  On the
model axis the token shift, the ddlerp and the decay ``w0 + mw`` (f32)
run whole on every rank; each stream that leaves them for the rank's
heads (``mr``, ``mk``, ``mv``, ``mg`` and the whole decay, before the
rank takes its heads' columns) crosses ``copy_to_model`` once, so ``mu``,
``lora_A``/``lora_B``, ``w0`` and ``ln1`` get their whole gradient on
every rank.  r/k/v/g are column-parallel, the WKV kernel runs on the
rank's heads with their block of ``u``, the groupnorm is local and ``wo``
row-parallel.  The channel mix is ``swiglu``'s form with ``cm.wr``'s
output columns split (declared (embed, mlp)): the rank's columns of the
gate are gathered before ``rr * kv``; ``d_ff`` and ``d_model`` each split
or stay whole alone (rwkv6-7b's 14336 and 4096 at M = 3 both stay whole).
Where the heads stay whole the time mix runs its plain code on every
rank.  With ``dp`` each layer gathers its leaves' ``embed`` blocks
inside the checkpointed function, as the decoder's layers do.
``prefill`` and ``decode_step`` take them too (serving on ranks): the
state ``S`` holds the rank's heads, ``x_tm`` and ``x_cm`` stay whole, and
the last-token logits are gathered whole over the model axis.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import linear_attn as la
from repro_torch.models.layers import (embed_decl, embed_lookup,
                                       last_logits, layernorm,
                                       layernorm_decl, logits_out)

LORA_R = 64
N_MIX = 6  # base + r,k,v,w,g


def _heads(cfg: ArchConfig):
    hd = cfg.rwkv_head_dim
    assert cfg.d_model % hd == 0
    return cfg.d_model // hd, hd


def _layer_decl(cfg: ArchConfig):
    D = cfg.d_model
    H, hd = _heads(cfg)
    r = min(LORA_R, D)
    f32 = torch.float32
    return {
        "ln1": layernorm_decl(D),
        "tm": {
            "mu": decl((N_MIX, D), (None, None), init="const", scale=0.5,
                       dtype=f32),
            "lora_A": decl((5, D, r), (None, "embed", None)),
            "lora_B": decl((5, r, D), (None, None, "embed"), init="zeros"),
            "w0": decl((D,), (None,), init="const", scale=-2.0, dtype=f32),
            "u": decl((H, hd), ("heads", None), init="normal", scale=8.0,
                      dtype=f32),
            "wr": decl((D, H, hd), ("embed", "heads", None)),
            "wk": decl((D, H, hd), ("embed", "heads", None)),
            "wv": decl((D, H, hd), ("embed", "heads", None)),
            "wg": decl((D, H, hd), ("embed", "heads", None)),
            "wo": decl((H, hd, D), ("heads", None, "embed")),
            "gn_scale": decl((H, hd), ("heads", None), init="ones",
                             dtype=f32),
            "gn_bias": decl((H, hd), ("heads", None), init="zeros",
                            dtype=f32),
        },
        "ln2": layernorm_decl(D),
        "cm": {
            "mu_k": decl((D,), (None,), init="const", scale=0.5, dtype=f32),
            "mu_r": decl((D,), (None,), init="const", scale=0.5, dtype=f32),
            "wk": decl((D, cfg.d_ff), ("embed", "mlp")),
            "wv": decl((cfg.d_ff, D), ("mlp", "embed")),
            "wr": decl((D, D), ("embed", "mlp")),
        },
    }


def param_decls(cfg: ArchConfig):
    return {
        "embed": embed_decl(cfg.vocab, cfg.d_model),
        "layers": stack(_layer_decl(cfg), cfg.n_layers),
        "final_norm": layernorm_decl(cfg.d_model),
    }


def cache_decl(cfg: ArchConfig, batch: int, cache_len: int):
    H, hd = _heads(cfg)
    L, D = cfg.n_layers, cfg.d_model
    return {
        "S": decl((L, batch, H, hd, hd),
                  ("layers", "batch", "heads", None, None), init="zeros",
                  dtype=torch.float32),
        "x_tm": decl((L, batch, D), ("layers", "batch", None), init="zeros"),
        "x_cm": decl((L, batch, D), ("layers", "batch", None), init="zeros"),
    }


# --------------------------------------------------------------------------

def _proj(x, w):
    """x (B,S,D) @ w (D,H,hd) -> (B,S,H,hd)."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def _shift(x, x_prev=None):
    """Token shift: the previous token's activation (zeros at t = 0, or
    the carried ``x_prev`` (B,D))."""
    prev = (torch.zeros_like(x[:, :1]) if x_prev is None
            else x_prev[:, None].to(x.dtype))
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(tm, x, xx):
    """Data-dependent lerp -> 5 mixed streams (r,k,v,w,g)."""
    mu = tm["mu"].to(x.dtype)
    base = x + (xx - x) * mu[0]
    t = torch.tanh(torch.einsum("bsd,idr->bsir", base, tm["lora_A"]))
    lora = torch.einsum("bsir,ird->bsid", t, tm["lora_B"])
    mixed = x[:, :, None] + (xx - x)[:, :, None] * (mu[1:][None, None] + lora)
    return [mixed[:, :, i] for i in range(5)]


def _time_mix(cfg, tm, x, x_prev=None, s0=None, chunk=None, tp=None):
    """x: (B,S,D) -> (out (B,S,D), new x_prev (B,D), new state).  With
    ``tp`` splitting the heads, ``tm``'s head leaves are the rank's."""
    B, S, D = x.shape
    hp = tpar.along(tp, "heads")
    H, hd = tm["u"].shape
    xx = _shift(x, x_prev)
    mr, mk, mv, mw, mg = _ddlerp(tm, x, xx)
    # decay: w_log <= 0 always (the chunked form relies on this)
    ww = tm["w0"].float() + mw.float()
    if hp is not None:          # the streams into the rank's heads
        mr, mk, mv, mg = (tpar.copy_to_model(m, hp)
                          for m in (mr, mk, mv, mg))
        ww = tpar.head_columns(tpar.copy_to_model(ww, hp), hp)
    r = _proj(mr, tm["wr"])
    k = _proj(mk, tm["wk"])
    v = _proj(mv, tm["wv"])
    g = torch.nn.functional.silu(_proj(mg, tm["wg"]).float()).to(x.dtype)
    w_log = -torch.exp(torch.clamp(ww, -12.0, 6.0)).reshape(B, S, H, hd)

    o, s_fin = la.linear_attention(r, k, v, w_log, u=tm["u"], s0=s0,
                                   chunk=chunk or cfg.rwkv_chunk)
    # per-head groupnorm (population variance, as jnp.var)
    of = o.float()
    mean = of.mean(dim=-1, keepdim=True)
    var = of.var(dim=-1, keepdim=True, unbiased=False)
    of = (of - mean) * torch.rsqrt(var + 1e-5)
    of = of * tm["gn_scale"] + tm["gn_bias"]
    y = (of.to(x.dtype) * g).reshape(B, S, H * hd)
    wo = tm["wo"].reshape(H * hd, D)
    out = y @ wo if hp is None else tpar.row_parallel(y, wo, hp)
    return out, x[:, -1], s_fin


def _channel_mix(cm, x, x_prev=None, tp=None):
    """With ``tp``: ``cm.wk`` column-parallel and ``cm.wv`` row-parallel
    where ``d_ff`` splits (the ``mlp`` block), and the rank's columns of
    the gate ``cm.wr`` gathered whole where ``d_model`` does (``mlp_r``);
    each runs its plain code where its width stays whole."""
    xx = _shift(x, x_prev)
    mk = cm["mu_k"].to(x.dtype)
    mr = cm["mu_r"].to(x.dtype)
    xk = x + (xx - x) * mk
    xr = x + (xx - x) * mr
    kp, rp = tpar.along(tp, "mlp"), tpar.along(tp, "mlp_r")
    if kp is not None:
        xk = tpar.copy_to_model(xk, kp)
    if rp is not None:
        xr = tpar.copy_to_model(xr, rp)
    k = xk @ cm["wk"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    rr = torch.sigmoid((xr @ cm["wr"]).float()).to(x.dtype)
    kv = k @ cm["wv"] if kp is None else tpar.row_parallel(k, cm["wv"], kp)
    if rp is not None:
        rr = tpar.gather_from_model(rr, rp, -1)
    return rr * kv, x[:, -1]


def _apply_layer(cfg, lp, x, state=None, chunk=None, tp=None, dp=None):
    """state: (S, x_tm, x_cm) of the layer, or None (from scratch).
    Returns (x, new state).  With ``dp`` the layer's leaves are gathered
    on ``data`` here, inside the function ``checkpoint`` wraps."""
    lp = fsdp.whole(dp, lp, "layers", lead=1)
    s0, xp_tm, xp_cm = state if state is not None else (None, None, None)
    tm_out, new_xtm, new_s = _time_mix(
        cfg, lp["tm"], layernorm(lp["ln1"], x, cfg.norm_eps), xp_tm, s0,
        chunk, tp)
    x = x + tm_out
    cm_out, new_xcm = _channel_mix(
        lp["cm"], layernorm(lp["ln2"], x, cfg.norm_eps), xp_cm, tp)
    return x + cm_out, (new_s, new_xtm, new_xcm)


def forward(cfg: ArchConfig, params, batch, tp=None, dp=None):
    """Full-sequence forward -> (logits (B,S,V), aux_loss); with ``tp``
    the logits are this rank's (B, S, V / M) vocab rows; with ``dp`` the
    batch is this rank's rows of its client's, and so are the logits."""
    x = embed_lookup(params["embed"], batch["tokens"], tp, dp)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda a: a[i], stacked)
        if cfg.remat:
            x = checkpoint(_apply_layer, cfg, lp, x, None, None, tp, dp,
                           use_reentrant=False)[0]
        else:
            x = _apply_layer(cfg, lp, x, tp=tp, dp=dp)[0]
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_out(params["embed"], x, tp, dp), aux


def prefill(cfg: ArchConfig, params, batch, tp=None, dp=None, layout=None):
    """-> (last-token logits (B,V), cache {S, x_tm, x_cm}).  With ``tp``
    and ``dp`` the layers run as ``forward``'s, ``S`` holds the rank's
    heads and the logits are gathered whole over the model axis.  RWKV6
    keeps no keys: ``layout`` is unused (the engine passes None)."""
    x = embed_lookup(params["embed"], batch["tokens"], tp, dp)
    L = cfg.n_layers
    cache = {}
    stacked = params["layers"]
    for i in range(L):
        lp = T.tree_map(lambda a: a[i], stacked)
        x, state = _apply_layer(cfg, lp, x, tp=tp, dp=dp)
        for key, t in zip(("S", "x_tm", "x_cm"), state):
            if key not in cache:
                cache[key] = t.new_empty((L,) + t.shape)
            cache[key][i].copy_(t)
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), cache


def decode_step(cfg: ArchConfig, params, cache, batch, tp=None, dp=None,
                layout=None):
    """batch: {"token": (B,1) int32, "pos": (B,)} -> (logits (B,V),
    cache); the cache's tensors are updated in place and returned."""
    x = embed_lookup(params["embed"], batch["token"], tp, dp)   # (B,1,D)
    stacked = params["layers"]
    keys = ("S", "x_tm", "x_cm")
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda a: a[i], stacked)
        x, state = _apply_layer(cfg, lp, x,
                                state=tuple(cache[k][i] for k in keys),
                                chunk=1, tp=tp, dp=dp)
        for key, t in zip(keys, state):
            cache[key][i].copy_(t)
    x = layernorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), cache
