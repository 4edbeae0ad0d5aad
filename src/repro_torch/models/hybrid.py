"""Hymba-style hybrid: parallel attention + SSM heads per layer.

Attention branch: GQA with sliding window + RoPE (``attention.attention``;
above ``attn_chunk_threshold`` the flash kernel with a window).  SSM
branch: selective state-space in SSD form (scalar per-head decay, state
size ``ssm_state``); it shares the chunked linear-attention core with
RWKV6 (the WKV kernel with u=None).  Branch outputs are averaged (Hymba's
fused parallel heads), then SwiGLU MLP.

As in ``decoder.py``, the layer loop runs over views of the stacked
leaves, with ``cfg.remat`` as ``torch.utils.checkpoint`` per layer in
training.  Serving caches, a layer, the last ``W = min(window, S)`` keys
and values (a ring over the window), the SSM state ``ssm_S`` (f32) and
the causal conv's last ``CONV_W - 1`` inputs; ``decode_step`` runs the SSM
branch at T = 1 with ``chunk=1`` and the cached state (the WKV kernel in
SSD form) and updates the cache in place.  Prefill keeps the window's
keys at slots 0..W-1 while decode writes position ``pos`` to slot
``pos % W``, as the reference does (ROADMAP R3).

``forward`` takes an optional ``tp`` (``dist.tensor_parallel.ModelAxis``)
and ``dp`` (``dist.fsdp.DataAxis``), as ``decoder.forward`` does.  Where
the heads split over the model axis, the attention takes the decoder's
tensor-parallel forms and the SSM branch the same: ``in_w``, ``z_w``,
``B_w``, ``C_w`` and ``dt_w`` column-parallel from the normed input (which
crosses ``copy_to_model``), the rank's heads of ``dt_bias``, ``A_log``,
``D_skip`` and ``gn_scale``, the scan on its heads, ``out_w``
row-parallel.  The causal conv's ``conv_w``/``conv_b`` are declared on
``embed``, not on heads, so they are whole on every model rank: the rank
takes its heads' columns of them through ``copy_to_model``.  The two
branches' outputs are each reduced over the axis before they are
averaged, the single device's rounding points.  Where the heads stay
whole (hymba-1.5b's 25 at M = 2 or 4) both branches run whole on every
rank with no collective; the SwiGLU and the vocab split where they
divide the axis, and stay whole too where they do not (at M = 3).  With
``dp`` each layer gathers its leaves' ``embed`` blocks inside the
checkpointed function.  ``prefill`` and ``decode_step`` take them too (serving on
ranks): the window's keys go into the rank's block of the ring
(``kvcache.CacheLayout``, ``attention.decode_block``), the SSM and conv
states hold the rank's heads (all of them where the heads stay whole), and
the last-token logits are gathered whole over the model axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import linear_attn as la
from repro_torch.models.layers import (embed_decl, embed_lookup,
                                       last_logits, logits_out, rmsnorm,
                                       rmsnorm_decl, swiglu, swiglu_decl)

CONV_W = 3


def _dims(cfg: ArchConfig):
    H, hd, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    return H, hd, N, H * hd


def _layer_decl(cfg: ArchConfig):
    D = cfg.d_model
    H, hd, N, Din = _dims(cfg)
    f32 = torch.float32
    return {
        "ln1": rmsnorm_decl(D),
        "attn": attn.attention_decl(D, H, cfg.n_kv_heads, hd),
        "ssm": {
            "in_w": decl((D, H, hd), ("embed", "heads", None)),
            "z_w": decl((D, H, hd), ("embed", "heads", None)),
            "B_w": decl((D, H, N), ("embed", "heads", None)),
            "C_w": decl((D, H, N), ("embed", "heads", None)),
            "dt_w": decl((D, H), ("embed", "heads")),
            "dt_bias": decl((H,), ("heads",), init="const", scale=-1.0,
                            dtype=f32),
            "A_log": decl((H,), ("heads",), init="const", scale=0.5,
                          dtype=f32),
            "D_skip": decl((H, hd), ("heads", None), init="ones", dtype=f32),
            "conv_w": decl((CONV_W, Din), (None, "embed"), init="normal"),
            "conv_b": decl((Din,), ("embed",), init="zeros", dtype=f32),
            "gn_scale": decl((H, hd), ("heads", None), init="ones",
                             dtype=f32),
            "out_w": decl((H, hd, D), ("heads", None, "embed")),
        },
        "ln2": rmsnorm_decl(D),
        "mlp": swiglu_decl(D, cfg.d_ff),
    }


def param_decls(cfg: ArchConfig):
    return {
        "embed": embed_decl(cfg.vocab, cfg.d_model),
        "layers": stack(_layer_decl(cfg), cfg.n_layers),
        "final_norm": rmsnorm_decl(cfg.d_model),
    }


def cache_decl(cfg: ArchConfig, batch: int, cache_len: int):
    H, hd, N, Din = _dims(cfg)
    L = cfg.n_layers
    d = kvc.kv_cache_decl(L, batch, cache_len, cfg.n_kv_heads, hd)
    d["ssm_S"] = decl((L, batch, H, N, hd),
                      ("layers", "batch", "heads", None, None),
                      init="zeros", dtype=torch.float32)
    d["conv"] = decl((L, batch, CONV_W - 1, Din),
                     ("layers", "batch", None, "heads"), init="zeros")
    return d


# --------------------------------------------------------------------------

def _proj(x, w):
    """x (B,S,D) @ w (D,H,n) -> (B,S,H,n)."""
    D, H, n = w.shape
    return (x @ w.reshape(D, H * n)).reshape(*x.shape[:-1], H, n)


def _causal_conv(u_flat, w, b, conv_state=None):
    """Depthwise causal conv over time.  u_flat: (B,S,Din); w: (CONV_W,
    Din); conv_state: the last CONV_W - 1 inputs before u_flat (zeros when
    None).  Returns (out, new conv_state)."""
    B, S, Din = u_flat.shape
    if conv_state is None:
        conv_state = u_flat.new_zeros((B, CONV_W - 1, Din))
    ext = torch.cat([conv_state.to(u_flat.dtype), u_flat], dim=1)
    out = sum(ext[:, j:j + S] * w[j].to(u_flat.dtype) for j in range(CONV_W))
    return out + b.to(u_flat.dtype), ext[:, -(CONV_W - 1):]


def _ssm_branch(cfg, sp, h, s0=None, conv_state=None, chunk=None,
                tp=None):
    """h: (B,S,D) normed input -> (out (B,S,D), new SSM state, new conv
    state).  With ``tp`` splitting the heads, ``sp``'s head leaves are the
    rank's, and the conv's columns are taken for its heads."""
    B, S, D = h.shape
    hp = tpar.along(tp, "heads")
    H, hd = sp["D_skip"].shape
    Din = H * hd
    conv_w, conv_b = sp["conv_w"], sp["conv_b"]
    if hp is not None:
        h = tpar.copy_to_model(h, hp)
        conv_w, conv_b = (tpar.head_columns(tpar.copy_to_model(t, hp), hp)
                          for t in (conv_w, conv_b))
    u = _proj(h, sp["in_w"])
    z = _proj(h, sp["z_w"])
    uc, new_conv = _causal_conv(u.reshape(B, S, Din), conv_w, conv_b,
                                conv_state)
    uc = F.silu(uc.float()).to(h.dtype).reshape(B, S, H, hd)
    Bt = _proj(h, sp["B_w"])
    Ct = _proj(h, sp["C_w"])
    dt = F.softplus((h @ sp["dt_w"]).float() + sp["dt_bias"])
    w_log = (-dt * torch.exp(sp["A_log"]))[..., None]      # (B,S,H,1) <= 0
    k = Bt * dt[..., None].to(Bt.dtype)                     # fold dt into k
    y, s_fin = la.linear_attention(Ct, k, uc, w_log, u=None, s0=s0,
                                   chunk=chunk or cfg.rwkv_chunk)
    y = y + sp["D_skip"].to(y.dtype) * uc.to(y.dtype)
    # gated per-head rmsnorm (mamba2-style)
    yf = y.float()
    yf = yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-5)
    yf = yf * sp["gn_scale"]
    y = yf.to(h.dtype) * F.silu(z.float()).to(h.dtype)
    y, out_w = y.reshape(B, S, Din), sp["out_w"].reshape(Din, D)
    out = y @ out_w if hp is None else tpar.row_parallel(y, out_w, hp)
    return out, s_fin, new_conv


def _apply_layer(cfg, lp, x, positions, keep=None, tp=None, dp=None):
    """One layer; with ``keep`` (prefill) its keys, values, final SSM state
    and conv state are handed to ``keep(k, v, ssm_S, conv)``.  With ``tp``
    the layer's parameters are the rank's blocks; with ``dp`` they are
    gathered on ``data`` here, inside the function ``checkpoint`` wraps."""
    lp = fsdp.whole(dp, lp, "layers", lead=1)
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta,
                               tp=tp)
    o = attn.attention(q, k, v, positions, positions, causal=True,
                       window=cfg.window, chunk=cfg.attn_chunk,
                       chunk_threshold=cfg.attn_chunk_threshold)
    a_out = attn.project_out(lp["attn"], o, tp)
    s_out, s_fin, conv = _ssm_branch(cfg, lp["ssm"], h, tp=tp)
    if keep is not None:
        keep(k, v, s_fin, conv)
    x = x + 0.5 * (a_out + s_out)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2, tp)


def _apply_layer_decode(cfg, lp, x, cache, kv_pos, pos, slots, lay,
                        tp=None, dp=None):
    """x: (B,1,D); cache: the layer's views of the cache, updated in
    place; pos: (B,)."""
    lp = fsdp.whole(dp, lp, "layers", lead=1)
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a_out = attn.decode_block(lp["attn"], h, cache["k"], cache["v"], kv_pos,
                              pos, slots, cfg.rope_theta, cfg.window, lay,
                              tp)
    s_out, s_new, conv_new = _ssm_branch(cfg, lp["ssm"], h,
                                         s0=cache["ssm_S"],
                                         conv_state=cache["conv"], chunk=1,
                                         tp=tp)
    cache["ssm_S"].copy_(s_new)
    cache["conv"].copy_(conv_new)
    x = x + 0.5 * (a_out + s_out)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2, tp)


_LAYER_KEYS = ("k", "v", "ssm_S", "conv")


def forward(cfg: ArchConfig, params, batch, tp=None, dp=None):
    """Full-sequence forward -> (logits (B,S,V), aux_loss); with ``tp``
    the logits are this rank's (B, S, V / M) vocab rows; with ``dp`` the
    batch is this rank's rows of its client's, and so are the logits."""
    x = embed_lookup(params["embed"], batch["tokens"], tp, dp)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda a: a[i], stacked)
        if cfg.remat:
            x = checkpoint(_apply_layer, cfg, lp, x, positions, None, tp, dp,
                           use_reentrant=False)
        else:
            x = _apply_layer(cfg, lp, x, positions, tp=tp, dp=dp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_out(params["embed"], x, tp, dp), aux


def prefill(cfg: ArchConfig, params, batch, tp=None, dp=None, layout=None):
    """-> (last-token logits (B,V), cache {k, v, kv_pos, ssm_S, conv})
    holding the last W = min(window, S) keys at slots 0..W-1.  ``layout``
    (``kvcache.CacheLayout``, of length W) gives this rank's part of the
    keys; the SSM and conv states are the rank's heads' (all of them where
    the heads stay whole).  With ``tp`` and ``dp`` the layers run as
    ``forward``'s and the logits are gathered whole over the model
    axis."""
    x = embed_lookup(params["embed"], batch["tokens"], tp, dp)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    W = min(cfg.window or S, S)
    lay = layout or kvc.CacheLayout("whole", W)
    L, dev = cfg.n_layers, x.device
    cache = {
        "k": torch.zeros((L, B, lay.local, lay.kv_heads(cfg.n_kv_heads),
                          cfg.head_dim), dtype=x.dtype, device=dev),
        "kv_pos": kvc.prefilled_layout_pos(B, W, lay, dev, start=S - W)}
    cache["v"] = torch.zeros_like(cache["k"])
    stacked = params["layers"]
    for i in range(L):
        def keep(k, v, s_fin, conv, i=i):
            kvc.prefill_kv(cache["k"][i], kvc.cache_heads(k[:, -W:], tp, lay),
                           lay)
            kvc.prefill_kv(cache["v"][i], kvc.cache_heads(v[:, -W:], tp, lay),
                           lay)
            for key, t in (("ssm_S", s_fin), ("conv", conv)):
                if key not in cache:
                    cache[key] = t.new_empty((L,) + t.shape)
                cache[key][i].copy_(t)
        lp = T.tree_map(lambda a: a[i], stacked)
        x = _apply_layer(cfg, lp, x, positions, keep, tp, dp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), cache


def decode_step(cfg: ArchConfig, params, cache, batch, tp=None, dp=None,
                layout=None):
    """batch: {"token": (B,1) int32, "pos": (B,) int32} -> (logits (B,V),
    cache); the cache's tensors are updated in place and returned.
    ``layout``: the cache's (``prefill``'s), by default whole."""
    token, pos = batch["token"], batch["pos"]
    x = embed_lookup(params["embed"], token, tp, dp)
    lay = layout or kvc.CacheLayout("whole", cache["k"].shape[2])
    slots = kvc.token_slot(pos, lay)
    kv_pos = cache["kv_pos"]
    kvc.write_token(kv_pos, slots, pos)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda a: a[i], stacked)
        x = _apply_layer_decode(
            cfg, lp, x, {key: cache[key][i] for key in _LAYER_KEYS},
            kv_pos, pos, slots, lay, tp, dp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return last_logits(params["embed"], x[:, -1], tp, dp), cache
