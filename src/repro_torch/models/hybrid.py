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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import linear_attn as la
from repro_torch.models.layers import (embed_decl, embed_lookup, logits_out,
                                       rmsnorm, rmsnorm_decl, swiglu,
                                       swiglu_decl)

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


def _ssm_branch(cfg, sp, h, s0=None, conv_state=None, chunk=None):
    """h: (B,S,D) normed input -> (out (B,S,D), new SSM state, new conv
    state)."""
    B, S, D = h.shape
    H, hd, N, Din = _dims(cfg)
    u = _proj(h, sp["in_w"])
    z = _proj(h, sp["z_w"])
    uc, new_conv = _causal_conv(u.reshape(B, S, Din), sp["conv_w"],
                                sp["conv_b"], conv_state)
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
    out = y.reshape(B, S, Din) @ sp["out_w"].reshape(Din, D)
    return out, s_fin, new_conv


def _apply_layer(cfg, lp, x, positions, cache=None):
    """One layer; with ``cache`` (the layer's views of a serving cache:
    k, v (B,W,K,hd), ssm_S, conv) the last W keys and values and the SSM
    and conv states are copied there (prefill)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta)
    o = attn.attention(q, k, v, positions, positions, causal=True,
                       window=cfg.window, chunk=cfg.attn_chunk,
                       chunk_threshold=cfg.attn_chunk_threshold)
    a_out = attn.project_out(lp["attn"], o)
    s_out, s_fin, conv = _ssm_branch(cfg, lp["ssm"], h)
    if cache is not None:
        W = cache["k"].shape[1]
        for key, t in (("k", k[:, -W:]), ("v", v[:, -W:]), ("ssm_S", s_fin),
                       ("conv", conv)):
            cache[key].copy_(t)
    x = x + 0.5 * (a_out + s_out)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2)


def _apply_layer_decode(cfg, lp, x, cache, kv_pos, pos, slot):
    """x: (B,1,D); cache: the layer's views of the cache, updated in
    place; pos: (B,)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, pos[:, None], cfg.rope_theta)
    kvc.update_kv_layer(cache["k"], cache["v"], k, v, slot)
    o = attn.decode_attention(q, cache["k"], cache["v"], kv_pos, pos,
                              window=cfg.window)
    a_out = attn.project_out(lp["attn"], o)
    s_out, s_new, conv_new = _ssm_branch(cfg, lp["ssm"], h,
                                         s0=cache["ssm_S"],
                                         conv_state=cache["conv"], chunk=1)
    cache["ssm_S"].copy_(s_new)
    cache["conv"].copy_(conv_new)
    x = x + 0.5 * (a_out + s_out)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2)


_LAYER_KEYS = ("k", "v", "ssm_S", "conv")


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward -> (logits (B,S,V), aux_loss)."""
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


def prefill(cfg: ArchConfig, params, batch):
    """-> (last-token logits (B,V), cache {k, v, kv_pos, ssm_S, conv})
    holding the last W = min(window, S) keys at slots 0..W-1."""
    x = embed_lookup(params["embed"], batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    W = min(cfg.window or S, S)
    H, hd, N, Din = _dims(cfg)
    L, dev = cfg.n_layers, x.device
    cache = {
        "k": torch.empty((L, B, W, cfg.n_kv_heads, hd), dtype=x.dtype,
                         device=dev),
        "ssm_S": torch.empty((L, B, H, N, hd), dtype=torch.float32,
                             device=dev),
        "conv": torch.empty((L, B, CONV_W - 1, Din), dtype=x.dtype,
                            device=dev),
        "kv_pos": kvc.prefilled_pos(B, W, dev, start=S - W)}
    cache["v"] = torch.empty_like(cache["k"])
    stacked = params["layers"]
    for i in range(L):
        lp = T.tree_map(lambda a: a[i], stacked)
        x = _apply_layer(cfg, lp, x, positions,
                         cache={key: cache[key][i] for key in _LAYER_KEYS})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x[:, -1]), cache


def decode_step(cfg: ArchConfig, params, cache, batch):
    """batch: {"token": (B,1) int32, "pos": (B,) int32} -> (logits (B,V),
    cache); the cache's tensors are updated in place and returned."""
    token, pos = batch["token"], batch["pos"]
    x = embed_lookup(params["embed"], token)
    cache_len = cache["k"].shape[2]
    slot = kvc.cache_slot(pos, cache_len)
    kv_pos = kvc.update_kv_pos(cache["kv_pos"], pos, cache_len)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda a: a[i], stacked)
        x = _apply_layer_decode(
            cfg, lp, x, {key: cache[key][i] for key in _LAYER_KEYS},
            kv_pos, pos, slot)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_out(params["embed"], x[:, -1]), cache
