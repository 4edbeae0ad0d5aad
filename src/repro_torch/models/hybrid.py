"""Hymba-style hybrid: parallel attention + SSM heads per layer.

Attention branch: GQA with sliding window + RoPE (``attention.attention``;
above ``attn_chunk_threshold`` the flash kernel with a window).  SSM
branch: selective state-space in SSD form (scalar per-head decay, state
size ``ssm_state``); it shares the chunked linear-attention core with
RWKV6 (the WKV kernel with u=None).  Branch outputs are averaged (Hymba's
fused parallel heads), then SwiGLU MLP.

As in ``decoder.py``, the layer loop runs over views of the stacked
leaves, with ``cfg.remat`` as ``torch.utils.checkpoint`` per layer.
``cache_decl``, ``prefill``, ``decode_step`` and the decode state they
carry (the SSM and conv states) wait for the serving slice (they need
``kvcache``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import decl, stack
from repro_torch.models import attention as attn
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


# --------------------------------------------------------------------------

def _proj(x, w):
    """x (B,S,D) @ w (D,H,n) -> (B,S,H,n)."""
    D, H, n = w.shape
    return (x @ w.reshape(D, H * n)).reshape(*x.shape[:-1], H, n)


def _causal_conv(u_flat, w, b):
    """Depthwise causal conv over time, zero history.  u_flat: (B,S,Din);
    w: (CONV_W, Din)."""
    B, S, Din = u_flat.shape
    ext = torch.cat([u_flat.new_zeros((B, CONV_W - 1, Din)), u_flat], dim=1)
    out = sum(ext[:, j:j + S] * w[j].to(u_flat.dtype) for j in range(CONV_W))
    return out + b.to(u_flat.dtype)


def _ssm_branch(cfg, sp, h):
    """h: (B,S,D) normed input -> (B,S,D)."""
    B, S, D = h.shape
    H, hd, N, Din = _dims(cfg)
    u = _proj(h, sp["in_w"])
    z = _proj(h, sp["z_w"])
    uc = _causal_conv(u.reshape(B, S, Din), sp["conv_w"], sp["conv_b"])
    uc = F.silu(uc.float()).to(h.dtype).reshape(B, S, H, hd)
    Bt = _proj(h, sp["B_w"])
    Ct = _proj(h, sp["C_w"])
    dt = F.softplus((h @ sp["dt_w"]).float() + sp["dt_bias"])
    w_log = (-dt * torch.exp(sp["A_log"]))[..., None]      # (B,S,H,1) <= 0
    k = Bt * dt[..., None].to(Bt.dtype)                     # fold dt into k
    y, _ = la.linear_attention(Ct, k, uc, w_log, u=None,
                               chunk=cfg.rwkv_chunk)
    y = y + sp["D_skip"].to(y.dtype) * uc.to(y.dtype)
    # gated per-head rmsnorm (mamba2-style)
    yf = y.float()
    yf = yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-5)
    yf = yf * sp["gn_scale"]
    y = yf.to(h.dtype) * F.silu(z.float()).to(h.dtype)
    return y.reshape(B, S, Din) @ sp["out_w"].reshape(Din, D)


def _apply_layer(cfg, lp, x, positions):
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(lp["attn"], h, positions, cfg.rope_theta)
    o = attn.attention(q, k, v, positions, positions, causal=True,
                       window=cfg.window, chunk=cfg.attn_chunk,
                       chunk_threshold=cfg.attn_chunk_threshold)
    a_out = attn.project_out(lp["attn"], o)
    s_out = _ssm_branch(cfg, lp["ssm"], h)
    x = x + 0.5 * (a_out + s_out)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2)


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
