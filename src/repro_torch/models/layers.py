"""Shared neural-net building blocks (plain PyTorch, decl-based params)."""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import decl


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_decl(d_model: int):
    return {"scale": decl((d_model,), (None,), init="ones",
                          dtype=torch.float32)}


def rmsnorm(params, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def layernorm_decl(d_model: int):
    return {"scale": decl((d_model,), (None,), init="ones",
                          dtype=torch.float32),
            "bias": decl((d_model,), (None,), init="zeros",
                         dtype=torch.float32)}


def layernorm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)   # jnp.var: population
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Apply RoPE.  x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq                       # (..., S, half)
    ang = ang[..., None, :]                                         # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2, x[..., 2 * half:].float()], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu_decl(d_model: int, d_ff: int):
    return {
        "w_gate": decl((d_model, d_ff), ("embed", "mlp")),
        "w_up": decl((d_model, d_ff), ("embed", "mlp")),
        "w_down": decl((d_ff, d_model), ("mlp", "embed")),
    }


def swiglu(params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def gelu_mlp_decl(d_model: int, d_ff: int):
    return {
        "w_in": decl((d_model, d_ff), ("embed", "mlp")),
        "b_in": decl((d_ff,), ("mlp",), init="zeros", dtype=torch.float32),
        "w_out": decl((d_ff, d_model), ("mlp", "embed")),
        "b_out": decl((d_model,), (None,), init="zeros", dtype=torch.float32),
    }


def gelu_mlp(params, x):
    """``jax.nn.gelu``'s default is the tanh approximation (PyTorch's is
    erf), computed in f32; the f32 biases are cast to x's dtype."""
    h = x @ params["w_in"] + params["b_in"].to(x.dtype)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_out"] + params["b_out"].to(x.dtype)


# --------------------------------------------------------------------------
# Embeddings / logits
# --------------------------------------------------------------------------

def pad_vocab(vocab: int, multiple: int = 128) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def embed_decl(vocab: int, d_model: int):
    return {
        "in_table": decl((pad_vocab(vocab), d_model), ("vocab", "embed_tp"),
                         init="embed"),
        "out_table": decl((pad_vocab(vocab), d_model), ("vocab", "embed"),
                          init="embed"),
    }


def embed_lookup(params, tokens):
    return params["in_table"][tokens.long()]


def logits_out(params, x):
    return x @ params["out_table"].t()
