"""Shared neural-net building blocks (plain PyTorch, decl-based params).

``swiglu``, ``gelu_mlp``, ``embed_lookup`` and ``logits_out`` take an
optional ``tp`` (``dist.tensor_parallel.ModelAxis``): their parameters
are then this rank's part of a client's, split over the ``model`` axis,
and they run column-parallel, row-parallel and vocab-parallel.  Without it,
or where the axis leaves their block whole (``tensor_parallel.along``:
the MLP's width, the padded vocab), they are the plain single-device
functions.  ``embed_lookup``, ``logits_out`` and
``last_logits`` also take a ``dp`` (``dist.fsdp.DataAxis``, shared mode):
they gather their table over ``data`` first (``fsdp.whole``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
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


def swiglu(params, x, tp=None, block: str = "mlp"):
    """With ``tp`` splitting ``block`` (the FFN's width, or ``shared``, an
    MoE config's shared expert): ``w_gate``/``w_up`` column-parallel (this
    rank's mlp columns), ``w_down`` row-parallel (its rows, summed over the
    model axis)."""
    tp = tpar.along(tp, block)
    if tp is not None:
        x = tpar.copy_to_model(x, tp)
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    if tp is not None:
        return tpar.row_parallel(h, params["w_down"], tp)
    return h @ params["w_down"]


def gelu_mlp_decl(d_model: int, d_ff: int):
    return {
        "w_in": decl((d_model, d_ff), ("embed", "mlp")),
        "b_in": decl((d_ff,), ("mlp",), init="zeros", dtype=torch.float32),
        "w_out": decl((d_ff, d_model), ("mlp", "embed")),
        "b_out": decl((d_model,), (None,), init="zeros", dtype=torch.float32),
    }


def gelu_mlp(params, x, tp=None):
    """``jax.nn.gelu``'s default is the tanh approximation (PyTorch's is
    erf), computed in f32; the f32 biases are cast to x's dtype.  With
    ``tp``, ``swiglu``'s form: ``w_in`` and its bias ``b_in`` (both on
    ``mlp``) column-parallel, ``w_out`` row-parallel, and the replicated
    ``b_out`` added once, after the sum over the model axis.  Where the
    axis leaves the width whole, the plain MLP on every rank."""
    tp = tpar.along(tp, "mlp")
    if tp is not None:
        x = tpar.copy_to_model(x, tp)
    h = x @ params["w_in"] + params["b_in"].to(x.dtype)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = h @ params["w_out"] if tp is None else \
        tpar.row_parallel(h, params["w_out"], tp)
    return y + params["b_out"].to(x.dtype)


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


def _table(params, name, dp):
    """The embedding table ``name``, gathered over ``dp``'s data axis
    where its spec splits it there (shared mode)."""
    return fsdp.whole(dp, params[name], "embed/" + name)


def embed_lookup(params, tokens, tp=None, dp=None):
    table = _table(params, "in_table", dp)
    tp = tpar.along(tp, "vocab")
    if tp is not None:              # this rank's vocab rows
        return tpar.embed_lookup(table, tokens, tp)
    return table[tokens.long()]


def last_logits(params, x, tp=None, dp=None):
    """Serving's logits of the last position x (B, D) -> (B, V), with
    ``tp`` gathered whole over the model axis (the padded vocab columns
    included, as on one device), so every rank takes the same argmax;
    where the vocab stays whole every rank computes them whole."""
    tp = tpar.along(tp, "vocab")
    out = logits_out(params, x, tp, dp)
    return out if tp is None else tpar.gather_from_model(out, tp, -1)


def logits_out(params, x, tp=None, dp=None):
    """-> (..., V) logits, or with ``tp`` splitting the vocab this rank's
    (..., V / M) vocab rows (``tensor_parallel.cross_entropy`` reads
    them)."""
    tp = tpar.along(tp, "vocab")
    if tp is not None:
        x = tpar.copy_to_model(x, tp)
    return x @ _table(params, "out_table", dp).t()
