"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made from a numpy seed and handed to both packages; trees cross
between JAX and PyTorch as numpy, with bf16 leaves passed as exact f32."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_shd
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.models import model_api

ARCH = "qwen2-7b"


def smoke_cfgs(**kw):
    """(reference cfg, port cfg): the qwen2-7b smoke config in each package."""
    return (ref_smoke_config(ref_get_arch(ARCH)).replace(**kw),
            smoke_config(get_arch(ARCH)).replace(**kw))


def np_f32(tree):
    """JAX tree -> nested dict of f32 numpy arrays (bf16 exact in f32)."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def ref_params(ref_cfg, seed=0, n_clients=1, f32=True):
    """Reference parameters (numpy), client-stacked when n_clients > 1."""
    decls = ref_model_api.param_decls(ref_cfg)
    if n_clients > 1:
        decls = ref_shd.prepend_axis(decls, n_clients, "clients")
    p = ref_shd.materialize(decls, jax.random.PRNGKey(seed))
    if f32:
        p = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), p)
    return p


def port_params(np_tree, cfg, n_clients=1, dtype=torch.float32):
    decls = model_api.param_decls(cfg)
    if n_clients > 1:
        decls = shd.prepend_axis(decls, n_clients, "clients")
    return shd.from_reference(np_f32(np_tree), decls, "cpu", dtype=dtype)


def tokens(batch, seq, vocab, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, lead + (batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def assert_trees_close(port_tree, ref_tree, rtol, atol):
    """Every leaf by path name; port tensors vs reference arrays."""
    ref_flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    port_flat = {"/".join(p): leaf for p, leaf in T.leaves_with_path(port_tree)}
    assert list(port_flat) == list(ref_flat)
    for name, t in port_flat.items():
        np.testing.assert_allclose(
            t.detach().float().cpu().numpy(),
            np.asarray(ref_flat[name], np.float32), rtol=rtol, atol=atol,
            err_msg=name)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value of x (8-bit mantissa)."""
    ax = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7).astype(np.float32)


def assert_within_bf16_ulp(got, want, n=1):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    bad = err > n * bf16_ulp(want)
    assert not bad.any(), (f"{bad.sum()} elements beyond {n} bf16 ulp; "
                           f"max err {err.max()}")


def bf16_normal(shape, seed):
    """Standard normal f32 values rounded to bf16 (exact in both packages'
    bf16): the frontend stub's frames and patches."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def as_jax(batch):
    """numpy batch -> jax arrays; frontend embeddings as bf16."""
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                           else None) for k, v in batch.items()}


def as_torch(batch):
    """numpy batch -> CPU tensors; frontend embeddings as bf16."""
    return {k: torch.from_numpy(v).to(torch.bfloat16 if v.dtype == np.float32
                                      else None) for k, v in batch.items()}
