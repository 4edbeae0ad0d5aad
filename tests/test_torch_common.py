"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made from a numpy seed and handed to both packages; trees cross
between JAX and PyTorch as numpy, with bf16 leaves passed as exact f32."""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec

from repro.configs import base as ref_base
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core import fl_step as ref_fl_step
from repro.dist import sharding as ref_shd
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import fl_step
from repro_torch.core.topology import AggSchedule
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
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


# ---------------------------------------------------------------------------
# the model axis: each leaf's dim on ``model`` against the reference
# ---------------------------------------------------------------------------

def _as_spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_spec_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, PartitionSpec), tree
    return tuple(tree)


def block_of_leaf(path, axes):
    """The ``tensor_parallel.split_blocks`` key that decides leaf ``path``
    (its logical ``axes``) and the logical axis it puts on ``model``
    (None for the MoE layer, whose form names it); (None, None) for a leaf
    with no dim that a model axis could take."""
    if "experts" in axes:
        return "moe", None
    for ax in ("vocab", "kv_heads", "heads"):
        if ax in axes:
            return ax, ax
    if "mlp" not in axes:
        return None, None
    if "shared" in path:
        return "shared", "mlp"
    if tuple(path[-2:]) == ("cm", "wr"):
        return "mlp_r", "mlp"
    if path[0] == "vis_proj":
        return "vis", "mlp"
    return "mlp", "mlp"


def ref_twin(cfg):
    """The reference's ``ArchConfig`` with every field of the port's
    ``cfg`` (its MoE, frontend and FL configs as the reference's
    classes)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(ref_base, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return ref_base.ArchConfig(**kw)


def assert_model_axis_resolves(cfg, sizes):
    """``cfg`` on a mesh of ``sizes`` (data and model, or pod, data and
    model): ``param_specs`` and ``serve_specs`` equal the reference's (of
    ``ref_twin(cfg)``), and each leaf puts on ``model`` the dim that
    ``split_blocks`` decides for its block (the reference's resolver, dim
    by dim)."""
    ref_cfg = ref_twin(cfg)
    mesh = types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
    want = _as_spec_tuples(ref_shd.specs_for(
        ref_model_api.param_decls(ref_cfg),
        ref_shd.rules_for(ref_cfg.fl.mode), mesh))
    assert model_api.serve_specs(cfg, sizes) == want
    assert fl_step.param_specs(cfg, sizes) == _as_spec_tuples(
        ref_fl_step.param_specs(ref_cfg, mesh))
    blocks = tpar.split_blocks(cfg, sizes["model"])
    for (path, d), spec in zip(
            T.leaves_with_path(model_api.param_decls(cfg)), T.leaves(want)):
        on_model = [i for i, a in enumerate(spec) if a == "model"]
        block, ax = block_of_leaf(path, d.axes)
        if block is None:
            assert on_model == [], path
        elif block == "moe":
            form = blocks["moe"]
            assert on_model == ([d.axes.index(form)] if form in d.axes
                                else []), (path, form)
        else:
            assert on_model == ([d.axes.index(ax)] if blocks[block]
                                else []), (path, block, blocks[block])


def fake_mesh(sizes, rank=0):
    """A mesh object as far as building a step or an engine reads one: no
    process group (every group is the default one)."""
    coords = shd.mesh_coords(sizes, rank)
    return types.SimpleNamespace(
        shape=sizes, rank=rank, world=int(np.prod(list(sizes.values()))),
        device=torch.device("cpu"), group=lambda ax: None,
        coord=lambda ax: coords[ax], axis_names=tuple(sizes))


def assert_model_axis_runs(cfg, sizes):
    """``assert_model_axis_resolves``, and on a fake mesh of ``sizes`` (no
    spawn) the rank's model axis carries those decisions, a rank's state
    is its block of every leaf, and the round step builds."""
    assert_model_axis_resolves(cfg, sizes)
    mesh = fake_mesh(sizes)
    M = sizes["model"]
    tp = tpar.axis_for(cfg, mesh)
    assert tp.size == M and tp.blocks == tpar.split_blocks(cfg, M)
    state = fl_step.abstract_state(cfg, mesh)["params"]
    whole = fl_step.abstract_state(cfg, fl_step.n_clients_for(cfg, sizes))
    for t, w, s in zip(T.leaves(state), T.leaves(whole["params"]),
                       T.leaves(fl_step.param_specs(cfg, sizes))):
        assert t.shape == shd.local_block(w, s, mesh).shape
    K = fl_step.n_clients_for(cfg, sizes)
    assert callable(fl_step.build_fl_round_step(cfg, mesh,
                                                AggSchedule("flat", K)))
