"""The port's dense decoder against the JAX package: layers, the loss and
its gradients (torch autograd vs jax.grad) on the qwen2-7b smoke config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.models import attention, layers, model_api
from test_torch_common import (assert_trees_close, port_params, ref_params,
                               smoke_cfgs, tokens)

TIGHT = dict(rtol=1e-6, atol=1e-6)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TIGHT))


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 64), _rand(rng, 64)
    _check(layers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-5),
           ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                              1e-5))


@pytest.mark.parametrize("hd", [16, 18])
def test_rope_matches_reference(hd):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 4, hd)
    pos = np.arange(8, dtype=np.int32) + 5
    _check(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           rtol=1e-5, atol=1e-6)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(2)
    p = {"w_gate": _rand(rng, 16, 32), "w_up": _rand(rng, 16, 32),
         "w_down": _rand(rng, 32, 16)}
    x = _rand(rng, 3, 16)
    _check(layers.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)),
           ref_layers.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x)), rtol=1e-5, atol=1e-5)


def test_project_qkv_with_bias_matches_reference():
    rng = np.random.default_rng(3)
    D, H, Kv, hd = 32, 4, 2, 8
    p = {"wq": _rand(rng, D, H, hd), "wk": _rand(rng, D, Kv, hd),
         "wv": _rand(rng, D, Kv, hd), "wo": _rand(rng, H, hd, D),
         "bq": _rand(rng, H, hd), "bk": _rand(rng, Kv, hd),
         "bv": _rand(rng, Kv, hd)}
    x = _rand(rng, 2, 6, D)
    pos = np.arange(6, dtype=np.int32)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    got = attention.project_qkv(pt, torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = ref_attn.project_qkv(pj, jnp.asarray(x), jnp.asarray(pos), 1e4)
    for g, w in zip(got, want):
        _check(g, w, rtol=1e-5, atol=1e-5)
    _check(attention.project_out(pt, got[0]), ref_attn.project_out(pj, want[0]),
           rtol=1e-5, atol=1e-4)


def _ref_loss_and_grads(ref_cfg, params, batch):
    fn = lambda p: ref_model_api.loss_fn(ref_cfg, p, batch)[0]
    return jax.jit(jax.value_and_grad(fn))(params)


@pytest.mark.parametrize("seq", [32, 128])   # 128 > threshold 64: flash path
def test_loss_and_grads_match_reference_f32(seq):
    ref_cfg, cfg = smoke_cfgs()
    rp = ref_params(ref_cfg, seed=0)
    batch = tokens(2, seq, cfg.vocab, seed=seq)
    want_loss, want_grads = _ref_loss_and_grads(
        ref_cfg, rp, {k: jnp.asarray(v) for k, v in batch.items()})

    params = port_params(rp, cfg)
    for t in T.leaves(params):
        t.requires_grad_(True)
    loss, parts = model_api.loss_fn(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert float(parts["aux"]) == 0.0
    grads = T.tree_map(lambda t: t.grad, params)
    assert_trees_close(grads, want_grads, rtol=1e-4, atol=1e-5)


def test_loss_matches_reference_bf16():
    ref_cfg, cfg = smoke_cfgs()
    rp = ref_params(ref_cfg, seed=1, f32=False)
    batch = tokens(2, 128, cfg.vocab, seed=5)
    want = ref_model_api.loss_fn(
        ref_cfg, rp, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    params = port_params(rp, cfg, dtype=None)       # the decls' own dtypes
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert params["layers"]["attn"]["bq"].dtype == torch.float32
    got = model_api.loss_fn(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


def test_remat_gives_the_same_gradients():
    ref_cfg, cfg = smoke_cfgs()
    rp = ref_params(ref_cfg, seed=2)
    batch = {k: torch.from_numpy(v) for k, v in tokens(1, 96, cfg.vocab).items()}
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        params = port_params(rp, c)
        leaves = [t.requires_grad_(True) for t in T.leaves(params)]
        model_api.loss_fn(c, params, batch)[0].backward()
        out.append([t.grad for t in leaves])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
