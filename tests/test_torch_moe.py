"""The port's MoE layer (``repro_torch/models/moe.py``, ``dist/moe_a2a.py``)
and the MoE decoder against the JAX package on the smoke configs of
mixtral-8x22b and kimi-k2 (a shared expert and one leading dense layer):
routing ids, the tokens dropped at capacity, the output, the auxiliary loss
and the gradients, for each ``impl``; then the decoder's declarations,
logits, loss and gradients.  Inputs are made from a numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_shd
from repro.models import model_api as ref_model_api
from repro.models import moe as ref_moe
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.models import model_api, moe
from test_torch_common import (assert_trees_close, np_f32, port_params,
                               ref_params, tokens)

ARCHS = ["mixtral-8x22b", "kimi-k2-1t-a32b"]


def _cfgs(arch, **moe_kw):
    ref_cfg = ref_smoke_config(ref_get_arch(arch))
    cfg = smoke_config(get_arch(arch))
    return (ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe, **moe_kw)),
            cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)))


def _layer_inputs(ref_cfg, cfg, seed, f32=True, S=48):
    rp = ref_shd.materialize(ref_moe.moe_decl(ref_cfg),
                             jax.random.PRNGKey(seed))
    if f32:
        rp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), rp)
    x = np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    dtype = torch.float32 if f32 else torch.bfloat16
    pp = shd.from_reference(np_f32(rp), moe.moe_decl(cfg), "cpu",
                            dtype=torch.float32 if f32 else None)
    xj = jnp.asarray(x, jnp.float32 if f32 else jnp.bfloat16)
    return rp, xj, pp, torch.from_numpy(x).to(dtype)


def _ref_dropped(ids: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The reference's dispatch (models/moe.py:87-91) on numpy: a mask over
    the (token, choice) assignments of those dropped at capacity."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sid = flat[order]
    rank = np.arange(flat.size) - np.searchsorted(sid, sid, side="left")
    dropped = np.zeros(flat.size, bool)
    dropped[order] = rank >= cap
    return dropped.reshape(ids.shape)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference_f32(arch, capacity_factor):
    """Output, auxiliary loss and gradients (parameters and input) in f32,
    with the ids and the dropped set equal.  At capacity factor 0.5 half
    the assignments of the 96 tokens cannot fit and are dropped."""
    ref_cfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    rp, xj, pp, xt = _layer_inputs(ref_cfg, cfg, seed=3)
    cot = np.random.default_rng(4).standard_normal(xt.shape).astype(
        np.float32)

    def fn(p, x):
        y, aux = ref_moe.moe_apply_dense(ref_cfg, p, x)
        return jnp.sum(y * cot) + aux, (y, aux)
    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True)(rp, xj)

    T_ = xt.shape[0] * xt.shape[1]
    _, ref_ids, _ = ref_moe.route(rp["router"], xj.reshape(T_, -1),
                                  ref_cfg.moe.top_k)
    _, ids, _ = moe.route(pp["router"], xt.reshape(T_, -1), cfg.moe.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    cap = moe.capacity(T_, cfg.moe)
    assert cap == ref_moe.capacity(T_, ref_cfg.moe)
    order, slot, valid = moe.dispatch(ids, cfg.moe.n_experts, cap)
    got_dropped = np.zeros(ids.numel(), bool)
    got_dropped[order.numpy()] = ~valid.numpy()
    want_dropped = _ref_dropped(np.asarray(ref_ids), cfg.moe.n_experts, cap)
    np.testing.assert_array_equal(got_dropped.reshape(ids.shape),
                                  want_dropped)
    assert want_dropped.any() == (capacity_factor < 1)

    for t in T.leaves(pp):
        t.requires_grad_(True)
    xt.requires_grad_(True)
    moe.reset_stats()
    y, aux = moe.moe_apply_dense(cfg, pp, xt)
    assert moe.read_stats() == {"calls": 1, "rows": cfg.moe.n_experts * cap,
                                "assignments": ids.numel(),
                                "dropped": int(want_dropped.sum()),
                                "aux_mean": aux.item()}
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    # f32: the expert products and sums in another order (~1e-6 of |y|)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    assert_trees_close(T.tree_map(lambda t: t.grad, pp), want_gp,
                       rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("top_k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_bf16_is_bit_exact_with_reference(arch, top_k):
    """In bf16 the return scatter-add sums each token's contributions in
    increasing expert id, one rounding per add, as the reference's
    scatter-add does on the CPU: at top-4 the order matters, and the
    output agrees bit for bit."""
    ref_cfg, cfg = _cfgs(arch, top_k=top_k)
    rp, xj, pp, xt = _layer_inputs(ref_cfg, cfg, seed=5, f32=False)
    want_y, want_aux = ref_moe.moe_apply_dense(ref_cfg, rp, xj)
    y, aux = moe.moe_apply_dense(cfg, pp, xt)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(want_y, np.float32))
    # the f32 router, gates and aux: ulps of the softmax's sums
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_impls_equal_auto_and_reference(arch):
    """``impl`` auto, ep_a2a and tp_local give one result (one device: no
    sharding constraint applies), equal to the reference's ``moe_apply``
    for the same impl."""
    outs = []
    for impl in ("auto", "ep_a2a", "tp_local"):
        ref_cfg, cfg = _cfgs(arch, impl=impl)
        rp, xj, pp, xt = _layer_inputs(ref_cfg, cfg, seed=7)
        want_y, want_aux = ref_moe.moe_apply(ref_cfg, rp, xj)
        y, aux = moe.moe_apply(cfg, pp, xt)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
        outs.append((y, aux))
    for y, aux in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(aux, outs[0][1])


# --------------------------------------------------------------------------
# The MoE decoder
# --------------------------------------------------------------------------

def _model_cfgs(arch):
    return ref_smoke_config(ref_get_arch(arch)), smoke_config(get_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_decls_match_reference(arch):
    ref_cfg, cfg = _model_cfgs(arch)
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): d
           for path, d in jax.tree_util.tree_flatten_with_path(
               ref_model_api.param_decls(ref_cfg),
               is_leaf=ref_shd.is_decl)[0]}
    port = {"/".join(p): d
            for p, d in T.leaves_with_path(model_api.param_decls(cfg))}
    assert list(port) == list(ref)
    for name, d in port.items():
        r = ref[name]
        assert (d.shape, d.axes, d.init, d.scale) == \
            (r.shape, r.axes, r.init, r.scale), name
        assert str(d.dtype).split(".")[-1] == jnp.dtype(r.dtype).name, name
    assert ("dense_layers/mlp/w_up" in port) == (arch.startswith("kimi"))
    assert "layers/moe/router" in port


# seq 40: the exact attention; seq 96: above the smoke threshold of 64, so
# the flash path (mixtral: window 32)
@pytest.mark.parametrize("seq", [40, 96])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decoder_matches_reference_f32(arch, seq):
    ref_cfg, cfg = _model_cfgs(arch)
    rp = ref_params(ref_cfg, seed=0)
    batch = tokens(2, seq, cfg.vocab, seed=seq)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fn(p):
        loss, parts = ref_model_api.loss_fn(ref_cfg, p, jb)
        logits = ref_model_api.get_model(ref_cfg).forward(ref_cfg, p, jb)[0]
        return loss, (logits, parts["aux"])
    (want_loss, (want_logits, want_aux)), want_grads = jax.jit(
        jax.value_and_grad(fn, has_aux=True))(rp)

    params = port_params(rp, cfg)
    for t in T.leaves(params):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model_api.get_model(cfg).forward(cfg, params, tb)[0]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-5)
    loss, parts = model_api.loss_fn(cfg, params, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(parts["aux"].item(), float(want_aux),
                               rtol=1e-5)
    assert parts["aux"].item() > 0
    grads = T.tree_map(lambda t: t.grad, params)
    assert_trees_close(grads, want_grads, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decoder_remat_gives_the_same_gradients(arch):
    ref_cfg, cfg = _model_cfgs(arch)
    rp = ref_params(ref_cfg, seed=2)
    batch = {k: torch.from_numpy(v)
             for k, v in tokens(1, 40, cfg.vocab).items()}
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        params = port_params(rp, c)
        leaves = [t.requires_grad_(True) for t in T.leaves(params)]
        model_api.loss_fn(c, params, batch)[0].backward()
        out.append([t.grad for t in leaves])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
