"""The port's VLM family (internvl2-2b's smoke config) against the JAX
package: the declarations (``vis_proj``), the patch injection
(``decoder._embed_inputs``) with the sequence longer and shorter than the
patches, forward logits, loss and gradients, prefill (logits and cache),
three teacher-forced decode steps, and one federated round against the
reference's no-mesh anchor.

Each model case runs at the smoke threshold of 64 (quadratic attention at
12 tokens) and with the threshold lowered to 6 and the chunk to 5 in both
packages (flash: the kernel's plain version forward, the chunked plain
backward with a ragged last chunk; the attention is causal, so the
reference masks its padding and R5 does not arise).

Tolerances as tests/test_torch_encdec.py: logits and caches rtol 1e-4,
atol 1e-5; gradients rtol 1e-4, atol 1e-5; the round's parameters rtol
1e-4, atol 1e-4."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core.fl_step import build_cohort_local_step as ref_cohort_step
from repro.dist import sharding as ref_shd
from repro.kernels.fedavg.ops import fedavg_pytree as ref_fedavg_pytree
from repro.models import decoder as ref_decoder
from repro.models import kvcache as ref_kvc
from repro.models import model_api as ref_model_api
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import build_fl_round_step
from repro_torch.core.topology import AggSchedule
from repro_torch.models import decoder, model_api
from repro_torch.models import kvcache as kvc
from repro_torch.optim.api import make_optimizer
from test_torch_common import (as_jax, as_torch, assert_trees_close,
                               bf16_normal, np_f32, port_params, ref_params,
                               tokens)
from test_torch_serve import _port_cache

ARCH = "internvl2-2b"
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
B, S = 2, 12
PATHS = {"quadratic": {}, "flash": {"attn_chunk_threshold": 6,
                                    "attn_chunk": 5}}


def _cfgs(**kw):
    return (ref_smoke_config(ref_get_arch(ARCH)).replace(**kw),
            smoke_config(get_arch(ARCH)).replace(**kw))


def _patches(cfg, lead, n, seed):
    return bf16_normal(lead + (n, cfg.frontend.feat_dim), seed)


@pytest.fixture(scope="module", params=list(PATHS))
def m(request):
    ref_cfg, cfg = _cfgs(**PATHS[request.param])
    rp = ref_params(ref_cfg, seed=0)
    batch = tokens(B, S, cfg.vocab, seed=1)
    batch["patches"] = _patches(cfg, (B,), cfg.frontend.n_tokens, seed=2)
    return SimpleNamespace(ref_cfg=ref_cfg, cfg=cfg, rp=rp,
                           params=port_params(rp, cfg), batch=batch)


def test_param_decls_match_reference():
    ref_cfg, cfg = _cfgs()
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): d
           for path, d in jax.tree_util.tree_flatten_with_path(
               ref_model_api.param_decls(ref_cfg),
               is_leaf=ref_shd.is_decl)[0]}
    port = {"/".join(p): d
            for p, d in T.leaves_with_path(model_api.param_decls(cfg))}
    assert list(port) == list(ref)
    assert {"vis_proj/norm/scale", "vis_proj/w"} <= set(port)
    for name, d in port.items():
        r = ref[name]
        assert (d.shape, d.axes, d.init, d.scale) == \
            (r.shape, r.axes, r.init, r.scale), name
        assert str(d.dtype).split(".")[-1] == jnp.dtype(r.dtype).name, name
    assert model_api.get_model(cfg) is decoder


# (tokens, patches): the sequence longer than the patches, as long, and
# shorter (the reference then returns the patches' length)
@pytest.mark.parametrize("seq,n", [(12, 8), (8, 8), (5, 8), (5, 5)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_inputs_match_reference(seq, n, dtype):
    ref_cfg, cfg = _cfgs()
    rp = ref_params(ref_cfg, seed=4, f32=dtype == "f32")
    params = port_params(rp, cfg, dtype=torch.float32 if dtype == "f32"
                         else None)
    batch = {"tokens": tokens(B, seq, cfg.vocab, seed=seq)["tokens"],
             "patches": _patches(cfg, (B,), n, seed=n)}
    want = np.asarray(ref_decoder._embed_inputs(ref_cfg, rp, as_jax(batch)),
                      np.float32)
    got = decoder._embed_inputs(cfg, params, as_torch(batch))
    assert got.shape == (B, max(seq, n), cfg.d_model)
    assert got.dtype == params["embed"]["in_table"].dtype
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:       # one bf16 rounding of an f32-accumulated product
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                                   atol=1e-2)
    # tokens past the patches are the plain embeddings
    np.testing.assert_array_equal(
        got[:, n:].float().numpy(),
        params["embed"]["in_table"][torch.from_numpy(
            batch["tokens"][:, n:]).long()].float().numpy())


def test_logits_loss_and_grads_match_reference(m):
    jb = as_jax(m.batch)

    def fn(p):
        logits = ref_decoder.forward(m.ref_cfg, p, jb)[0]
        return ref_model_api.cross_entropy(logits, jb["labels"]), logits
    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(fn, has_aux=True))(m.rp)

    params = T.tree_map(lambda t: t.clone().requires_grad_(True), m.params)
    tb = as_torch(m.batch)
    logits = decoder.forward(m.cfg, params, tb)[0]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    loss, _ = model_api.loss_fn(m.cfg, params, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = T.tree_map(lambda t: t.grad, params)
    assert float(grads["vis_proj"]["w"].abs().max()) > 0
    assert_trees_close(grads, want_grads, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_loss_matches_reference_bf16(m):
    rp = ref_params(m.ref_cfg, seed=1, f32=False)
    want = ref_model_api.loss_fn(m.ref_cfg, rp, as_jax(m.batch))[0]
    params = port_params(rp, m.cfg, dtype=None)
    got = model_api.loss_fn(m.cfg, params, as_torch(m.batch))[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


def _prefill_batch(m):
    return {"tokens": m.batch["tokens"], "patches": m.batch["patches"]}


def test_prefill_logits_and_cache_match_reference(m):
    want_logits, want_cache = jax.jit(
        lambda p, b: ref_decoder.prefill(m.ref_cfg, p, b))(
            m.rp, as_jax(_prefill_batch(m)))
    with torch.inference_mode():
        logits, cache = decoder.prefill(m.cfg, m.params,
                                        as_torch(_prefill_batch(m)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert sorted(cache) == ["k", "kv_pos", "v"]
    assert_trees_close(cache, np_f32(want_cache), rtol=RTOL, atol=ATOL)


def test_three_decode_steps_match_reference(m):
    """Teacher-forced from the reference's prefill over patches and
    tokens (decode itself takes no patches), as tests/test_torch_serve.py;
    the port's own chain ends where the reference's does."""
    feed = tokens(B, 3, m.cfg.vocab, seed=3)["tokens"]
    _, rc = jax.jit(lambda p, b: ref_decoder.prefill(m.ref_cfg, p, b))(
        m.rp, as_jax(_prefill_batch(m)))
    rc = ref_kvc.pad_cache(rc, S + 8)
    rdec = jax.jit(lambda p, c, b: ref_decoder.decode_step(m.ref_cfg, p, c,
                                                           b))
    with torch.inference_mode():
        _, own = decoder.prefill(m.cfg, m.params, as_torch(_prefill_batch(m)),
                                 layout=kvc.CacheLayout("whole", S + 8))
        for step in range(3):
            db = {"token": feed[:, step:step + 1],
                  "pos": np.full((B,), S + step, np.int32)}
            want_logits, rc_next = rdec(
                m.rp, rc, {k: jnp.asarray(v) for k, v in db.items()})
            tb = {k: torch.from_numpy(v) for k, v in db.items()}
            fed = _port_cache(rc, m.cfg, B, rc["k"].shape[2])
            logits, out = decoder.decode_step(m.cfg, m.params, fed, tb)
            np.testing.assert_allclose(logits.numpy(),
                                       np.asarray(want_logits), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {step}")
            assert_trees_close(out, np_f32(rc_next), rtol=RTOL, atol=ATOL)
            own_logits, own = decoder.decode_step(m.cfg, m.params, own, tb)
            rc = rc_next
    np.testing.assert_allclose(own_logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert_trees_close(own, np_f32(rc), rtol=RTOL, atol=ATOL)


K, TOTAL = 4, 4
WEIGHTS = np.array([3.0, 1.0, 2.0, 4.0], np.float32)
TREE = AggSchedule("tree", K, (((0, 1), (2, 3)), ((0, 1, 2, 3),)),
                   ((1, 0, 1, 0),))


def test_round_matches_reference_composition(m):
    """One tree round through ``build_fl_round_step`` (patches carried
    through the client loop) against the reference's cohort local step +
    ``fedavg_pytree(force="ref")``."""
    rp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *(
        ref_params(m.ref_cfg, seed=s) for s in range(3, 3 + K)))
    batch = tokens(1, S, m.cfg.vocab, seed=11, lead=(K,))
    batch["patches"] = _patches(m.cfg, (K, 1), m.cfg.frontend.n_tokens, 12)

    local = ref_cohort_step(m.ref_cfg, K, total_steps=TOTAL, local_steps=1)
    opt = ref_make_optimizer(m.ref_cfg, total_steps=TOTAL)
    rstate = {"params": rp, "opt": jax.vmap(opt.init)(rp),
              "step": jnp.zeros((), jnp.int32)}
    rstate, rm = local(rstate, as_jax(batch))
    glob = ref_fedavg_pytree(rstate["params"], jnp.asarray(WEIGHTS),
                             force="ref")

    params = port_params(rp, m.cfg, n_clients=K)
    state = {"params": params,
             "opt": make_optimizer(m.cfg, total_steps=TOTAL).init(params),
             "step": 0}
    step = build_fl_round_step(m.cfg, K, TREE, device="cpu",
                               total_steps=TOTAL, local_steps=1)
    state, got = step(state, as_torch(batch), WEIGHTS)
    np.testing.assert_allclose(float(got["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    for leaf in T.leaves(state["params"]):
        assert all(torch.equal(leaf[k], leaf[0]) for k in range(1, K))
    assert_trees_close(T.tree_map(lambda t: t[0], state["params"]), glob,
                       rtol=1e-4, atol=1e-4)
