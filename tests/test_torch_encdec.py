"""The port's encoder-decoder family (whisper-small's smoke config) against
the JAX package: the GELU MLP, declarations, ``encode``, forward logits,
loss and gradients, prefill (logits and every cache leaf, the cross keys
and values included), three teacher-forced decode steps, and one
federated round against the reference's no-mesh anchor.

Each model case runs on two paths: at the smoke threshold of 64 (every
attention quadratic: 8 frames, 12 tokens) and with the threshold lowered
to 6, so that the encoder, the decoder's self-attention and the
cross-attention all take the flash path (the kernel's plain version
forward, the chunked plain backward).  There the port's backward chunk is
5, so its last chunk is ragged (8 = 5 + 3 keys, 12 = 5 + 5 + 2).  The
reference keeps its chunk of 32 (one unpadded chunk): with a ragged chunk
its flash path attends the zero padding when unmasked, ROADMAP R5, pinned
in ``test_r5_reference_flash_attends_padded_keys``.

Tolerances: f32 in both packages, sums in other orders: logits, caches
and the memory rtol 1e-4, atol 1e-5, as tests/test_torch_serve.py;
gradients rtol 1e-4, atol 1e-5 as tests/test_torch_families.py; the
round's parameters rtol 1e-4, atol 1e-4 (Adam moves a weight by O(lr)
where its gradient is at rounding level, as tests/test_torch_fl_step.py).
"""
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
from repro.models import encdec as ref_encdec
from repro.models import kvcache as ref_kvc
from repro.models import layers as ref_layers
from repro.models import model_api as ref_model_api
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import build_fl_round_step
from repro_torch.core.topology import AggSchedule
from repro_torch.models import encdec, layers, model_api
from repro_torch.models import kvcache as kvc
from repro_torch.optim.api import make_optimizer
from test_torch_common import (as_jax, as_torch, assert_trees_close,
                               bf16_normal, np_f32, port_params, ref_params,
                               tokens)
from test_torch_serve import _port_cache

ARCH = "whisper-small"
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
B, S = 2, 12
# path -> (reference overrides, port overrides)
PATHS = {"quadratic": ({}, {}),
         "flash": ({"attn_chunk_threshold": 6},
                   {"attn_chunk_threshold": 6, "attn_chunk": 5})}


@pytest.fixture(scope="module", params=list(PATHS))
def m(request):
    ref_kw, kw = PATHS[request.param]
    ref_cfg = ref_smoke_config(ref_get_arch(ARCH)).replace(**ref_kw)
    cfg = smoke_config(get_arch(ARCH)).replace(**kw)
    rp = ref_params(ref_cfg, seed=0)
    fe = cfg.frontend
    batch = tokens(B, S, cfg.vocab, seed=1)
    batch["frames"] = bf16_normal((B, fe.n_tokens, fe.feat_dim), seed=2)
    return SimpleNamespace(ref_cfg=ref_cfg, cfg=cfg, rp=rp,
                           params=port_params(rp, cfg), batch=batch)


def test_gelu_mlp_is_the_tanh_form_of_the_reference():
    """f32 against ``repro.models.layers.gelu_mlp`` with nonzero biases;
    an erf GELU (PyTorch's default) misses the tolerance on the same
    inputs; bf16 activations keep their dtype with f32 biases."""
    rng = np.random.default_rng(0)
    d, f = 16, 32
    p = {"w_in": rng.standard_normal((d, f)) * 0.5,
         "b_in": rng.standard_normal(f), "w_out": rng.standard_normal((f, d)),
         "b_out": rng.standard_normal(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.standard_normal((2, 5, d)) * 2).astype(np.float32)
    want = np.asarray(ref_layers.gelu_mlp(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = layers.gelu_mlp(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    h = torch.from_numpy(x) @ tp["w_in"] + tp["b_in"]
    erf = torch.nn.functional.gelu(h) @ tp["w_out"] + tp["b_out"]
    assert not np.allclose(erf.numpy(), want, rtol=RTOL, atol=ATOL)
    bf = {k: v.to(torch.bfloat16) if k.startswith("w") else v
          for k, v in tp.items()}
    assert layers.gelu_mlp(bf, torch.from_numpy(x).to(torch.bfloat16)) \
        .dtype == torch.bfloat16


def _decls(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): d
            for path, d in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=ref_shd.is_decl)[0]}


def test_param_and_cache_decls_match_reference():
    ref_cfg = ref_smoke_config(ref_get_arch(ARCH))
    cfg = smoke_config(get_arch(ARCH))
    for want, got in (
            (ref_model_api.param_decls(ref_cfg), model_api.param_decls(cfg)),
            (ref_encdec.cache_decl(ref_cfg, 3, 17),
             encdec.cache_decl(cfg, 3, 17))):
        ref = _decls(want)
        port = {"/".join(p): d for p, d in T.leaves_with_path(got)}
        assert list(port) == list(ref)
        for name, d in port.items():
            r = ref[name]
            assert (d.shape, d.axes, d.init, d.scale) == \
                (r.shape, r.axes, r.init, r.scale), name
            assert str(d.dtype).split(".")[-1] == jnp.dtype(r.dtype).name
    assert "cross_kv_pos" not in encdec.cache_decl(cfg, 3, 17)
    assert model_api.get_model(cfg) is encdec


def test_encode_matches_reference(m):
    want = jax.jit(lambda p, f: ref_encdec.encode(m.ref_cfg, p, f))(
        m.rp, jnp.asarray(m.batch["frames"], jnp.bfloat16))
    # f32 frames off the bf16 grid by under half an ulp: encode rounds
    # them to bf16 first, as the reference does
    frames = torch.from_numpy(m.batch["frames"] * np.float32(1 + 2 ** -10))
    got = encdec.encode(m.cfg, m.params, frames)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_logits_loss_and_grads_match_reference(m):
    jb = as_jax(m.batch)

    def fn(p):
        logits = ref_encdec.forward(m.ref_cfg, p, jb)[0]
        return ref_model_api.cross_entropy(logits, jb["labels"]), logits
    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(fn, has_aux=True))(m.rp)

    params = T.tree_map(lambda t: t.clone().requires_grad_(True), m.params)
    tb = as_torch(m.batch)
    loss, parts = model_api.loss_fn(m.cfg, params, tb)
    logits = encdec.forward(m.cfg, params, tb)[0]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert float(parts["aux"]) == 0.0
    assert_trees_close(T.tree_map(lambda t: t.grad, params), want_grads,
                       rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_remat_gives_the_same_gradients(m):
    out = []
    for remat in (False, True):
        cfg = m.cfg.replace(remat=remat)
        params = T.tree_map(lambda t: t.clone().requires_grad_(True),
                            m.params)
        model_api.loss_fn(cfg, params, as_torch(m.batch))[0].backward()
        out.append([t.grad for t in T.leaves(params)])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loss_matches_reference_bf16(m):
    rp = ref_params(m.ref_cfg, seed=1, f32=False)
    want = ref_model_api.loss_fn(m.ref_cfg, rp, as_jax(m.batch))[0]
    params = port_params(rp, m.cfg, dtype=None)      # the decls' own dtypes
    got = model_api.loss_fn(m.cfg, params, as_torch(m.batch))[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


def _prefill_batch(m):
    return {"tokens": m.batch["tokens"], "frames": m.batch["frames"]}


def test_prefill_logits_and_cache_match_reference(m):
    want_logits, want_cache = jax.jit(
        lambda p, b: ref_encdec.prefill(m.ref_cfg, p, b))(
            m.rp, as_jax(_prefill_batch(m)))
    with torch.inference_mode():
        logits, cache = encdec.prefill(m.cfg, m.params,
                                       as_torch(_prefill_batch(m)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert sorted(cache) == ["cross_k", "cross_v", "k", "kv_pos", "v"]
    assert cache["cross_k"].shape == (m.cfg.n_layers, B,
                                      m.cfg.frontend.n_tokens,
                                      m.cfg.n_kv_heads, m.cfg.head_dim)
    assert_trees_close(cache, np_f32(want_cache), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(want_cache["kv_pos"]))


def test_three_decode_steps_match_reference(m):
    """Teacher-forced, as tests/test_torch_serve.py: each step feeds the
    reference's cache (grown as the engine grows it) to the port's
    ``decode_step``; the self-attention cache is written in place, the
    cross cache is left as it was; the port's own chain ends where the
    reference's does."""
    feed = tokens(B, 3, m.cfg.vocab, seed=3)["tokens"]
    _, rc = jax.jit(lambda p, b: ref_encdec.prefill(m.ref_cfg, p, b))(
        m.rp, as_jax(_prefill_batch(m)))
    rc = ref_kvc.pad_cache(rc, S + 8)
    assert rc["cross_k"].shape[2] == m.cfg.frontend.n_tokens   # not padded
    rdec = jax.jit(lambda p, c, b: ref_encdec.decode_step(m.ref_cfg, p, c, b))
    with torch.inference_mode():
        _, own = encdec.prefill(m.cfg, m.params, as_torch(_prefill_batch(m)),
                                layout=kvc.CacheLayout("whole", S + 8))
        assert own["cross_k"].shape[2] == m.cfg.frontend.n_tokens
        cross = own["cross_k"].clone()
        for step in range(3):
            db = {"token": feed[:, step:step + 1],
                  "pos": np.full((B,), S + step, np.int32)}
            want_logits, rc_next = rdec(
                m.rp, rc, {k: jnp.asarray(v) for k, v in db.items()})
            tb = {k: torch.from_numpy(v) for k, v in db.items()}
            fed = _port_cache(rc, m.cfg, B, rc["k"].shape[2])
            logits, out = encdec.decode_step(m.cfg, m.params, fed, tb)
            assert all(out[k] is fed[k] for k in fed)
            np.testing.assert_allclose(logits.numpy(),
                                       np.asarray(want_logits), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {step}")
            assert_trees_close(out, np_f32(rc_next), rtol=RTOL, atol=ATOL)
            own_logits, own = encdec.decode_step(m.cfg, m.params, own, tb)
            rc = rc_next
        assert torch.equal(own["cross_k"], cross)
    np.testing.assert_allclose(own_logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert_trees_close(own, np_f32(rc), rtol=RTOL, atol=ATOL)


K, TOTAL = 4, 4
WEIGHTS = np.array([3.0, 1.0, 2.0, 4.0], np.float32)
TREE = AggSchedule("tree", K, (((0, 1), (2, 3)), ((0, 1, 2, 3),)),
                   ((1, 0, 1, 0),))


def test_round_matches_reference_composition(m):
    """One tree round through ``build_fl_round_step`` (each client's local
    step on its slot, frames carried through the client loop, then fedavg
    per leaf) against the reference's cohort local step +
    ``fedavg_pytree(force="ref")``."""
    rp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *(
        ref_params(m.ref_cfg, seed=s) for s in range(3, 3 + K)))
    batch = tokens(1, S, m.cfg.vocab, seed=11, lead=(K,))
    fe = m.cfg.frontend
    batch["frames"] = bf16_normal((K, 1, fe.n_tokens, fe.feat_dim), seed=12)

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


def test_r5_reference_flash_attends_padded_keys():
    """R5 (reference fault, ``repro/models/attention.py`` ``_chunk_inputs``):
    the flash path pads k/v to a whole number of chunks and marks the
    padding with position 2**30, which only a causal mask removes.
    Unmasked attention (the encoder, the cross-attention) then gives each
    padded key a score of 0 and a share of the softmax.  With 8 frames and
    a chunk of 5 the reference's ``encode`` moves away from its own result
    at a chunk of 32 (no padding); the port's, at the same chunk of 5,
    equals that result."""
    base = ref_smoke_config(ref_get_arch(ARCH)).replace(
        attn_chunk_threshold=6)
    cfg = smoke_config(get_arch(ARCH)).replace(attn_chunk_threshold=6,
                                               attn_chunk=5)
    rp = ref_params(base, seed=0)
    frames = bf16_normal((B, 8, 64), seed=2)
    enc = {c: np.asarray(ref_encdec.encode(
        base.replace(attn_chunk=c), rp, jnp.asarray(frames, jnp.bfloat16)))
        for c in (32, 5)}
    got = encdec.encode(cfg, port_params(rp, cfg),
                        torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, enc[32], rtol=RTOL, atol=ATOL)
    assert float(np.abs(enc[5] - enc[32]).max()) > 1e-2
