"""The port's serving path against the JAX package on the smoke configs, in
f32 (reference parameters cast to f32 before both calls): the KV-cache
functions, decode attention, one recurrence step, each family's cache
declarations, prefill (logits and every cache leaf), three teacher-forced
decode steps with caches crossing both ways, the serve engine's tokens
and stats, the reference's prefill/decode consistency test run on the
port, the CLIs, and the two reference faults on this path (ROADMAP R3 and
R4), pinned as matched behaviour.  The encoder-decoder and VLM families'
prefill takes the frontend stub's inputs (random frames and patches,
rounded to bf16, from a seed); their decode steps take none.

Tolerances: both packages compute in f32 and sum in other orders (XLA's
CPU dot against PyTorch's), so logits and states agree to rtol 1e-4 and
an absolute 1e-5 (logits are O(0.1) at the smoke widths); positions are
exact."""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_shd
from repro.models import attention as ref_attn
from repro.models import kvcache as ref_kvc
from repro.models import linear_attn as ref_la
from repro.models import model_api as ref_model_api
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig, get_arch, list_archs, \
    smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import linear_attn as la
from repro_torch.models import inputs, model_api
from repro_torch.serve.engine import ServeEngine
from test_torch_common import as_jax, as_torch, assert_trees_close, \
    bf16_normal, np_f32, port_params, ref_params
from test_torch_train import _env

ARCHS = ["qwen2-7b", "mixtral-8x22b", "kimi-k2-1t-a32b", "rwkv6-7b",
         "hymba-1.5b", "whisper-small", "internvl2-2b"]
RTOL, ATOL = 1e-4, 1e-5
# prompt lengths a family: one at or under the smoke threshold of 64 (the
# quadratic path) and one over it (the flash path; for hymba, 72 also
# wraps its window of 32 at a length that is not a multiple of it)
SEQS = {"qwen2-7b": [24, 80], "mixtral-8x22b": [12, 72],
        "kimi-k2-1t-a32b": [20, 70], "rwkv6-7b": [30, 67],
        "hymba-1.5b": [40, 72], "whisper-small": [20, 70],
        "internvl2-2b": [24, 80]}


def _cfgs(arch, **kw):
    return (ref_smoke_config(ref_get_arch(arch)).replace(**kw),
            smoke_config(get_arch(arch)).replace(**kw))


def _models(arch, **kw):
    """(ref cfg, cfg, ref module, port module, ref f32 params, port f32
    params) for one smoke config."""
    ref_cfg, cfg = _cfgs(arch, **kw)
    rp = ref_params(ref_cfg, seed=0)
    return (ref_cfg, cfg, ref_model_api.get_model(ref_cfg),
            model_api.get_model(cfg), rp, port_params(rp, cfg))


def _prompt(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _prefill_batch(cfg, toks, seed):
    """numpy prefill batch: the tokens and the frontend stub's inputs, as
    the engine shapes them (frames of every frame; patches up to S)."""
    batch = {"tokens": toks}
    fe = cfg.frontend
    if cfg.family == "encdec":
        batch["frames"] = bf16_normal((toks.shape[0], fe.n_tokens,
                                       fe.feat_dim), seed)
    elif cfg.family == "vlm":
        batch["patches"] = bf16_normal(
            (toks.shape[0], min(fe.n_tokens, toks.shape[1]), fe.feat_dim),
            seed)
    return batch


def _port_cache(np_cache, cfg, B, cache_len):
    """A reference cache (numpy) as the port's: float leaves in f32,
    kv_pos int32, checked against the port's ``cache_decl``."""
    decls = T.tree_map(
        lambda d: d if d.dtype == torch.int32
        else dataclasses.replace(d, dtype=torch.float32),
        model_api.get_model(cfg).cache_decl(cfg, B, cache_len))
    return shd.from_reference(np_f32(np_cache), decls, "cpu")


def _jax_cache(port_cache):
    return {k: jnp.asarray(v.numpy()) for k, v in port_cache.items()}


def _cache_len(cache):
    return cache["k"].shape[2] if "k" in cache else 0


# --------------------------------------------------------------------------
# kvcache, decode attention, the recurrence step
# --------------------------------------------------------------------------

def test_kvcache_functions_match_reference():
    rng = np.random.default_rng(0)
    L, B, S, K, hd = 2, 3, 8, 2, 4
    want = ref_kvc.kv_cache_decl(L, B, S, K, hd, prefix="x_")
    got = kvc.kv_cache_decl(L, B, S, K, hd, prefix="x_")
    assert list(got) == list(want)
    for name, d in got.items():
        r = want[name]
        assert (d.shape, d.axes, d.init) == (r.shape, r.axes, r.init), name
        assert str(d.dtype).split(".")[-1] == jnp.dtype(r.dtype).name, name

    pos = np.array([3, 9, 16], np.int32)
    np.testing.assert_array_equal(
        kvc.cache_slot(torch.from_numpy(pos), S).numpy(),
        np.asarray(ref_kvc.cache_slot(jnp.asarray(pos), S)))
    np.testing.assert_array_equal(
        kvc.prefilled_pos(B, S, "cpu").numpy(),
        np.asarray(ref_kvc.prefilled_pos(B, S)))

    k_l = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v_l = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    nk = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
    nv = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
    slot = pos % S
    wk, wv = ref_kvc.update_kv_layer(*(jnp.asarray(a) for a in
                                       (k_l, v_l, nk, nv, slot)))
    tk, tv = (torch.from_numpy(a.copy()) for a in (k_l, v_l))
    gk, gv = kvc.update_kv_layer(tk, tv, torch.from_numpy(nk),
                                 torch.from_numpy(nv), torch.from_numpy(slot))
    assert gk is tk and gv is tv                  # in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))

    kv_pos = np.asarray(ref_kvc.prefilled_pos(B, S))
    want_pos = ref_kvc.update_kv_pos(jnp.asarray(kv_pos), jnp.asarray(pos), S)
    tp = torch.from_numpy(kv_pos.copy())
    assert kvc.update_kv_pos(tp, torch.from_numpy(pos), S) is tp
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want_pos))

    cache = {"k": np.stack([k_l] * L), "v": np.stack([v_l] * L),
             "kv_pos": kv_pos}
    for max_len in (S + 5, S, S - 2):
        want_c = ref_kvc.pad_cache({k: jnp.asarray(v) for k, v in
                                    cache.items()}, max_len)
        got_c = kvc.pad_cache({k: torch.from_numpy(v.copy()) for k, v in
                               cache.items()}, max_len)
        for k in cache:
            np.testing.assert_array_equal(got_c[k].numpy(),
                                          np.asarray(want_c[k]))
    rec = {"S": torch.zeros(1)}
    assert kvc.pad_cache(rec, 99) == rec          # recurrent state: as is


@pytest.mark.parametrize("window,wrapped", [(None, False), (None, True),
                                            (5, False), (5, True)])
def test_decode_attention_matches_reference(window, wrapped):
    """GQA (4 q heads on 2 kv heads) over a 12-slot cache; ``wrapped``
    holds a ring after wrap-around (slots hold positions out of order) with
    empty slots (-1) and slots past the current position."""
    rng = np.random.default_rng(1)
    B, S, H, K, hd = 3, 12, 4, 2, 8
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    if wrapped:
        kv_pos = np.array([[12, 13, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
                           [-1] * 4 + list(range(8)),
                           [24, 25, 26, 15, 16, 17, 18, 19, 20, 21, 22, 23]],
                          np.int32)
        pos = np.array([13, 7, 26], np.int32)
    else:
        kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        pos = np.array([11, 6, 3], np.int32)
    want = ref_attn.decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, kv_pos, pos)), window=window)
    got = attn.decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, kv_pos, pos)),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("use_u,w_last", [(True, 8), (False, 1), (False, 8)])
def test_linear_attn_decode_step_matches_reference(use_u, w_last):
    rng = np.random.default_rng(2)
    B, H, dk, dv = 2, 3, 8, 6
    r, k = (rng.standard_normal((B, H, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, dv)).astype(np.float32)
    w = -np.exp(rng.standard_normal((B, H, w_last))).astype(np.float32)
    S = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    u = rng.standard_normal((H, dk)).astype(np.float32) if use_u else None
    wo, wS = ref_la.decode_step(*(jnp.asarray(a) for a in (r, k, v, w, S)),
                                u=None if u is None else jnp.asarray(u))
    go, gS = la.decode_step(*(torch.from_numpy(a) for a in (r, k, v, w, S)),
                            u=None if u is None else torch.from_numpy(u))
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gS.numpy(), np.asarray(wS), rtol=RTOL,
                               atol=ATOL)


def test_decode_step_state_equals_linear_attention_at_t1():
    """The T = 1, chunk 1 call the families make at decode (the WKV kernel
    on a card) equals one step of the recurrence."""
    g = torch.Generator().manual_seed(3)
    B, H, dk, dv = 2, 3, 8, 6
    r, k = torch.randn(B, 1, H, dk, generator=g), torch.randn(B, 1, H, dk,
                                                              generator=g)
    v = torch.randn(B, 1, H, dv, generator=g)
    w = -torch.rand(B, 1, H, dk, generator=g)
    s0 = torch.randn(B, H, dk, dv, generator=g)
    u = torch.randn(H, dk, generator=g)
    with torch.inference_mode():
        o, sf = la.linear_attention(r, k, v, w, u=u, s0=s0, chunk=1)
    o1, s1 = la.decode_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], s0, u=u)
    torch.testing.assert_close(o[:, 0], o1, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sf, s1, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# The families
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_decls_match_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    for cache_len in (0, 17) if arch == "rwkv6-7b" else (17,):
        want = ref_model_api.get_model(ref_cfg).cache_decl(ref_cfg, 3,
                                                           cache_len)
        got = model_api.get_model(cfg).cache_decl(cfg, 3, cache_len)
        ref = {"/".join(str(getattr(k, "key", k)) for k in path): d
               for path, d in jax.tree_util.tree_flatten_with_path(
                   want, is_leaf=ref_shd.is_decl)[0]}
        port = {"/".join(p): d for p, d in T.leaves_with_path(got)}
        assert list(port) == list(ref)
        for name, d in port.items():
            r = ref[name]
            assert (d.shape, d.axes, d.init) == (r.shape, r.axes, r.init)
            assert str(d.dtype).split(".")[-1] == jnp.dtype(r.dtype).name
    assert model_api.cache_len_for(cfg, 100) == \
        ref_model_api.cache_len_for(ref_cfg, 100)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", [0, 1])
def test_prefill_logits_and_cache_match_reference(arch, which):
    ref_cfg, cfg, rmod, pmod, rp, params = _models(arch)
    S = SEQS[arch][which]
    batch = _prefill_batch(cfg, _prompt(2, S, cfg.vocab, seed=S), seed=S)
    want_logits, want_cache = jax.jit(
        lambda p, b: rmod.prefill(ref_cfg, p, b))(rp, as_jax(batch))
    with torch.inference_mode():
        logits, cache = pmod.prefill(cfg, params, as_torch(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert_trees_close(cache, np_f32(want_cache), rtol=RTOL, atol=ATOL)
    if "kv_pos" in cache:
        assert cache["kv_pos"].dtype == torch.int32
        np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                      np.asarray(want_cache["kv_pos"]))
    want_keys = {"rwkv": ["S", "x_cm", "x_tm"],
                 "hybrid": ["conv", "k", "kv_pos", "ssm_S", "v"],
                 "encdec": ["cross_k", "cross_v", "k", "kv_pos", "v"]}.get(
        cfg.family, ["k", "kv_pos", "v"])
    assert sorted(cache) == want_keys


@pytest.mark.parametrize("arch", ARCHS)
def test_three_decode_steps_match_reference(arch):
    """Prefill with the reference, then three teacher-forced decode steps:
    at each step the port's ``decode_step`` is fed the reference's cache
    and the same token, and must give the reference's logits and updated
    cache.  The port's own chain (its prefill, three steps in place) ends
    where the reference's does, and the port's prefilled cache handed to
    the reference's ``decode_step`` gives the port's first step."""
    ref_cfg, cfg, rmod, pmod, rp, params = _models(arch)
    B, S = 2, SEQS[arch][1]
    batch = _prefill_batch(cfg, _prompt(B, S, cfg.vocab, seed=7), seed=9)
    feed = _prompt(B, 3, cfg.vocab, seed=8)
    pad = cfg.window is None and cfg.family != "rwkv"   # the engine's rule
    _, rc = jax.jit(lambda p, b: rmod.prefill(ref_cfg, p, b))(
        rp, as_jax(batch))
    if pad:
        rc = ref_kvc.pad_cache(rc, S + 8)
    rdec = jax.jit(lambda p, c, b: rmod.decode_step(ref_cfg, p, c, b))
    with torch.inference_mode():
        _, own = pmod.prefill(cfg, params, as_torch(batch))
        if pad:
            own = kvc.pad_cache(own, S + 8)
        # the port's prefilled cache through the reference's first step
        first = {"token": jnp.asarray(feed[:, :1]),
                 "pos": jnp.full((B,), S, jnp.int32)}
        cross_logits, _ = rdec(rp, _jax_cache(own), first)
        for step in range(3):
            db = {"token": feed[:, step:step + 1],
                  "pos": np.full((B,), S + step, np.int32)}
            want_logits, rc_next = rdec(
                rp, rc, {k: jnp.asarray(v) for k, v in db.items()})
            tb = {k: torch.from_numpy(v) for k, v in db.items()}
            fed = _port_cache(rc, cfg, B, _cache_len(rc))
            logits, out = pmod.decode_step(cfg, params, fed, tb)
            assert out is fed or all(out[k] is fed[k] for k in fed)
            np.testing.assert_allclose(logits.numpy(),
                                       np.asarray(want_logits), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {step}")
            assert_trees_close(out, np_f32(rc_next), rtol=RTOL, atol=ATOL)
            own_logits, own = pmod.decode_step(cfg, params, own, tb)
            if step == 0:
                np.testing.assert_allclose(own_logits.numpy(),
                                           np.asarray(cross_logits),
                                           rtol=RTOL, atol=ATOL)
            rc = rc_next
    np.testing.assert_allclose(own_logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert_trees_close(own, np_f32(rc), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", list_archs())
def test_arch_prefill_decode_consistency_on_the_port(arch):
    """The reference's ``test_arch_prefill_decode_consistency`` run on the
    port (tests/test_models.py): bf16 smoke parameters from the port's own
    seed, 4 prompts of 32 tokens from a numpy seed (and frames or patches
    from ``inputs.make_batch``); prefill's logits equal forward's last
    position and one decode step after prefill equals forward on S + 1
    tokens, at the reference test's rtol/atol of 5e-2."""
    cfg = smoke_config(get_arch(arch))
    params = model_api.init_params(cfg, 0, "cpu")
    mod = model_api.get_model(cfg)
    batch = inputs.make_batch(cfg, ShapeConfig("pre", 32, 4, "prefill"), 0,
                              device="cpu")
    toks = batch["tokens"] = torch.from_numpy(_prompt(4, 32, cfg.vocab, 0))
    S = toks.shape[1]
    with torch.inference_mode():
        plog, cache = mod.prefill(cfg, params, batch)
        flog, _ = mod.forward(cfg, params, batch)
        torch.testing.assert_close(plog.float(), flog[:, -1].float(),
                                   rtol=5e-2, atol=5e-2)
        if cfg.window is None and cfg.family != "rwkv":
            cache = kvc.pad_cache(cache, S + 8)
        tok = plog.argmax(-1).to(torch.int32)[:, None]
        dlog, _ = mod.decode_step(cfg, params, cache,
                                  {"token": tok,
                                   "pos": torch.full((4,), S,
                                                     dtype=torch.int32)})
        flog2, _ = mod.forward(cfg, params,
                               {**batch, "tokens": torch.cat([toks, tok], 1)})
    torch.testing.assert_close(dlog.float(), flog2[:, -1].float(), rtol=5e-2,
                               atol=5e-2)


# --------------------------------------------------------------------------
# The engine and the CLIs
# --------------------------------------------------------------------------

TIE = 1e-3      # a top-2 logit margin below this may flip across packages


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_tokens_and_stats_match_reference(arch):
    """Six requests (prompts 40-80 tokens, so the flash and the ring paths
    both run) at batch 4, through the reference's engine and the port's on
    the same f32 parameters.  The reference's logits are recorded; a
    request's tokens agree up to its first step whose reference top-2
    margin is under ``TIE`` (after a near-tie the two may pick different
    tokens and the continuations differ), and every stats count agrees."""
    ref_cfg, cfg, _, _, rp, params = _models(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(40, 81, 6)]
    max_new = [5, 3, 5, 4, 5, 2]
    ref = RefServeEngine(ref_cfg, rp, batch_size=4)
    margins = []

    def record(fn):
        def wrapped(*a):
            logits, cache = fn(*a)
            top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
            return logits, cache
        return wrapped
    ref._prefill, ref._decode = record(ref._prefill), record(ref._decode)
    port = ServeEngine(cfg, params, batch_size=4, device="cpu")
    for p, n in zip(prompts, max_new):
        ref.submit(p, n)
        port.submit(p, n)
    want, got = ref.run(), port.run()
    # margins per batch: prefill, then max_new decodes; token j of a
    # request comes from call j of its batch
    calls = [margins[:6], margins[6:]]
    for i, (w, g) in enumerate(zip(want, got)):
        assert (g.rid, g.done, len(g.out)) == (w.rid, True, len(w.out))
        for j, (a, b) in enumerate(zip(w.out, g.out)):
            if a != b:
                assert calls[i // 4][j][i % 4] < TIE, (i, j, w.out, g.out)
                break
    for key in ("prefill_tokens", "decode_steps", "requests"):
        assert port.stats[key] == ref.stats[key], key
    assert set(port.stats) == set(ref.stats)


def test_engine_rejects_unported_families_and_missing_card():
    """Every family of the reference is served (whisper-small and
    internvl2-2b among ``ARCHS``); a family no package has is rejected,
    and the default device raises without a card."""
    cfg = smoke_config(get_arch("qwen2-7b"))
    with pytest.raises(KeyError):
        ServeEngine(cfg.replace(family="no-such-family"), {}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(smoke_config(get_arch("qwen2-7b")), {})


@pytest.mark.parametrize("module,arch", [
    ("repro_torch.launch.serve", "qwen2-7b"),
    ("repro_torch.launch.serve", "rwkv6-7b"),
    ("repro_torch.examples.serve_lm", "hymba-1.5b"),
    ("repro_torch.examples.serve_lm", "mixtral-8x22b"),
    ("repro_torch.launch.serve", "whisper-small"),
    ("repro_torch.launch.serve", "internvl2-2b"),
    ("repro_torch.examples.serve_lm", "whisper-small"),
    ("repro_torch.examples.serve_lm", "internvl2-2b")])
def test_serve_clis_on_cpu(module, arch):
    out = subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu", "--arch", arch,
         "--requests", "5", "--max-new", "3"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    if module.endswith("serve"):
        assert out.stdout.startswith("5 requests, 15 tokens")
        assert "decode: 6 steps" in out.stdout
    else:
        reqs = [ln for ln in out.stdout.splitlines() if ln.startswith("req ")]
        assert len(reqs) == 5 and all(ln.count(",") == 2 for ln in reqs)


# --------------------------------------------------------------------------
# Reference faults on the serving path, pinned
# --------------------------------------------------------------------------

def _first_decode_vs_forward(arch, S, pad, **kw):
    """(port decode logits, reference decode logits, port forward logits
    at position S) for one decode step after prefill; ``pad`` grows the
    cache to S + 8 first."""
    ref_cfg, cfg, rmod, pmod, rp, params = _models(arch, **kw)
    B = 2
    toks = _prompt(B, S + 1, cfg.vocab, seed=S)
    jt = jnp.asarray(toks)
    _, rc = jax.jit(lambda p, b: rmod.prefill(ref_cfg, p, b))(
        rp, {"tokens": jt[:, :S]})
    db = {"token": toks[:, S:], "pos": np.full((B,), S, np.int32)}
    with torch.inference_mode():
        tt = torch.from_numpy(toks)
        _, cache = pmod.prefill(cfg, params, {"tokens": tt[:, :S]})
        if pad:
            rc, cache = ref_kvc.pad_cache(rc, S + 8), kvc.pad_cache(cache,
                                                                    S + 8)
        got, _ = pmod.decode_step(cfg, params, cache,
                                  {k: torch.from_numpy(v)
                                   for k, v in db.items()})
        fwd, _ = pmod.forward(cfg, params, {"tokens": tt})
    want, _ = jax.jit(lambda p, c, b: rmod.decode_step(ref_cfg, p, c, b))(
        rp, rc, {k: jnp.asarray(v) for k, v in db.items()})
    return got.numpy(), np.asarray(want), fwd[:, -1].numpy()


@pytest.mark.parametrize("S,holds", [(96, True), (72, False)])
def test_r3_hymba_window_ring_after_prefill(S, holds):
    """R3 (reference fault, ``repro/models/hybrid.py`` prefill/decode_step):
    prefill keeps the last W = min(window, S) keys at slots 0..W-1 while
    decode writes position S to slot S % W.  When W divides S that slot
    holds position S - W, the one leaving the window, and the step equals
    forward; otherwise it overwrites a key still inside the window.  The
    port matches the reference either way (smoke window 32, prompts over
    the flash threshold of 64)."""
    got, want, fwd = _first_decode_vs_forward("hymba-1.5b", S, pad=False)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    diff = float(np.abs(want - fwd).max())
    if holds:
        np.testing.assert_allclose(got, fwd, rtol=RTOL, atol=ATOL)
    else:
        assert diff > 1e-3, diff


@pytest.mark.parametrize("pad,holds", [(True, True), (False, False)])
def test_r4_windowed_decoder_cache_left_unpadded(pad, holds):
    """R4 (reference fault, ``repro/serve/engine.py`` ``_run_batch``): the
    engine pads the prefilled cache only when ``cfg.window is None``, so a
    windowed decoder's first decode step at S < window writes slot
    S % S = 0 and evicts position 0, still inside the window (mixtral's
    4096 at any prompt shorter than that).  qwen2-7b's smoke config with a
    window of 32 (a dense layer: the MoE layer's capacity differs between
    2 and 26 tokens, so forward is no yardstick there) at S = 12:
    unpadded, as the engine leaves it, the port equals the reference and
    both differ from forward; padded, both equal forward."""
    got, want, fwd = _first_decode_vs_forward("qwen2-7b", 12, pad=pad,
                                              window=32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if holds:
        np.testing.assert_allclose(got, fwd, rtol=RTOL, atol=ATOL)
    else:
        assert float(np.abs(want - fwd).max()) > 1e-3
