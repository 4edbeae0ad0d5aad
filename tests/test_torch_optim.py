"""The port's optimizers (AdamW, SGD + momentum, Adafactor) and the
warmup+cosine schedule against the JAX package, over two updates from fixed
gradients (lr(0) = 0, so one update would prove nothing about the step),
and the client-stacked optimizer state against the reference's vmapped
``opt.init``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_shd
from repro.models import model_api as ref_model_api
from repro.optim import api as ref_optim
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import init_opt_state
from repro_torch.dist import sharding as shd
from repro_torch.models import model_api
from repro_torch.optim import api as optim
from test_torch_common import assert_trees_close, smoke_cfgs

# 1-D (a norm), 2-D, 3-D and 4-D leaves: Adafactor factors the >= 2-D ones
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)},
          "e": (2, 3, 4, 6)}


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 100, 10000),
                                               (1e-2, 1, 10), (5e-3, 3, 7)])
def test_warmup_cosine_matches_reference(peak, warmup, total):
    got = optim.warmup_cosine(peak, warmup, total)
    want = ref_optim.warmup_cosine(peak, warmup, total)
    for step in range(0, total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(0) == 0.0


def test_adamw_two_updates_match_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}
    p0 = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    g = [jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(2)]
    sched = dict(peak_lr=1e-2, warmup=1, total=10)

    ref = ref_optim.adamw(ref_optim.warmup_cosine(**sched))
    rp = jax.tree_util.tree_map(jnp.asarray, p0)
    rs = ref.init(rp)
    port = optim.adamw(optim.warmup_cosine(**sched))
    pp = T.tree_map(lambda x: torch.from_numpy(x.copy()), p0)
    ps = port.init(pp)
    for step in range(2):
        upd, rs = ref.update(jax.tree_util.tree_map(jnp.asarray, g[step]),
                             rs, rp, step)
        rp = ref_optim.apply_updates(rp, upd)
        pupd, ps = port.update(T.tree_map(torch.from_numpy, g[step]), ps, pp,
                               step)
        pp = optim.apply_updates(pp, pupd)
    # rtol 1e-6; atol of one f32 ulp at unit scale for entries near zero
    for got, want in ((pp, rp), (ps["m"], rs["m"]), (ps["v"], rs["v"])):
        assert_trees_close(got, want, rtol=1e-6, atol=1.2e-7)
    moved = T.leaves(pp)[0].numpy() - p0["a"]
    assert np.abs(moved).max() > 1e-3          # the second update did move


def test_make_optimizer_warmup_rule_and_unported_optimizers():
    """Every optimizer name dispatches as the reference's does (adafactor,
    else sgdm, else adamw), and none raises any more."""
    ref_cfg, cfg = smoke_cfgs()
    opt = optim.make_optimizer(cfg, total_steps=50)
    assert opt.name == "adamw"
    for name in ("adafactor", "sgdm", "adamw", "lion"):
        got = optim.make_optimizer(cfg.replace(optimizer=name))
        want = ref_optim.make_optimizer(ref_cfg.replace(optimizer=name))
        assert got.name == want.name
    assert optim.make_optimizer(
        cfg.replace(optimizer="adafactor")).name == "adafactor"


def _two_updates(ref, port, dtype=np.float32, seed=1):
    """Two updates from the same seeded parameters and gradients in both
    packages -> (port params, port state, reference params, state)."""
    rng = np.random.default_rng(seed)
    draw = lambda: jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))
    p0, g = draw(), [draw(), draw()]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    rp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), p0)
    rs = ref.init(rp)
    pp = T.tree_map(lambda x: torch.from_numpy(x.copy()).to(tdt), p0)
    ps = port.init(pp)
    for step in range(2):
        upd, rs = ref.update(jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jdt), g[step]), rs, rp, step)
        rp = ref_optim.apply_updates(rp, upd)
        pupd, ps = port.update(T.tree_map(
            lambda x: torch.from_numpy(x).to(tdt), g[step]), ps, pp, step)
        pp = optim.apply_updates(pp, pupd)
    moved = T.leaves(pp)[0].float().numpy() - p0["a"]
    assert np.abs(moved).max() > 1e-3          # the second update did move
    return pp, ps, rp, rs


def test_sgdm_two_updates_match_reference():
    sched = dict(peak_lr=1e-2, warmup=1, total=10)
    pp, ps, rp, rs = _two_updates(
        ref_optim.sgdm(ref_optim.warmup_cosine(**sched)),
        optim.sgdm(optim.warmup_cosine(**sched)))
    # f32: each op rounds once, as the reference's (rtol 1e-6, one f32 ulp
    # at unit scale near zero)
    for got, want in ((pp, rp), (ps["mu"], rs["mu"])):
        assert_trees_close(got, want, rtol=1e-6, atol=1.2e-7)


def test_sgdm_momentum_stays_in_the_parameter_dtype():
    """bf16 parameters keep a bf16 ``mu`` (reference optim/api.py:52-57),
    scaled by the momentum rounded to bf16 as JAX rounds the Python
    scalar.  XLA may keep ``0.9 * mu + g`` in f32 before its one rounding
    where the port rounds twice, so bf16 values agree to a bf16 ulp."""
    sched = dict(peak_lr=1e-2, warmup=1, total=10)
    pp, ps, rp, rs = _two_updates(
        ref_optim.sgdm(ref_optim.warmup_cosine(**sched)),
        optim.sgdm(optim.warmup_cosine(**sched)), dtype="bf16")
    assert all(t.dtype == torch.bfloat16 for t in T.leaves(ps["mu"]))
    assert all(t.dtype == jnp.bfloat16
               for t in jax.tree_util.tree_leaves(rs["mu"]))
    for got, want in ((pp, rp), (ps["mu"], rs["mu"])):
        assert_trees_close(got, want, rtol=2 ** -7, atol=2 ** -14)


def test_adafactor_two_updates_match_reference():
    """Factors and parameters after two updates, 1-D to 4-D leaves.  The
    arithmetic keeps the reference's order; ``t ** -0.8``, ``rsqrt`` and
    the row/column means may differ by f32 ulps, hence rtol 1e-5."""
    sched = dict(peak_lr=1e-2, warmup=1, total=10)
    pp, ps, rp, rs = _two_updates(
        ref_optim.adafactor(ref_optim.warmup_cosine(**sched)),
        optim.adafactor(optim.warmup_cosine(**sched)))
    assert set(ps) == {"f"}
    assert set(ps["f"]["b"]["c"]) == {"v"}
    assert set(ps["f"]["e"]) == {"vr", "vc"}
    assert tuple(ps["f"]["e"]["vr"].shape) == (2, 3, 4)
    assert tuple(ps["f"]["e"]["vc"].shape) == (2, 3, 6)
    assert_trees_close(pp, rp, rtol=1e-5, atol=1e-6)
    assert_trees_close(ps["f"], rs["f"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch,name", [("mixtral-8x22b", "adafactor"),
                                       ("internlm2-20b", "adafactor"),
                                       ("qwen2-7b", "sgdm"),
                                       ("qwen2-7b", "adamw")])
def test_client_stacked_state_has_the_reference_structure(arch, name):
    """``init_opt_state`` on the (K, ...) bank equals the reference's
    ``jax.vmap(opt.init)``: every leaf name, shape and dtype, so a client's
    (D,) ``final_norm`` keeps a full ``v`` under Adafactor."""
    K = 3
    ref_cfg = ref_smoke_config(ref_get_arch(arch)).replace(optimizer=name)
    cfg = smoke_config(get_arch(arch)).replace(optimizer=name)
    decls = ref_shd.prepend_axis(ref_model_api.param_decls(ref_cfg), K,
                                 "clients")
    want = jax.eval_shape(jax.vmap(ref_optim.make_optimizer(ref_cfg).init),
                          ref_shd.abstract(decls))
    params = shd.materialize(shd.prepend_axis(model_api.param_decls(cfg), K,
                                              "clients"), 0, "cpu")
    got = init_opt_state(optim.make_optimizer(cfg), params, K)
    want_flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                 for path, leaf in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    got_flat = {"/".join(p): t for p, t in T.leaves_with_path(got)}
    assert list(got_flat) == list(want_flat)
    for key, t in got_flat.items():
        w = want_flat[key]
        assert tuple(t.shape) == w.shape, key
        assert str(t.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, key
        assert not t.any(), key
    if name == "adafactor":
        assert tuple(got["f"]["final_norm"]["scale"]["v"].shape) == \
            (K, cfg.d_model)
