"""The port's AdamW and warmup+cosine schedule against the JAX package, over
two updates from fixed gradients (lr(0) = 0, so one update would prove
nothing about the step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import api as ref_optim
from repro_torch import tree as T
from repro_torch.optim import api as optim
from test_torch_common import assert_trees_close, smoke_cfgs


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
    _, cfg = smoke_cfgs()
    opt = optim.make_optimizer(cfg, total_steps=50)
    assert opt.name == "adamw"
    with pytest.raises(NotImplementedError):
        optim.make_optimizer(cfg.replace(optimizer="adafactor"))
