"""The slice as a whole: the port's FL round step against the reference's
no-mesh composition (cohort local step, then fedavg per leaf).  The
reference mesh round step is not the anchor because it raises under the
installed jax (ROADMAP fault R1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.strategies import get_strategy as ref_get_strategy
from repro.core.fl_step import build_cohort_local_step as ref_cohort_step
from repro.kernels.fedavg.ops import fedavg_pytree as ref_fedavg_pytree
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.core.fl_step import (ParamFilter, build_cohort_local_step,
                                      build_fl_round_step, init_cohort_state,
                                      init_state, leaf_path_names,
                                      pre_round_ref)
from repro_torch.core.topology import AggSchedule
from repro_torch.optim.api import make_optimizer
from test_torch_common import (assert_trees_close, port_params, ref_params,
                               smoke_cfgs, tokens)

K, E, TOTAL, ROUNDS = 4, 2, 8, 2
WEIGHTS = np.array([3.0, 1.0, 2.0, 4.0], np.float32)
TREE = AggSchedule("tree", K, (((0, 1), (2, 3)), ((0, 1, 2, 3),)),
                   ((1, 0, 1, 0),))


def _batches(cfg, seed=0):
    return [tokens(2, 32, cfg.vocab, seed=seed + r, lead=(K,))
            for r in range(ROUNDS)]


def _port_state(rp, cfg):
    params = port_params(rp, cfg, n_clients=K)
    opt = make_optimizer(cfg, total_steps=TOTAL)
    return {"params": params, "opt": opt.init(params), "step": 0}


def _run_port(state, cfg, batches, weights=WEIGHTS):
    step = build_fl_round_step(cfg, K, TREE, device="cpu", total_steps=TOTAL,
                               local_steps=E)
    losses = []
    for b in batches:
        state, m = step(state, b, weights)
        losses.append(float(m["loss"]))
    return state, losses


def test_round_and_cohort_steps_match_reference_composition():
    ref_cfg, cfg = smoke_cfgs()
    rp = ref_params(ref_cfg, seed=0, n_clients=K)
    batches = _batches(cfg)

    local = ref_cohort_step(ref_cfg, K, total_steps=TOTAL, local_steps=E)
    opt = ref_make_optimizer(ref_cfg, total_steps=TOTAL)
    rstate = {"params": rp, "opt": jax.vmap(opt.init)(rp),
              "step": jnp.zeros((), jnp.int32)}
    w = jnp.asarray(WEIGHTS)
    ref_losses, ref_local0 = [], None
    for b in batches:
        rstate, m = local(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref_local0 = ref_local0 or (rstate["params"], float(m["loss"]))
        glob = ref_fedavg_pytree(rstate["params"], w, force="ref")
        rstate["params"] = jax.tree_util.tree_map(
            lambda g: jnp.broadcast_to(g[None], (K,) + g.shape), glob)
        ref_losses.append(float(m["loss"]))

    state, losses = _run_port(_port_state(rp, cfg), cfg, batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert state["step"] == ROUNDS * E
    assert_trees_close(state["params"], rstate["params"], rtol=1e-4, atol=1e-5)
    assert_trees_close(state["opt"]["m"], rstate["opt"]["m"], rtol=1e-4,
                       atol=1e-5)

    # the cohort step alone: round 0's local training, no aggregation
    cohort = build_cohort_local_step(cfg, K, total_steps=TOTAL, local_steps=E)
    state, m = cohort(_port_state(rp, cfg), batches[0])
    np.testing.assert_allclose(float(m["loss"]), ref_local0[1], rtol=1e-5)
    # one client's slot, unaveraged: Adam moves a weight by O(lr) = 3e-4
    # even where its gradient is at rounding level, so atol is lr / 3
    assert_trees_close(state["params"], ref_local0[0], rtol=1e-4, atol=1e-4)
    fresh = init_cohort_state(cfg, K, seed=0, device="cpu")
    assert all(t.shape[0] == K for t in T.leaves(fresh["params"]))
    assert all(not t.any() for t in T.leaves(fresh["opt"]["m"]))


def test_all_slots_identical_and_dead_row_changes_nothing():
    ref_cfg, cfg = smoke_cfgs()
    rp = ref_params(ref_cfg, seed=1, n_clients=K)
    dead = WEIGHTS.copy()
    dead[3] = 0.0
    a, _ = _run_port(_port_state(rp, cfg), cfg, _batches(cfg)[:1], dead)
    for leaf in T.leaves(a["params"]):
        for k in range(1, K):
            assert torch.equal(leaf[k], leaf[0])
    # client 3: other data and other starting weights; weight 0 -> no effect
    other = _port_state(rp, cfg)
    for leaf in T.leaves(other["params"]):
        leaf[3].mul_(1.5)
    b = _batches(cfg)[0]
    b = {k: v.copy() for k, v in b.items()}
    b["tokens"][3] = (b["tokens"][3] + 7) % cfg.vocab
    c, _ = _run_port(other, cfg, [b], dead)
    for x, y in zip(T.leaves(a["params"]), T.leaves(c["params"])):
        assert torch.equal(x, y)


def test_update_filter_trains_and_aggregates_only_selected_leaves():
    _, cfg = smoke_cfgs()
    state = init_state(cfg, K, seed=0, device="cpu", total_steps=TOTAL,
                       update_filter="layers/mlp/*")
    names = leaf_path_names(state["params"])
    keep = ParamFilter.parse("layers/mlp/*").keep_list(state["params"])
    before = [t.clone() for t in T.leaves(state["params"])]
    for t, k in zip(before, keep):
        if not k:                       # frozen base agrees across clients
            assert all(torch.equal(t[j], t[0]) for j in range(K))
    step = build_fl_round_step(cfg, K, TREE, device="cpu", total_steps=TOTAL,
                               local_steps=E, update_filter="layers/mlp/*")
    state, _ = step(state, _batches(cfg)[0], WEIGHTS)
    for name, t0, t1, k in zip(names, before, T.leaves(state["params"]), keep):
        assert torch.equal(t0, t1) != k, name


def test_unported_strategy_and_missing_card_raise():
    _, cfg = smoke_cfgs()
    with pytest.raises(ValueError, match="no compiled"):
        build_fl_round_step(cfg, K, TREE, device="cpu", strategy="fedadam")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_fl_round_step(cfg, K, TREE)        # default device: cuda



def _ref_aggregate(strat, params, ref, w):
    """The reference's compiled aggregation composed without a mesh: each
    client's premap against its own pre-round row, then the weighted sum
    over k = 0..K-1 / sum(w), or ``combine_masked``; every slot gets the
    result."""
    K_ = len(w)
    row = lambda t, i: jax.tree_util.tree_map(lambda x: x[i:i + 1], t)
    rows = [row(params, i) for i in range(K_)]
    if strat.needs_ref:
        rows = [strat.premap(r, row(ref, i), jnp) for i, r in enumerate(rows)]
    wj = jnp.asarray(w)
    if strat.reduction == "stack":
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs),
                                         *rows)
        glob = strat.combine_masked(stacked, wj, jnp)
    else:
        def wsum(*xs):
            acc = xs[0][0].astype(jnp.float32) * wj[0]
            for k in range(1, K_):
                acc = acc + xs[k][0].astype(jnp.float32) * wj[k]
            return acc / wj.sum()
        glob = jax.tree_util.tree_map(wsum, *rows)
    return jax.tree_util.tree_map(
        lambda g, p: jnp.broadcast_to(g[None].astype(p.dtype), p.shape),
        glob, params)


STRATEGY_ROUNDS = [
    ("fedprox", WEIGHTS), ("norm_clip", WEIGHTS),
    ("trimmed_mean", np.array([3.0, 1.0, 0.0, 4.0], np.float32))]


def _ref_strategy_rounds(ref_cfg, rp, batches, strat, weights):
    """-> (per-round (pre-round, post-local) params, losses, final params)
    of the reference: cohort local step, then ``_ref_aggregate``."""
    local = ref_cohort_step(ref_cfg, K, total_steps=TOTAL, local_steps=E)
    opt = ref_make_optimizer(ref_cfg, total_steps=TOTAL)
    rstate = {"params": rp, "opt": jax.vmap(opt.init)(rp),
              "step": jnp.zeros((), jnp.int32)}
    trace, losses = [], []
    for b in batches:
        before = rstate["params"]
        rstate, m = local(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        trace.append((before, rstate["params"]))
        rstate["params"] = _ref_aggregate(strat, rstate["params"], before,
                                          weights)
        losses.append(float(m["loss"]))
    return trace, losses, rstate["params"]


@pytest.mark.parametrize("strategy,weights", STRATEGY_ROUNDS)
def test_strategy_rounds_match_reference_composition(strategy, weights):
    """Two rounds end to end: in round 0 the K slots differ (each client
    drawn on its own), so each client premaps against its own pre-round
    slot; in round 1 every slot holds the same global.  Unaveraged Adam
    moves a weight by O(lr) = 3e-4 even where its gradient is at rounding
    level, and a robust mean over 3 clients keeps a third of that: atol is
    lr / 3."""
    ref_cfg, cfg = smoke_cfgs()
    rp = ref_params(ref_cfg, seed=2, n_clients=K)
    batches = _batches(cfg, seed=3)
    _, ref_losses, ref_final = _ref_strategy_rounds(
        ref_cfg, rp, batches, ref_get_strategy(strategy), weights)
    state = _port_state(rp, cfg)
    step = build_fl_round_step(cfg, K, TREE, device="cpu", total_steps=TOTAL,
                               local_steps=E, strategy=strategy)
    losses = []
    for b in batches:
        state, m = step(state, b, weights)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert_trees_close(state["params"], ref_final, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strategy,weights", STRATEGY_ROUNDS)
def test_round_step_aggregates_against_the_pre_round_params(
        strategy, weights, monkeypatch):
    """The round step's aggregation alone, on the reference's own local
    results (the port's local round is replaced by a copy of them): bit
    for bit with the composition in both rounds; the norm clip's sum of
    squares runs in torch's order, within 4 f32 ulps of the leaf's
    largest magnitude."""
    from repro_torch.core import fl_step
    ref_cfg, cfg = smoke_cfgs()
    rp = ref_params(ref_cfg, seed=2, n_clients=K)
    batches = _batches(cfg, seed=3)
    strat = ref_get_strategy(strategy)
    trace, _, _ = _ref_strategy_rounds(ref_cfg, rp, batches, strat, weights)
    state = _port_state(rp, cfg)
    step = build_fl_round_step(cfg, K, TREE, device="cpu", total_steps=TOTAL,
                               local_steps=E, strategy=strategy)
    for before, after in trace:
        assert_trees_close(state["params"], before, rtol=0, atol=0)

        def local_round(client_fn, state, batch, n, after=after):
            for t, a in zip(T.leaves(state["params"]),
                            jax.tree_util.tree_leaves(after)):
                t.copy_(torch.from_numpy(np.array(a)))
            return torch.zeros(())
        monkeypatch.setattr(fl_step, "_local_round", local_round)
        state, _ = step(state, batches[0], weights)
        want = _ref_aggregate(strat, after, before, weights)
        atol = 0.0
        if strategy == "norm_clip":
            atol = 4 * 2.0 ** -23 * max(
                float(jnp.abs(x).max()) for x in jax.tree_util.tree_leaves(want))
        assert_trees_close(state["params"], want, rtol=0, atol=atol)
        # the next round starts where the port ended; carry the reference's
        # bits forward so each round checks the aggregation alone
        for t, w_ in zip(T.leaves(state["params"]),
                         jax.tree_util.tree_leaves(want)):
            t.copy_(torch.from_numpy(np.array(w_)))


def test_pre_round_ref_is_one_slot_once_the_slots_agree():
    _, cfg = smoke_cfgs()
    state = init_state(cfg, K, seed=0, device="cpu")
    first = pre_round_ref(state["params"])
    for a, b in zip(T.leaves(first), T.leaves(state["params"])):
        assert a.shape == b.shape and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()
    step = build_fl_round_step(cfg, K, TREE, device="cpu", total_steps=TOTAL,
                               local_steps=1, strategy="fedprox")
    state, _ = step(state, _batches(cfg)[0], WEIGHTS)
    later = pre_round_ref(state["params"])
    for a, b in zip(T.leaves(later), T.leaves(state["params"])):
        assert a.shape == (1,) + b.shape[1:] and torch.equal(a[0], b[0])
