"""The MoE family and Adafactor over the mesh's ``model`` axis (a client
split over M gloo ranks, spawned on the CPU) against the port on one
device, and the aggregation of MoE leaves against the JAX package.  Three
forms, each at f32 parameters from the reference's ``materialize``:

* ``ep``: mixtral-8x22b's smoke config, 4 experts split over the ranks
  (expert parallelism: the router's columns gathered, each rank's experts'
  rows of the dispatch buffer, their outputs gathered);
* ``tp3``: the same with 3 experts, which do not divide 2 or 4, so each
  expert's FFN width is split (intra-expert tensor parallelism);
* ``kimi``: kimi-k2's, whose dense first layer and shared expert are
  ``swiglu`` leaves on the ``mlp`` axis, beside 4 split experts.

* (a) the specs of the MoE leaves, their blocks and the Adafactor factors'
  blocks (pure logic), and which form each config takes;
* (b) a (1, 2) and a (1, 4) client (the latter with remat): the loss and
  every gradient block against the single device, and the routing
  statistics; one MoE layer alone: bit for bit in the expert-parallel
  form, its gradients and statistics in each;
* (c) Adafactor on blocks against the whole leaf, for each split pattern;
* (d) (2, 2) trainer rounds under Adafactor against the single-device
  K = 2 rounds; a (2, 2) trainer resumes bit for bit, and its checkpoint
  loads in the single-device trainer;
* (e) ``aggregate_params`` of expert, router and intra-expert leaves over
  (2, 2) ranks against the reference's on a (2, 2) host mesh with
  model-split specs, and against the single device per model block;
* (f) the CLI's ``--arch mixtral-8x22b --data-mesh 2 --model-mesh 2``.

The reference runs in one subprocess while the ranks run.  The
multi-process tests carry the ``slow`` marker."""
import dataclasses
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import test_torch_moe_tp_ranks as MR
import test_torch_tp_ranks as R
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro_torch import tree as T
from repro_torch.configs.base import get_arch
from repro_torch.core import fl_step
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch.train import SDFLMQTrainer
from test_torch_common import (assert_model_axis_runs, bf16_ulp, np_f32,
                               ref_params)
from test_torch_tp import ROOT, SPAWN_S, _env

# f32 client against the single device: the row-parallel sums add M
# partial products in another order than one GEMM (tests/test_torch_tp.py)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-6
# Adafactor's means over a split dim: M partial sums, then the division
ADAFACTOR_RTOL = 1e-6


def _grid(D, M, rank=0):
    return types.SimpleNamespace(shape={"data": D, "model": M}, rank=rank,
                                 world=D * M, device=torch.device("cpu"))


def _ref_cfg(name):
    arch = "kimi-k2-1t-a32b" if name == "kimi" else "mixtral-8x22b"
    cfg = ref_smoke_config(ref_get_arch(arch))
    if name == "tp3":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=3))
    return cfg


# ---------------------------------------------------------------------------
# (a) specs, blocks and forms, pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,M,form", [
    ("mixtral-8x22b", 2, "experts"), ("mixtral-8x22b", 4, "experts"),
    ("mixtral-8x22b", 16, "expert_mlp"), ("kimi-k2-1t-a32b", 4, "experts"),
    ("kimi-k2-1t-a32b", 16, "experts")])
def test_moe_form_follows_the_expert_specs(arch, M, form):
    """``moe_split`` names the dim ``_spec_for`` puts on ``model`` in the
    expert leaves: the experts where they divide M, else their width (the
    reference's mixtral on its 16-way axis)."""
    cfg = MR.replica(get_arch(arch))
    assert tpar.moe_split(cfg, M) == form
    specs = fl_step.param_specs(cfg, {"data": 1, "model": M})["layers"]
    want = {"experts": (None, "model", None, None),
            "expert_mlp": (None, None, None, "model")}[form]
    assert specs["moe"]["w_gate"] == want
    router = (None, None, "model" if form == "experts" else None)
    assert specs["moe"]["router"] == router
    assert tpar.split_blocks(cfg, M)["moe"] == form


def test_moe_config_whose_experts_stay_whole_raises():
    """Where neither the experts (3) nor their width (30) divide the model
    axis of 4 the whole MoE layer runs on every rank (``moe_split`` gives
    None), and where kimi's dense layer (66) does not, that MLP stays
    whole: the specs resolve as the reference's ``specs_for`` does and the
    round step builds (tests/test_torch_whole_tp.py runs such clients)."""
    cfg = MR.moe_smoke("tp3")
    cfg = cfg.replace(moe=cfg.moe.__class__(n_experts=3, top_k=2,
                                            d_ff_expert=30))
    assert tpar.moe_split(cfg, 4) is None
    assert_model_axis_runs(cfg, {"data": 1, "model": 4})
    kimi = MR.moe_smoke("kimi")
    kimi = kimi.replace(moe=kimi.moe.__class__(
        n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=1,
        first_k_dense=1, d_ff_dense=66))
    blocks = tpar.split_blocks(kimi, 4)
    assert not blocks["mlp"] and blocks["shared"] and blocks["moe"]
    assert_model_axis_runs(kimi, {"data": 1, "model": 4})


@pytest.mark.parametrize("name", MR.FORMS)
@pytest.mark.parametrize("D,M", [(1, 2), (1, 4), (2, 2)])
def test_moe_blocks_and_adafactor_factors_reassemble(name, D, M):
    """Every rank's block of each parameter and of each Adafactor factor
    (``state_specs``) has the shape of the rank's own state
    (``abstract_state`` on the mesh), and the blocks cover each leaf."""
    cfg = MR.moe_smoke(name)
    specs = T.leaves(fl_step.state_specs(cfg, {"data": D, "model": M},
                                         "adafactor"))
    whole = fl_step.abstract_state(cfg, D)
    leaves = T.leaves({"params": whole["params"], "opt": whole["opt"]})
    specs = specs[:len(leaves)]
    for r in range(D * M):
        mine = fl_step.abstract_state(cfg, _grid(D, M, r))
        got = T.leaves({"params": mine["params"], "opt": mine["opt"]})
        for t, w, s in zip(got, leaves, specs):
            assert t.shape == shd.local_block(w, s, _grid(D, M), r).shape, s
    bank = T.leaves(fl_step.init_state(cfg, D, 0, "cpu")["params"])
    pspecs = T.leaves(fl_step.param_specs(cfg, {"data": D, "model": M}))
    for leaf, spec in zip(bank, pspecs):
        got = torch.zeros_like(leaf, dtype=torch.float32)
        for r in range(D * M):
            shd.local_block(got, spec, _grid(D, M), r).copy_(
                shd.local_block(leaf, spec, _grid(D, M), r).float())
        assert torch.equal(got, leaf.float())


# ---------------------------------------------------------------------------
# the spawns and the reference, shared by the module
# ---------------------------------------------------------------------------

_REF_AGG = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.aggregation import aggregate_params
import test_torch_moe_tp_ranks as MR
import test_torch_tp_ranks as R

assert jax.device_count() == 4
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
bank, ref = MR.agg_case(2)
specs = {k: P(*MR.spec_of(k)) for k in bank}
jx = lambda t: {k: jnp.asarray(t[k]).astype(MR.SHAPES[k][1])
                for k in sorted(t)}
out = {}
for kind, strat in MR.agg_cases():
    sched = R.schedule(kind, 2)
    def run(t, w, r):
        return aggregate_params(t, w, mesh, "data", sched, specs,
                                strategy=strat, ref_params=r)
    fn = run if kind == "compressed" else jax.jit(run)
    with mesh:
        got = fn(jx(bank), jnp.asarray(MR.WEIGHTS[2][False]), jx(ref))
    for k in bank:
        out[f"{kind}|{strat}|{k}"] = np.asarray(got[k].astype(jnp.float32))[0]
np.savez(sys.argv[1], **out)
print("REFERENCE AGGREGATED", len(out))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module, while the reference's aggregation runs
    in its subprocess: a (1, 2) and a (1, 4) client of each form (the
    latter with remat), and the (2, 2) grid."""
    tmp = tmp_path_factory.mktemp("moe_tp")
    ref_path = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_AGG, str(ref_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    try:
        cases = []
        for name in MR.FORMS:
            cfg = MR.moe_smoke(name)
            cases.append((name, np_f32(ref_params(_ref_cfg(name), seed=0)),
                          R.grad_batch(cfg.vocab)))
        out = {"cases": cases}
        for M, remat in ((2, False), (4, True)):
            out[(1, M)] = mesh_spawn(MR.rank_one, 1, (cases, remat), M)
        out[(2, 2)] = mesh_spawn(MR.grid_rank, 2, (str(tmp / "ck"), 2), 2)
        stdout, stderr = proc.communicate(timeout=SPAWN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"{stdout[-2000:]}\n{stderr[-3000:]}"
    out["ref"] = dict(np.load(ref_path))
    out["ckpt"] = tmp / "ck"
    return out


def mesh_spawn(fn, D, args, M):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.spawn(fn, D, args, model=M, device="cpu",
                          timeout_s=SPAWN_S)


def _case(runs, name):
    return next(c for c in runs["cases"] if c[0] == name)


def _blocks(tree_np, specs, M, r):
    return R.blocks_of(MR.whole(tree_np), specs, _grid(1, M), r)


# ---------------------------------------------------------------------------
# (b) one client over its model ranks
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", MR.FORMS)
def test_moe_client_over_model_ranks_matches_single_device_f32(runs, name,
                                                               M):
    """The loss and every leaf's gradient (each rank's block of it: the
    experts', the router's columns, the shared expert's and the dense
    layer's mlp columns; the norms whole) against the single-device
    client at f32, within ``GRAD_RTOL``/``GRAD_ATOL``; the routing
    statistics: the same calls and dropped assignments, the auxiliary
    loss within ``LOSS_RTOL`` (the layers' inputs differ by the
    attention's row-parallel sums)."""
    _, params, batch = _case(runs, name)
    cfg = MR.moe_smoke(name, remat=M == 4)
    loss, grads, stats = MR.client_loss(cfg, MR.whole(params), batch)
    specs = fl_step.param_specs(cfg, {"data": 1, "model": M})
    for r, out in enumerate(runs[(1, M)]):
        got = out["clients"][name]
        assert got["form"] == tpar.moe_split(cfg, M)
        np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
        want = _blocks(grads, specs, M, r)
        for (path, g), w in zip(T.leaves_with_path(got["grads"]),
                                T.leaves(want)):
            assert g.shape == tuple(w.shape), path
            np.testing.assert_allclose(g, w.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg="/".join(path))
        assert got["stats"]["calls"] == stats["calls"]
        assert got["stats"]["dropped"] == stats["dropped"]
        np.testing.assert_allclose(got["stats"]["aux_mean"],
                                   stats["aux_mean"], rtol=LOSS_RTOL)


@pytest.mark.slow
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", MR.FORMS)
def test_moe_layer_over_model_ranks(runs, name, M):
    """One MoE layer on one input: under expert parallelism without a
    shared expert (``ep``) the output, the auxiliary loss, the input's
    gradient and every weight's gradient block equal the single device's
    bit for bit; the forms with a row-parallel sum (``tp3``'s experts,
    ``kimi``'s shared expert) within ``GRAD_RTOL``/``GRAD_ATOL``.  The
    routing statistics are the single device's in every form."""
    _, params, _ = _case(runs, name)
    cfg = MR.moe_smoke(name, remat=M == 4)
    lp = MR.layer_params(params)
    want = MR.moe_layer(cfg, MR.whole(lp), MR.layer_input(cfg))
    specs = MR.layer_specs(cfg, M)
    exact = name == "ep"
    for r, out in enumerate(runs[(1, M)]):
        got = out["clients"][name]["layer"]
        assert got["stats"] == want["stats"]
        assert got["aux"] == want["aux"]
        wg = T.leaves(_blocks(want["grads"], specs, M, r))
        pairs = [(got["y"], want["y"]), (got["dx"], want["dx"])] + [
            (a, b.numpy()) for a, b in zip(T.leaves(got["grads"]), wg)]
        for a, b in pairs:
            assert a.shape == b.shape
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# (c) Adafactor on blocks
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("leaf", list(MR.ADAFACTOR_LEAVES))
def test_adafactor_on_blocks_matches_whole_leaf(runs, leaf):
    """Two Adafactor updates of a leaf split over 2 ranks (its last dim,
    its second-to-last, a leading expert dim, a 1-D leaf, or whole) against
    the update of the whole leaf: each rank's updates and factors are the
    whole ones' blocks within ``ADAFACTOR_RTOL`` (a factor reduced over the
    split dim is whole on every rank)."""
    params, grads = MR.adafactor_case()
    ups, factors = MR.adafactor_run(params, grads)
    spec = MR.ADAFACTOR_LEAVES[leaf][1]
    parts = list(spec)          # the factors' specs (``opt_state_specs``)
    fac_spec = ({"vr": tuple(parts[:-1]), "vc": tuple(parts[:-2] + parts[-1:])}
                if len(spec) >= 2 else {"v": tuple(parts)})
    for r, out in enumerate(runs[(1, 2)]):
        got_ups, got_f = out["adafactor"]
        for step, (a, b) in enumerate(zip(got_ups, ups)):
            w = shd.local_block(torch.from_numpy(b[leaf]), spec,
                                _grid(1, 2), r).numpy()
            np.testing.assert_allclose(a[leaf], w, rtol=ADAFACTOR_RTOL,
                                       atol=0, err_msg=f"step {step}")
        for k, s in fac_spec.items():
            w = shd.local_block(torch.from_numpy(factors[leaf][k]), s,
                                _grid(1, 2), r).numpy()
            np.testing.assert_allclose(got_f[leaf][k], w,
                                       rtol=ADAFACTOR_RTOL, atol=0,
                                       err_msg=k)
        if "model" not in spec:        # whole on every rank: no reduction
            np.testing.assert_array_equal(got_ups[-1][leaf], ups[-1][leaf])


# ---------------------------------------------------------------------------
# (d) rounds, resume
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("i", range(len(MR.ROUND_CASES)),
                         ids=["-".join(map(str, c[:3]))
                              for c in MR.ROUND_CASES])
def test_moe_grid_round_matches_single_device(runs, i):
    """bf16 smoke rounds of the trainer under Adafactor, K = 2 clients each
    split over 2 ranks, against the single-device K = 2 rounds from the
    same bank and batches: each round's loss within 1e-5 relative, the
    same block on both ranks of a model column, and each client's MoE
    calls and dropped assignments (the same on its two ranks) summing to
    the single device's.  Round 0 runs at a learning rate of 0, so
    after one round the globals differ only by the aggregation: within one
    bf16 ulp.  ``compressed`` quantizes the model block's rows where the
    single device quantizes whole rows: each side is within half a step of
    each weighted contribution's row scale, so they differ by at most one
    bf16 ulp and the clients' largest row scale over 127 (the contributions
    are the initial slots, drawn apart, whose mean can be much smaller).
    After round 1's update (learning rate 3e-4, the warmup's peak),
    Adafactor's group sums and the bf16 activations' rounding move a few
    values: within one bf16 ulp and 2 x 3e-4, at most 1 % of them beyond
    one ulp."""
    name, kind, strat, rounds = MR.ROUND_CASES[i]
    cfg = MR.moe_smoke(name)
    want_ms, want, want_stats = MR.trainer_round(cfg, kind, strat,
                                                 rounds=rounds)
    specs = fl_step.param_specs(cfg, {"data": 1, "model": 2})
    whole = T.tree_map(torch.from_numpy, want)
    ranks = runs[(2, 2)]
    # the clients' largest |value| in each whole row of each leaf
    steps = [t.float().abs().amax(dim=(0, -1)).unsqueeze(-1).numpy() / 127
             for t in T.leaves(fl_step.init_state(cfg, 2, 0, "cpu")[
                 "params"])]
    beyond = total = 0
    for r, out in enumerate(ranks):
        ms, got, stats = out["rounds"][i]
        assert [m["level_groups"] for m in ms] == [
            m["level_groups"] for m in want_ms]
        for a, b in zip(ms, want_ms):
            assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        blocks = R.blocks_of(whole, specs, _grid(1, 2), r % 2)
        step_blocks = R.blocks_of(
            {j: torch.from_numpy(st) for j, st in enumerate(steps)},
            {j: s[:-1] + (None,) for j, s in enumerate(T.leaves(specs))},
            _grid(1, 2), r % 2)
        for a, b, z, q in zip(T.leaves(got), T.leaves(blocks),
                              T.leaves(ranks[r % 2]["rounds"][i][1]),
                              step_blocks.values()):
            np.testing.assert_array_equal(a, z)     # same on its column
            b = b.numpy()
            err, ulp = np.abs(a - b), bf16_ulp(b)
            if kind == "compressed":
                ulp = ulp + q.numpy()
            if rounds == 1:
                assert (err <= ulp).all()
                continue
            assert (err <= ulp + 2 * 3e-4).all()
            beyond += int((err > ulp).sum())
            total += err.size
    assert beyond <= 0.01 * max(total, 1), (beyond, total)
    # each client's MoE calls and drops, on one rank of its model group
    for key in ("calls", "dropped"):
        assert sum(ranks[r]["rounds"][i][2][key] for r in (0, 2)) == \
            want_stats[key]
        assert all(out["rounds"][i][2][key] == ranks[r - r % 2][
            "rounds"][i][2][key] for r, out in enumerate(ranks))


@pytest.mark.slow
def test_moe_grid_resume_under_adafactor_is_bit_for_bit(runs):
    """A (2, 2) mixtral smoke trainer under Adafactor interrupted after
    round 0 and resumed from its checkpoint against an uninterrupted run:
    the same losses, parameters, factors and step, bit for bit; and the
    single-device trainer restores the last checkpoint (the factors
    gathered in its format), its state's blocks the ranks'."""
    cfg = MR.moe_smoke("ep")
    one = SDFLMQTrainer(cfg, 2, 2, MR.BPC, MR.SEQ, seed=5, device="cpu",
                        ckpt_dir=str(runs["ckpt"]))
    assert one.start_round == 2
    state = {"params": one.state["params"], "opt": one.state["opt"]}
    specs = fl_step.state_specs(cfg, {"data": 2, "model": 2}, "adafactor")
    specs = {"params": specs["params"], "opt": specs["opt"]}
    for r, out in enumerate(runs[(2, 2)]):
        first, start, second, got, step = out["resumed"]
        ms, want, want_step = out["straight"]
        assert start == 1 and len(first) == 1 and len(second) == 1
        assert [m["loss"] for m in first + second] == [m["loss"] for m in ms]
        assert step == want_step
        for a, b in zip(T.leaves(got), T.leaves(want)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(T.leaves(got), T.leaves(
                R.blocks_of(state, specs, _grid(2, 2), r))):
            np.testing.assert_array_equal(a, b.float().numpy())


# ---------------------------------------------------------------------------
# (e) aggregate_params of MoE leaves over (data, model) ranks
# ---------------------------------------------------------------------------

def _whole(blocks_by_rank, M):
    out = {}
    for k, (shape, _, spec) in MR.SHAPES.items():
        leaf = torch.zeros(shape)
        for m in range(M):
            shd.local_block(leaf, spec, _grid(1, M), m).copy_(
                torch.from_numpy(blocks_by_rank[m][k]))
        out[k] = leaf.numpy()
    return out


@pytest.mark.slow
@pytest.mark.parametrize("strat", MR.STRATEGIES)
@pytest.mark.parametrize("kind", MR.KINDS)
def test_moe_aggregate_over_grid_matches_reference_mesh(runs, kind, strat):
    """The (2, 2) ranks' blocks put together against the reference's
    ``aggregate_params`` under ``shard_map`` with the model-split specs:
    ``compressed`` (the reference's eager form: int8 rows of the model
    block) and the stack strategies (trimmed_mean, multi_krum choosing in
    each model shard) bit for bit; the sums within rtol 2e-5, atol 1e-6,
    or one bf16 ulp for a bf16 leaf."""
    ranks = runs[(2, 2)]
    for chunk in R.CHUNKS:
        case = (chunk, kind, strat)
        for r, out in enumerate(ranks):       # the same on its column
            for k, v in out["agg"][case].items():
                np.testing.assert_array_equal(v,
                                              ranks[r % 2]["agg"][case][k])
        got = _whole([ranks[m]["agg"][case] for m in range(2)], 2)
        for k, v in got.items():
            want = runs["ref"][f"{kind}|{strat}|{k}"]
            if kind == "compressed" or strat != "fedavg":
                np.testing.assert_array_equal(v, want, err_msg=k)
                continue
            tol = 2e-5 * np.abs(want) + 1e-6
            if MR.SHAPES[k][1] == "bfloat16":
                tol = np.maximum(tol, bf16_ulp(want))
            assert (np.abs(v - want) <= tol).all(), k


@pytest.mark.slow
@pytest.mark.parametrize("strat", MR.STRATEGIES)
@pytest.mark.parametrize("kind", MR.KINDS)
def test_moe_aggregate_over_grid_matches_single_device_blocks(runs, kind,
                                                              strat):
    """Each rank's block against the single-device ``aggregate_params`` on
    that model block of the bank: ``compressed`` and the stack strategies
    bit for bit, the sums within one rounding of the f32 sum at the
    block's largest magnitude, or one bf16 ulp for a bf16 leaf."""
    bank, ref = MR.agg_case(2)
    for r, out in enumerate(runs[(2, 2)]):
        cut = lambda t: {k: shd.local_block(
            torch.from_numpy(v), (None,) + MR.SHAPES[k][2], _grid(2, 2),
            r).numpy() for k, v in t.items()}
        want = MR.aggregate(cut(bank), cut(ref), kind, strat)
        for chunk in R.CHUNKS:
            got = out["agg"][(chunk, kind, strat)]
            for k, w in want.items():
                if kind == "compressed" or strat != "fedavg":
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
                    continue
                tol = np.full(w.shape, 4 * 2.0 ** -23 * np.abs(w).max(),
                              np.float32)
                if MR.SHAPES[k][1] == "bfloat16":
                    tol = np.maximum(tol, bf16_ulp(w))
                assert (np.abs(got[k] - w) <= tol).all(), k


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_cli_moe_grid_under_adafactor_matches_single_device():
    """``--arch mixtral-8x22b --data-mesh 2 --model-mesh 2`` (4 gloo ranks
    started by the CLI, expert parallelism under Adafactor) prints the
    single-device trainer's K = 2 losses, within 2e-4 (one unit of the 4
    decimals printed and the bf16 rounds' drift)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--seq", "32", "--batch-per-client", "2", "--arch",
         "mixtral-8x22b", "--rounds", "2", "--data-mesh", "2",
         "--model-mesh", "2"], capture_output=True, text=True,
        timeout=SPAWN_S, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    got = [float(ln.split()[3]) for ln in out.stdout.splitlines()
           if ln.startswith("round")]
    from repro_torch.launch import train
    cfg = train._config(types.SimpleNamespace(
        arch="mixtral-8x22b", smoke=True, local_steps=1, schedule="tree"))
    want = [m["loss"] for m in SDFLMQTrainer(
        cfg, 2, 2, 2, 32, device="cpu").run()]
    assert len(got) == 2 and all(abs(a - b) <= 2e-4
                                 for a, b in zip(got, want)), (got, want)
