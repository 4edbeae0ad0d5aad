"""The ``shared`` mode on ranks (one FL client a pod, FSDP over its
``data`` ranks, tensor parallelism over ``model``; gloo ranks spawned on
the CPU) against the JAX package and against the port on one device, at
the smoke configs of qwen2-7b (dense) and mixtral-8x22b (MoE, its declared
mode):

* (a) ``param_specs``, ``opt_state_specs``, ``state_specs``,
  ``batch_specs`` (client axis ``pod``), ``client_axis_for`` and
  ``n_clients_for`` equal the reference's for every arch config on the
  pod meshes (2, 2, 1), (1, 2, 2), (2, 1, 2) and (2, 2, 2) (pure logic);
* (b) ``aggregate_params(..., axis="pod")`` over a (2, 2, 1) mesh equals
  the reference's on a host mesh of the same shape (in a subprocess) and
  the single-device port's on each data block, under ``tree``, ``flat``,
  ``rs_ag`` and ``compressed`` for fedavg, fedprox, trimmed_mean and
  multi_krum;
* (c) a (1, 2, 1) client at f32 with its batch of 2 split over the data
  ranks: the mean of the ranks' losses and their gradients, gathered,
  equal the reference's ``loss_fn`` under ``jax.grad`` on the whole batch,
  dense and MoE (at a capacity that drops assignments, so routing each
  rank's rows alone would fail it); with batch 1 (replicated over the
  ranks) an AdamW round equals the single-device K = 1 round bit for bit;
* Adafactor's updates and factors on leaves split over ``data`` (and
  ``model``) equal the whole leaf's blocks, on (1, 2, 1) and (1, 2, 2);
* (d) f32 rounds: (2, 2, 1), K = 2, batch 2, under AdamW and Adafactor and
  ``tree``, ``flat`` and ``compressed``, against the single-device K = 2
  rounds aggregated per data block; a (1, 2, 2) MoE round (experts on
  ``model``, ``embed`` on ``data``) against K = 1;
* (e) a (2, 2, 1) trainer under Adafactor resumes bit for bit, and its
  checkpoint loads in the single-device K = 2 trainer;
* (g) the CLI's ``--pod-mesh 2 --data-mesh 2``.

The reference's aggregation runs in one subprocess while the ranks run.
The multi-process tests carry the ``slow`` marker."""
import dataclasses
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import test_torch_moe_tp_ranks as MR
import test_torch_shared_ranks as S
import test_torch_tp_ranks as R
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core import fl_step as ref_fl_step
from repro.models import inputs as ref_inputs
from repro.models import model_api as ref_model_api
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.configs.base import SHAPES, get_arch, list_archs
from repro_torch.core import fl_step
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import inputs, moe
from test_torch_common import bf16_ulp, np_f32, ref_params
from test_torch_tp import ROOT, SPAWN_S, _env

POD_MESHES = [(2, 2, 1), (1, 2, 2), (2, 1, 2), (2, 2, 2)]
# (c) the f32 client against the reference's loss_fn on one device: the
# loss within 1e-5 relative; a gradient element within 1e-5 of the leaf's
# largest magnitude (the data ranks' f32 gradient sums and the mean of
# their losses add the terms in another order than one device's sums)
CLIENT_RTOL = 1e-5
# Adafactor's update and factors on (data, model) blocks against the whole
# leaf's: 1e-6 relative, no absolute floor (the groups' partial sums, then
# the division)
ADAFACTOR_RTOL = 1e-6
# (d) the f32 rounds against the single device: losses within 1e-5
# relative; parameters within 1e-5 relative or 2 x the learning rate (an
# AdamW step of an element whose gradient is near 0 can take the other
# sign); optimizer state within 1e-5 relative or 1e-5 of its leaf's
# largest magnitude (the moments and factors of gradients summed in
# another order; 9e-8 of it seen at the smoke configs); and in each of the
# two, at most 1 % of the elements beyond 1e-5 relative (0.2 % seen), so
# that an error common to a leaf's elements fails even where it is below
# the floor
ROUND_RTOL = 1e-5
STATE_FLOOR = 1e-5
MAX_SHARE_BEYOND = 0.01


def _grid(P, D, M, rank=0):
    return types.SimpleNamespace(
        shape={"pod": P, "data": D, "model": M}, rank=rank, world=P * D * M,
        device=torch.device("cpu"))


def _ref_mesh(P, D, M):
    """The reference's spec functions read only ``shape`` and
    ``axis_names`` of a mesh."""
    return types.SimpleNamespace(shape={"pod": P, "data": D, "model": M},
                                 axis_names=("pod", "data", "model"))


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, PartitionSpec), tree
    return tuple(tree)


def _shared(cfg):
    return cfg.replace(fl=cfg.fl.__class__(mode="shared"))


# ---------------------------------------------------------------------------
# (a) specs, pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", POD_MESHES,
                         ids=["x".join(map(str, s)) for s in POD_MESHES])
@pytest.mark.parametrize("arch", list_archs())
def test_shared_specs_match_reference(arch, shape):
    """``param_specs`` and ``opt_state_specs`` (through ``state_specs``,
    the config's optimizer), ``client_axis_for``, ``n_clients_for`` and
    ``batch_specs`` of every assigned input shape with the client axis
    ``pod`` equal the reference's, spec for spec."""
    ref_cfg, cfg = _shared(ref_get_arch(arch)), _shared(get_arch(arch))
    sizes = {"pod": shape[0], "data": shape[1], "model": shape[2]}
    mesh = _ref_mesh(*shape)
    opt = ref_make_optimizer(ref_cfg).name
    assert fl_step.state_specs(cfg, sizes, opt) == _as_tuples(
        ref_fl_step.state_specs(ref_cfg, mesh, opt))
    assert fl_step.param_specs(cfg, sizes) == _as_tuples(
        ref_fl_step.param_specs(ref_cfg, mesh))
    assert fl_step.client_axis_for(cfg, sizes) == \
        ref_fl_step.client_axis_for(ref_cfg, mesh) == "pod"
    assert fl_step.n_clients_for(cfg, sizes) == \
        ref_fl_step.n_clients_for(ref_cfg, mesh) == shape[0]
    for name, sc in SHAPES.items():
        for clients in ([0, shape[0]] if sc.kind == "train" else [0]):
            kw = dict(clients=clients, axis_sizes=sizes,
                      client_axis="pod" if clients else None)
            want = _as_tuples(ref_inputs.batch_specs(
                ref_cfg, REF_SHAPES[name], **kw))
            assert inputs.batch_specs(cfg, sc, **kw) == want, (name, clients)


@pytest.mark.parametrize("shape", POD_MESHES,
                         ids=["x".join(map(str, s)) for s in POD_MESHES])
def test_shared_blocks_reassemble_every_leaf(shape):
    """Every rank's block of each leaf of the K = P bank and of each
    Adafactor factor (mixtral's smoke config) has the shape of its own
    state (``abstract_state`` on the mesh), and the blocks cover the
    leaf, once a copy along each axis its spec does not name."""
    cfg = S.moe_smoke()
    P, D, M = shape
    sizes = {"pod": P, "data": D, "model": M}
    specs = T.leaves(fl_step.state_specs(cfg, sizes, "adafactor"))
    whole = fl_step.abstract_state(cfg, P)
    leaves = T.leaves({"params": whole["params"], "opt": whole["opt"]})
    for r in range(P * D * M):
        mine = fl_step.abstract_state(cfg, _grid(P, D, M, r))
        got = T.leaves({"params": mine["params"], "opt": mine["opt"]})
        for t, w, s in zip(got, leaves, specs):
            assert t.shape == shd.local_block(w, s, sizes, r).shape, s
    bank = T.leaves(fl_step.init_state(cfg, P, 0, "cpu")["params"])
    for leaf, spec in zip(bank, T.leaves(fl_step.param_specs(cfg, sizes))):
        got = torch.zeros_like(leaf, dtype=torch.float32)
        cover = torch.zeros_like(got)
        for r in range(P * D * M):
            shd.local_block(got, spec, _grid(P, D, M), r).copy_(
                shd.local_block(leaf, spec, _grid(P, D, M), r).float())
            shd.local_block(cover, spec, _grid(P, D, M), r).add_(1.0)
        copies = int(np.prod([n for ax, n in sizes.items()
                              if ax not in spec]))
        assert torch.equal(got, leaf.float())
        assert bool((cover == copies).all()), (spec, copies)


def test_rank_rows_follow_the_batch_spec_rule():
    """A batch that divides the data ranks splits by rows in rank order;
    one that does not stays whole on every rank."""
    b = {"tokens": torch.arange(12).reshape(4, 3)}
    rows = [inputs.rank_rows(b, 2, d) for d in range(2)]
    assert all(split for _, split in rows)
    assert torch.equal(torch.cat([r["tokens"] for r, _ in rows]),
                       b["tokens"])
    got, split = inputs.rank_rows(b, 3, 1)
    assert not split and got["tokens"] is b["tokens"]


# ---------------------------------------------------------------------------
# the spawns and the reference, shared by the module
# ---------------------------------------------------------------------------

_REF_AGG = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.aggregation import aggregate_params
import test_torch_shared_ranks as S
import test_torch_tp_ranks as R

assert jax.device_count() == 4
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
bank, ref = S.agg_case()
specs = {k: P(*S.spec_of(k)) for k in bank}
jx = lambda t: {k: jnp.asarray(t[k]).astype(S.SHAPES[k][1])
                for k in sorted(t)}
out = {}
for kind in S.KINDS:
    sched = R.schedule(kind, 2)
    sums = [s for s in S.STRATEGIES if s in ("fedavg", "fedprox")]
    stacks = [s for s in S.STRATEGIES if s not in sums]
    for strats in (sums, stacks):
        def run(t, w, r):      # the strategies under one schedule at once
            return [aggregate_params(t, w, mesh, "pod", sched, specs,
                                     strategy=strat, ref_params=r)
                    for strat in strats]
        # compressed sums op by op: jitted, XLA rewrites their arithmetic
        # (ROADMAP section 3); the stack strategies ignore the schedule
        eager = kind == "compressed" and strats is sums
        with mesh:
            got = (run if eager else jax.jit(run))(
                jx(bank), jnp.asarray(S.AGG_WEIGHTS), jx(ref))
        for strat, g in zip(strats, got):
            for k in bank:
                out[f"{kind}|{strat}|{k}"] = np.asarray(
                    g[k].astype(jnp.float32))[0]
np.savez(sys.argv[1], **out)
print("REFERENCE AGGREGATED", len(out))
'''


def _spawn(fn, P, D, M, args=()):
    return mesh_lib.spawn(fn, D, args, model=M, pods=P, device="cpu",
                          timeout_s=SPAWN_S)


def _ref_cfg(name):
    """The reference's config of an (c) client case."""
    if name == "dense":
        cfg = ref_smoke_config(ref_get_arch("qwen2-7b"))
    else:
        cfg = ref_smoke_config(ref_get_arch("mixtral-8x22b"))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=S.CAPACITY_FACTOR))
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module, while the reference's aggregation runs
    in its subprocess: the (1, 2, 1) client, the (2, 2, 1) grid and the
    (1, 2, 2) MoE client."""
    tmp = tmp_path_factory.mktemp("shared")
    ref_path = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_AGG, str(ref_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    try:
        cases = [(name, np_f32(ref_params(_ref_cfg(name), seed=0)),
                  R.grad_batch(S.client_cfg(name).vocab))
                 for name in ("dense", "moe")]
        out = {"cases": cases}
        out[(1, 2, 1)] = _spawn(S.client_rank, 1, 2, 1, (cases,))
        out[(2, 2, 1)] = _spawn(S.grid_rank, 2, 2, 1, (str(tmp / "ck"),))
        out[(1, 2, 2)] = _spawn(S.moe_rank, 1, 2, 2)
        stdout, stderr = proc.communicate(timeout=SPAWN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"{stdout[-2000:]}\n{stderr[-3000:]}"
    out["ref"] = dict(np.load(ref_path))
    out["ckpt"] = tmp / "ck"
    return out


def _gathered(blocks_by_rank, specs, mesh_shape, ranks):
    """The whole tree from ``ranks``' blocks (numpy) under ``specs``."""
    first = blocks_by_rank[ranks[0]]
    out = []
    for i, (path, spec) in enumerate(T.leaves_with_path(specs)):
        shape = tuple(n * mesh_shape.get(ax, 1) if ax else n for n, ax in
                      zip(T.leaves(first)[i].shape, spec))
        leaf = torch.zeros(shape)
        for r in ranks:
            shd.local_block(leaf, spec, mesh_shape, r).copy_(
                torch.from_numpy(T.leaves(blocks_by_rank[r])[i]))
        out.append(leaf.numpy())
    return T.unflatten_like(specs, out)


# ---------------------------------------------------------------------------
# (b) aggregation across the pods
# ---------------------------------------------------------------------------

def _agg_whole(ranks, case):
    """Slot 0's aggregate from pod 0's two data blocks."""
    sizes = {"pod": 2, "data": 2, "model": 1}
    out = {}
    for k, (shape, _, spec) in S.SHAPES.items():
        leaf = torch.zeros(shape)
        for d in range(2):
            shd.local_block(leaf, spec, sizes, d).copy_(
                torch.from_numpy(ranks[d]["agg"][case][k]))
        out[k] = leaf.numpy()
    return out


@pytest.mark.slow
@pytest.mark.parametrize("strat", S.STRATEGIES)
@pytest.mark.parametrize("kind", S.KINDS)
def test_aggregate_across_pods_matches_reference_mesh(runs, kind, strat):
    """The (2, 2, 1) ranks' data blocks put together against the
    reference's ``aggregate_params(..., axis="pod")`` on a (2, 2, 1) host
    mesh with the shared specs, with tests/test_torch_dist.py's
    tolerances: ``compressed`` (the block's int8 rows, the reference's
    per-shard quantization) bit for bit against the reference's eager
    form (its jitted form is held in tests/test_torch_dist.py); the stack
    strategies bit for bit; the other sums within rtol 2e-5, atol 1e-6, or
    one bf16 ulp for a bf16 leaf."""
    ranks = runs[(2, 2, 1)]
    for chunk in R.CHUNKS:
        case = (chunk, kind, strat)
        for r, out in enumerate(ranks):       # the same on both pods
            for k, v in out["agg"][case].items():
                np.testing.assert_array_equal(v,
                                              ranks[r % 2]["agg"][case][k])
        got = _agg_whole(ranks, case)
        for k, (shape, dt, spec) in S.SHAPES.items():
            g, want = got[k], runs["ref"][f"{kind}|{strat}|{k}"]
            if kind == "compressed" or strat in ("trimmed_mean",
                                                 "multi_krum"):
                np.testing.assert_array_equal(g, want, err_msg=k)
            else:
                tol = 2e-5 * np.abs(want) + 1e-6
                if dt == "bfloat16":
                    tol = np.maximum(tol, bf16_ulp(want))
                assert (np.abs(g - want) <= tol).all(), (
                    k, np.abs(g - want).max())


@pytest.mark.slow
@pytest.mark.parametrize("strat", S.STRATEGIES)
@pytest.mark.parametrize("kind", S.KINDS)
def test_aggregate_across_pods_matches_single_device_blocks(runs, kind,
                                                            strat):
    """Each rank's block against the single-device ``aggregate_params`` on
    that data block of the bank: ``compressed`` and the stack strategies
    bit for bit, the sums within one rounding of the f32 sum at the
    block's largest magnitude, or one bf16 ulp for a bf16 leaf."""
    bank, ref = S.agg_case()
    for r, out in enumerate(runs[(2, 2, 1)]):
        cut = lambda t: {k: shd.local_block(
            torch.from_numpy(v), (None,) + S.SHAPES[k][2], _grid(2, 2, 1),
            r).numpy() for k, v in t.items()}
        want = S.aggregate(cut(bank), cut(ref), kind, strat)
        for chunk in R.CHUNKS:
            got = out["agg"][(chunk, kind, strat)]
            for k, w in want.items():
                if kind == "compressed" or strat in ("trimmed_mean",
                                                     "multi_krum"):
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
                    continue
                tol = np.full(w.shape, 4 * 2.0 ** -23 * np.abs(w).max(),
                              np.float32)
                if S.SHAPES[k][1] == "bfloat16":
                    tol = np.maximum(tol, bf16_ulp(w))
                assert (np.abs(got[k] - w) <= tol).all(), k


# ---------------------------------------------------------------------------
# (c) one client over its data ranks
# ---------------------------------------------------------------------------

def _ref_loss_and_grads(name, params_np, batch_np):
    cfg = _ref_cfg(name)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    fn = lambda p: ref_model_api.loss_fn(cfg, p, batch)[0]
    loss, grads = jax.jit(jax.value_and_grad(fn))(params)
    return float(loss), np_f32(grads)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_client_over_data_ranks_matches_reference_loss_fn(runs, name):
    """A (1, 2, 1) client at f32, its batch of 2 split one row a data
    rank: the mean of the two ranks' losses, and every leaf's gradient
    (the ranks' blocks of it put together; the norms whole and equal on
    both), against the reference's ``loss_fn`` under ``jax.grad`` on the
    whole batch, within ``CLIENT_RTOL``.  The MoE client routes the whole
    batch at a capacity that drops assignments: both ranks report the
    single device's calls, drops and auxiliary loss."""
    _, params, batch = next(c for c in runs["cases"] if c[0] == name)
    want_loss, want = _ref_loss_and_grads(name, params, batch)
    ranks = runs[(1, 2, 1)]
    outs = [r[name] for r in ranks]
    assert all(o["split"] for o in outs)
    loss = (outs[0]["loss"] + outs[1]["loss"]) / 2
    np.testing.assert_allclose(loss, want_loss, rtol=CLIENT_RTOL)
    cfg = S.client_cfg(name)
    sizes = {"pod": 1, "data": 2, "model": 1}
    specs = fl_step.param_specs(cfg, sizes)
    got = _gathered([o["grads"] for o in outs], specs, sizes, [0, 1])
    wl = dict(T.leaves_with_path(want))
    for path, g in T.leaves_with_path(got):
        w = wl[path]
        tol = CLIENT_RTOL * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, ("/".join(path),
                                            np.abs(g - w).max(), tol)
    for path, spec in T.leaves_with_path(specs):       # whole: equal
        if "data" not in spec:
            a, b = (dict(T.leaves_with_path(o["grads"]))[path] for o in outs)
            np.testing.assert_array_equal(a, b)
    if name == "moe":
        single = S.client_loss_single(cfg, params, batch)
        assert single["stats"]["dropped"] > 0
        for o in outs:
            assert o["stats"]["calls"] == single["stats"]["calls"]
            assert o["stats"]["dropped"] == single["stats"]["dropped"]
            assert o["aux"] == outs[0]["aux"]
            np.testing.assert_allclose(o["aux"], single["aux"],
                                       rtol=CLIENT_RTOL)


@pytest.mark.slow
def test_replicated_batch_round_is_the_single_device_round(runs):
    """Batch 1 does not split over 2 data ranks, so each rank runs the
    client's whole batch on its gathered weights and keeps its slice of
    each gradient: one AdamW round on (1, 2, 1) equals the single-device
    K = 1 round bit for bit (loss, parameters and moments, each rank's
    block)."""
    cfg = S.dense_smoke(optimizer="adamw")
    sizes = {"pod": 1, "data": 2, "model": 1}
    specs = fl_step.state_specs(cfg, sizes, "adamw")
    specs = {"params": specs["params"], "opt": specs["opt"]}
    for r, out in enumerate(runs[(1, 2, 1)]):
        losses, got = out["k1"]
        want_losses, want = out["k1_single"]
        assert losses == want_losses
        blocks = R.blocks_of(S.whole(want), specs, sizes, r)
        for (path, a), b in zip(T.leaves_with_path(got), T.leaves(blocks)):
            np.testing.assert_array_equal(a, b.numpy(),
                                          err_msg="/".join(path))


@pytest.mark.slow
@pytest.mark.parametrize("kind", S.KINDS)
def test_aggregate_across_a_pod_axis_of_one_is_the_single_device(runs, kind):
    """On (1, 2, 1) the pod axis has one rank a line: ``aggregate_params``
    over it (K = 1) equals the single-device call on the rank's data block
    bit for bit, under every schedule."""
    bank, ref = S.agg_case(1)
    for r, out in enumerate(runs[(1, 2, 1)]):
        cut = lambda t: {k: shd.local_block(
            torch.from_numpy(v), (None,) + S.SHAPES[k][2], _grid(1, 2, 1),
            r).numpy() for k, v in t.items()}
        want = S.aggregate(cut(bank), cut(ref), kind, "fedavg")
        for k, w in want.items():
            np.testing.assert_array_equal(out["agg_k1"][kind][k], w,
                                          err_msg=k)


# ---------------------------------------------------------------------------
# Adafactor on (data, model) blocks
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 2, 2)])
@pytest.mark.parametrize("leaf", list(S.ADAFACTOR_LEAVES))
def test_adafactor_on_data_blocks_matches_whole_leaf(runs, leaf, shape):
    """Two Adafactor updates of a leaf split over the data ranks (its last
    dim, its second-to-last, an expert leaf with its experts on
    ``model``, a 1-D leaf, a leaf on both axes, or whole), on (1, 2, 1)
    and on (1, 2, 2) with the model axis too, against the update of the
    whole leaf: each rank's updates and factors are the whole ones' blocks
    within ``ADAFACTOR_RTOL`` relative, no absolute floor (a factor
    reduced over its split dims is whole on every rank)."""
    params, grads = MR.adafactor_case(leaves=S.ADAFACTOR_LEAVES)
    ups, factors = MR.adafactor_run(params, grads)
    spec = S.ADAFACTOR_LEAVES[leaf][1]
    parts = list(spec)          # the factors' specs (``opt_state_specs``)
    fac_spec = ({"vr": tuple(parts[:-1]), "vc": tuple(parts[:-2] + parts[-1:])}
                if len(spec) >= 2 else {"v": tuple(parts)})
    ranks = runs[shape]
    assert len(ranks) == int(np.prod(shape))
    for r, out in enumerate(ranks):
        got_ups, got_f = out["adafactor"]
        for step, (a, b) in enumerate(zip(got_ups, ups)):
            w = shd.local_block(torch.from_numpy(b[leaf]), spec,
                                _grid(*shape), r).numpy()
            np.testing.assert_allclose(a[leaf], w, rtol=ADAFACTOR_RTOL,
                                       atol=0, err_msg=f"step {step}")
        for k, s in fac_spec.items():
            w = shd.local_block(torch.from_numpy(factors[leaf][k]), s,
                                _grid(*shape), r).numpy()
            np.testing.assert_allclose(got_f[leaf][k], w,
                                       rtol=ADAFACTOR_RTOL, atol=0,
                                       err_msg=k)
        if not set(spec) - {None}:     # whole on every rank: no reduction
            np.testing.assert_array_equal(got_ups[-1][leaf], ups[-1][leaf])


# ---------------------------------------------------------------------------
# (d) rounds against the single device
# ---------------------------------------------------------------------------

def _compare_state(got, want) -> dict:
    """Every parameter and optimizer-state element of a rank's f32 state
    against the single device's blocks (numpy trees ``{"params", "opt"}``)
    -> per part, [elements, beyond ``ROUND_RTOL`` relative, beyond that and
    the part's floor: 2 x the learning rate, or ``STATE_FLOOR`` of the
    leaf's largest magnitude]."""
    out = {}
    for part in ("params", "opt"):
        n = out[part] = [0, 0, 0]
        for a, b in zip(T.leaves(got[part]), T.leaves(want[part])):
            b = np.asarray(b)
            floor = 2 * S.LR if part == "params" else \
                STATE_FLOOR * float(np.abs(b).max(initial=0.0))
            err = np.abs(a - b)
            rel = ROUND_RTOL * np.abs(b)
            n[0] += b.size
            n[1] += int((err > rel).sum())
            n[2] += int((err > rel + floor).sum())
    return out


def _add(total: dict, counts: dict):
    for part, n in counts.items():
        total[part] = [x + y for x, y in zip(total.get(part, (0, 0, 0)), n)]


def _assert_counts(total: dict, what: str):
    print(f"{what}: " + "; ".join(
        f"{part} {n[1]} of {n[0]} beyond {ROUND_RTOL} relative"
        for part, n in total.items()))
    for part, (n, rel, bad) in total.items():
        assert bad == 0, (part, bad, rel)
        assert rel <= MAX_SHARE_BEYOND * n, (part, rel, n)


@pytest.mark.slow
@pytest.mark.parametrize("i", range(len(S.ROUND_CASES)),
                         ids=["-".join(c) for c in S.ROUND_CASES])
def test_grid_rounds_match_single_device(runs, i):
    """Two f32 rounds on (2, 2, 1), K = 2 clients of 2 data ranks, batch 2
    split, against the single-device K = 2 rounds from the same bank and
    batches, aggregated per data block as the ranks aggregate them
    (``S.by_block``: under ``compressed`` each rank quantizes its block's
    rows): the losses within ``ROUND_RTOL``; parameters within
    ``ROUND_RTOL`` relative or 2 x the learning rate, optimizer state
    within ``ROUND_RTOL`` relative or ``STATE_FLOOR`` of its leaf's
    largest magnitude, and at most ``MAX_SHARE_BEYOND`` of either beyond
    ``ROUND_RTOL`` relative."""
    name, opt, kind = S.ROUND_CASES[i]
    cfg = S.round_cfg(name, opt)
    sizes = {"pod": 2, "data": 2, "model": 1}
    want_losses, want = S.f32_rounds(cfg, kind, 2, blocks=sizes)
    specs = fl_step.state_specs(cfg, sizes, opt)
    specs = {"params": specs["params"], "opt": specs["opt"]}
    total = {}
    for r, out in enumerate(runs[(2, 2, 1)]):
        losses, got = out["rounds"][i]
        np.testing.assert_allclose(losses, want_losses, rtol=ROUND_RTOL)
        _add(total, _compare_state(
            got, R.numpy_tree(R.blocks_of(S.whole(want), specs, sizes, r))))
    _assert_counts(total, f"{name}/{opt}/{kind}")


@pytest.mark.slow
@pytest.mark.parametrize("name", S.MOE_NAMES)
def test_moe_client_on_data_and_model_axes_matches_single_device(runs, name):
    """Two f32 Adafactor rounds of mixtral's (``moe``) and kimi-k2's
    (``kimi``: a dense first layer and a shared expert) smoke configs on
    (1, 2, 2), K = 1 (4 experts split over ``model``, ``embed`` over
    ``data``, batch 2 split), against the single device, held as
    ``test_grid_rounds_match_single_device`` holds its rounds."""
    cfg = S.round_cfg(name, "adafactor")
    want_losses, want = S.f32_rounds(cfg, "flat", 1)
    sizes = {"pod": 1, "data": 2, "model": 2}
    specs = fl_step.state_specs(cfg, sizes, "adafactor")
    specs = {"params": specs["params"], "opt": specs["opt"]}
    total = {}
    for r, out in enumerate(runs[(1, 2, 2)]):
        losses, got = out[name]
        np.testing.assert_allclose(losses, want_losses, rtol=ROUND_RTOL)
        _add(total, _compare_state(
            got, R.numpy_tree(R.blocks_of(S.whole(want), specs, sizes, r))))
    _assert_counts(total, f"{name} on (1, 2, 2)")


# ---------------------------------------------------------------------------
# (e) resume
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_shared_resume_under_adafactor_is_bit_for_bit(runs):
    """A (2, 2, 1) mixtral smoke trainer under Adafactor interrupted after
    round 0 and resumed from its checkpoint against an uninterrupted run:
    the same losses, parameters, factors and step, bit for bit; and the
    single-device K = 2 trainer restores the last checkpoint (the
    single-device format), its state's blocks the ranks'."""
    cfg = S.moe_smoke()
    one = SDFLMQTrainer(cfg, 2, 2, S.BPC, S.SEQ, seed=5, device="cpu",
                        ckpt_dir=str(runs["ckpt"]))
    assert one.start_round == 2
    state = {"params": one.state["params"], "opt": one.state["opt"]}
    sizes = {"pod": 2, "data": 2, "model": 1}
    specs = fl_step.state_specs(cfg, sizes, "adafactor")
    specs = {"params": specs["params"], "opt": specs["opt"]}
    for r, out in enumerate(runs[(2, 2, 1)]):
        first, start, second, got, step = out["resumed"]
        ms, want, want_step = out["straight"]
        assert start == 1 and len(first) == 1 and len(second) == 1
        assert [m["loss"] for m in first + second] == [m["loss"] for m in ms]
        assert step == want_step
        for a, b in zip(T.leaves(got), T.leaves(want)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(T.leaves(got), T.leaves(
                R.blocks_of(state, specs, sizes, r))):
            np.testing.assert_array_equal(a, b.float().numpy())


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_cli_pod_mesh_matches_single_device():
    """``--arch mixtral-8x22b --pod-mesh 2 --data-mesh 2`` (4 gloo ranks
    started by the CLI: 2 clients, each FSDP over 2 ranks, under
    Adafactor) prints the single-device trainer's K = 2 losses, within
    2e-4 (one unit of the 4 decimals printed and the bf16 rounds'
    drift)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--seq", "32", "--batch-per-client", "2", "--arch",
         "mixtral-8x22b", "--rounds", "2", "--pod-mesh", "2",
         "--data-mesh", "2"], capture_output=True, text=True,
        timeout=SPAWN_S, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    got = [float(ln.split()[3]) for ln in out.stdout.splitlines()
           if ln.startswith("round")]
    from repro_torch.launch import train
    cfg = train._config(types.SimpleNamespace(
        arch="mixtral-8x22b", smoke=True, local_steps=1, schedule="tree",
        pod_mesh=2))
    assert cfg.fl.mode == "shared"
    want = [m["loss"] for m in SDFLMQTrainer(
        cfg, 2, 2, 2, 32, device="cpu").run()]
    assert len(got) == 2 and all(abs(a - b) <= 2e-4
                                 for a, b in zip(got, want)), (got, want)
