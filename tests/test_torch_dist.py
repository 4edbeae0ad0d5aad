"""The port's client mesh over ``torch.distributed`` ranks against the JAX
package and against the port on one device.

* The spec functions (``specs_for`` through ``fl_step.state_specs``,
  ``inputs.batch_specs``) equal the reference's PartitionSpecs for every
  arch config, both FL modes and the mesh shapes (4, 1), (4, 2) and (2, 4):
  pure logic, no process group.
* ``aggregate_params`` over 4 gloo ranks (spawned on the CPU) equals the
  reference's ``aggregate_params`` on a (data=4, model=1) host mesh (in a
  subprocess, since jax fixes the device count at its first use) under
  ``tree`` (two levels), ``flat``, ``rs_ag`` and ``compressed``, for
  fedavg, fedprox, trimmed_mean, coordinate_median and multi_krum, with
  and without a zero-weight client.  The tolerance of each case is stated
  at ``_assert_matches_reference``.  Against the single-device port,
  ``compressed`` and the stack strategies are equal bit for bit; the sum
  schedules within one rounding of the f32 sum (four terms in another
  order), at most one bf16 ulp after the cast.
* A rank's ``init_state`` slot (parameters and optimizer state) and its
  client's batch equal the single-device ones; one qwen2-7b smoke round
  over 4 ranks equals the single-device K = 4 round; the counterparts of
  the reference's multi-device tests (red under jax 0.9, ROADMAP R1) run
  on the port's ranks; the CLI's ``--data-mesh 2`` equals ``--clients 2``
  on one device; a rank's failure or a hang fails the caller.

Each multi-process test carries the ``slow`` marker, as
tests/test_multidevice.py's do, and every spawn its own time limit."""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import test_torch_dist_ranks as R
from repro.api import strategies as RS
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_arch as ref_get_arch
from repro.core import fl_step as ref_fl_step
from repro.core.clustering import build_tree as ref_build_tree
from repro.core.topology import compile_tree as ref_compile_tree
from repro.models import inputs as ref_inputs
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.configs.base import (SHAPES, get_arch, list_archs,
                                      smoke_config)
from repro_torch.core import fl_step
from repro_torch.data.federated import FederatedTokens
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import inputs
from test_torch_common import assert_model_axis_runs, bf16_ulp

ROOT = Path(__file__).resolve().parents[1]
MESH_SHAPES = [(4, 1), (4, 2), (2, 4)]
SPAWN_S = 300                        # each spawn's time limit


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


# ---------------------------------------------------------------------------
# specs: pure logic
# ---------------------------------------------------------------------------

def _ref_mesh(data, model):
    """The reference's spec functions read only ``shape`` and
    ``axis_names`` of a mesh."""
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, PartitionSpec), tree
    return tuple(tree)


def _with_mode(cfg, mode):
    return cfg.replace(fl=dataclasses.replace(cfg.fl, mode=mode))


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("mode", ["replica", "shared"])
@pytest.mark.parametrize("arch", list_archs())
def test_state_specs_match_reference(arch, mode, shape):
    """``param_specs``, ``opt_state_specs`` (the config's optimizer) and
    ``state_specs`` equal the reference's, spec for spec."""
    ref_cfg = _with_mode(ref_get_arch(arch), mode)
    cfg = _with_mode(get_arch(arch), mode)
    opt = ref_make_optimizer(ref_cfg).name
    sizes = {"data": shape[0], "model": shape[1]}
    want = _as_tuples(ref_fl_step.state_specs(ref_cfg, _ref_mesh(*shape),
                                              opt))
    got = fl_step.state_specs(cfg, sizes, opt)
    assert got == want
    assert fl_step.n_clients_for(cfg, sizes) == ref_fl_step.n_clients_for(
        ref_cfg, _ref_mesh(*shape))
    assert fl_step.client_axis_for(cfg, sizes) == \
        ref_fl_step.client_axis_for(ref_cfg, _ref_mesh(*shape))


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_match_reference(arch, shape):
    """Every assigned input shape, with and without a client dim."""
    sizes = {"data": shape[0], "model": shape[1]}
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    for name, sc in SHAPES.items():
        for clients in ([0, shape[0]] if sc.kind == "train" else [0]):
            kw = dict(clients=clients, axis_sizes=sizes,
                      client_axis="data" if clients else None)
            want = _as_tuples(ref_inputs.batch_specs(
                ref_cfg, REF_SHAPES[name], **kw))
            assert inputs.batch_specs(cfg, sc, **kw) == want, (name, clients)


def test_abstract_state_is_the_whole_state_on_meta():
    cfg = R.qwen2_smoke()
    state = fl_step.init_state(cfg, 4, 0, "cpu")
    abstract = fl_step.abstract_state(cfg, {"data": 4, "model": 1})
    leaves = T.leaves({"o": abstract["opt"], "p": abstract["params"]})
    assert all(t.device.type == "meta" for t in leaves)
    assert [(t.shape, t.dtype) for t in leaves] == [
        (t.shape, t.dtype) for t in T.leaves({"o": state["opt"],
                                              "p": state["params"]})]


def test_model_axis_and_pods_raise():
    """A model axis runs every family (tests/test_torch_tp.py,
    tests/test_torch_encdec_tp.py) and pods the shared mode
    (tests/test_torch_shared.py); what still raises: fewer than 0 pods and
    a model axis below 1.  A model axis that leaves an MLP or the vocab
    whole runs (tests/test_torch_whole_tp.py): the CLI's whisper-small
    smoke config on ``--model-mesh 3`` (its vocab and MLP whole, its heads
    whole) resolves as the reference's ``specs_for`` does and its round
    step builds."""
    assert mesh_lib.check_axes(1, pods=2) is None
    with pytest.raises(ValueError, match="pods"):
        mesh_lib.check_axes(1, pods=-1)
    with pytest.raises(ValueError, match="model axis of 0"):
        mesh_lib.init_mesh(4, 0, rank=0, device="cpu")
    cfg = train._config(types.SimpleNamespace(
        arch="whisper-small", smoke=True, local_steps=1, schedule="tree",
        pod_mesh=0))
    assert not any(v for k, v in tpar.split_blocks(cfg, 3).items())
    assert_model_axis_runs(cfg, {"data": 1, "model": 3})


def _fake_mesh(shape, rank):
    """A mesh object as far as building a step reads one: no process
    group (every group is the default one)."""
    coords = dict(zip(shape, np.unravel_index(rank, tuple(shape.values()))))
    return types.SimpleNamespace(
        shape=shape, rank=rank, world=int(np.prod(list(shape.values()))),
        device=torch.device("cpu"), group=lambda ax: None,
        coord=lambda ax: int(coords[ax]))


def test_shared_mode_on_ranks_raises():
    """A mesh without pods in shared mode (once raising, ROADMAP item
    5b-iii) is one client fully sharded over its 4 data ranks, as the
    reference's ``client_axis_for`` makes it: each rank's ``init_state``
    is its block of the K = 1 state (the embed dim in quarters) and the
    round step builds.  The VLM, which raised there before ROADMAP item
    5b-vii, does the same: its patch projection's ``embed`` dim in
    quarters too."""
    cfg = R.adafactor_smoke()
    cfg = cfg.replace(fl=dataclasses.replace(cfg.fl, mode="shared"))
    sizes = {"data": 4, "model": 1}
    assert fl_step.client_axis_for(cfg, sizes) is None
    assert fl_step.n_clients_for(cfg, sizes) == 1
    whole = fl_step.init_state(cfg, 1, 0, "cpu")
    specs = fl_step.state_specs(cfg, sizes, "adafactor")
    assert specs["params"]["embed"]["in_table"] == ("model", "data")
    for r in range(4):
        mesh = _fake_mesh(sizes, r)
        got = fl_step.init_state(cfg, mesh, 0)
        for key in ("params", "opt"):
            for a, b, s in zip(T.leaves(got[key]), T.leaves(whole[key]),
                               T.leaves(specs[key])):
                assert torch.equal(a, shd.local_block(b, s, sizes, r))
    assert callable(fl_step.build_fl_round_step(cfg, mesh,
                                                R.schedule("flat")))
    vlm = smoke_config(get_arch("internvl2-2b"))
    vlm = vlm.replace(fl=dataclasses.replace(vlm.fl, mode="shared"))
    whole = fl_step.init_state(vlm, 1, 0, "cpu")["params"]
    specs = fl_step.param_specs(vlm, sizes)
    assert specs["vis_proj"]["w"] == ("model", "data")
    for r in range(4):
        got = fl_step.init_state(vlm, _fake_mesh(sizes, r), 0)["params"]
        for a, b, s in zip(T.leaves(got), T.leaves(whole), T.leaves(specs)):
            assert torch.equal(a, shd.local_block(b, s, sizes, r))
    assert callable(fl_step.build_fl_round_step(vlm, _fake_mesh(sizes, 0),
                                                R.schedule("flat")))


def test_cuda_mesh_never_drops_to_gloo():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the mesh would take it")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_lib.init_mesh(1, rank=0, device="cuda")


def test_client_batch_is_the_global_batch_row():
    data = FederatedTokens(256, 4, seed=0)
    for step in range(3):
        glob = data.global_batch(4, 2, 16, step)
        for r in range(4):
            row = data.client_batch(r, 2, 16, step)
            for k in glob:
                np.testing.assert_array_equal(row[k], glob[k][r])


# ---------------------------------------------------------------------------
# aggregate_params over 4 ranks
# ---------------------------------------------------------------------------

_REF_AGG = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.aggregation import aggregate_params
from repro.core.clustering import build_tree
from repro.core.topology import AggSchedule, compile_tree
import test_torch_dist_ranks as R

assert jax.device_count() == 4
mesh = jax.make_mesh((4, 1), ("data", "model"))
bank, ref = R.agg_case()
clients = [f"c{i}" for i in range(R.K)]
tree = compile_tree(build_tree("s", clients, clients, aggregator_ratio=0.5,
                               levels=3))
specs = {k: P("data") for k in R.SHAPES}
jx = lambda t: {k: jnp.asarray(t[k]).astype(R.SHAPES[k][1])
                for k in sorted(t)}
out, legs_of = {}, {}
for kind, strat, dead in R.agg_cases():
    if (kind, strat) not in legs_of:      # one trace for both weightings
        sched = tree if kind == "tree" else AggSchedule(kind, R.K)
        def run(t, w, r, sched=sched, strat=strat):
            return aggregate_params(t, w, mesh, "data", sched, specs,
                                    strategy=strat, ref_params=r)
        # op by op (~8 s a case) only where a test reads it:
        # compressed's sums
        legs_of[kind, strat] = [("jit", jax.jit(run))] + [("eager", run)] * (
            kind == "compressed" and strat not in R.STACK)
    for leg, fn in legs_of[kind, strat]:
        with mesh:
            got = fn(jx(bank), jnp.asarray(R.WEIGHTS[dead]), jx(ref))
        for k, (shape, dt) in R.SHAPES.items():
            a = np.asarray(got[k].astype(dt).astype(jnp.float32))
            assert a.shape == (R.K,) + shape, (k, a.shape)
            out[f"{kind}|{strat}|{dead}|{leg}|{k}"] = a[0]
np.savez(sys.argv[1], **out)
print("REFERENCE AGGREGATED", len(out))
'''


@pytest.fixture(scope="module")
def agg_runs(tmp_path_factory):
    """(the reference's outputs, each rank's outputs, the single-device
    port's outputs) for every ``R.agg_cases`` case."""
    path = tmp_path_factory.mktemp("ref_agg") / "ref.npz"
    out = subprocess.run(
        [sys.executable, "-c", _REF_AGG, str(path)], capture_output=True,
        text=True, timeout=SPAWN_S, cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert out.returncode == 0, f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}"
    ref = dict(np.load(path))
    ranks = mesh_lib.spawn(R.agg_rank, R.K, device="cpu", timeout_s=SPAWN_S)
    bank, ref_in = R.agg_case()
    single = {case: R.aggregate(bank, ref_in, *case)
              for case in R.agg_cases()}
    return ref, ranks, single


def _assert_matches_reference(got, ref, kind, strat, dead):
    """Against the reference, leaf by leaf:
    * ``compressed`` (sum strategies): op by op, bit for bit; jitted, XLA
      takes ``amax/127`` as a reciprocal multiply and fuses the qagg sum,
      so a few f32 ulps of the sum (and a bf16 ulp for bf16 leaves), with
      one quantization step allowed for at most 1 % of the values, as
      tests/test_torch_compressed.py holds it;
    * trimmed_mean, coordinate_median, multi_krum: bit for bit (jitted);
    * the other sums: rtol 2e-5, atol 1e-6 (tests/test_multidevice.py), or
      one bf16 ulp for a bf16 leaf where that is more (the cast after a
      sum in another order)."""
    stack = strat in R.STACK
    w = np.asarray(R.WEIGHTS[dead], np.float32)
    bank, ref_in = R.agg_case()
    for k, (shape, dt) in R.SHAPES.items():
        key = f"{kind}|{strat}|{dead}|{{}}|{k}"
        g, jit = got[k], ref[key.format("jit")]
        if stack:
            np.testing.assert_array_equal(g, jit, err_msg=k)
        elif kind == "compressed":
            np.testing.assert_array_equal(g, ref[key.format("eager")],
                                          err_msg=k)
            x = bank[k]
            if strat == "fedprox":        # the premapped contribution
                x = RS.get_strategy(strat).premap(
                    {"x": x}, {"x": ref_in[k]}, np)["x"]
            G = shape[-1] if shape else 1
            x3 = x.reshape(R.K, -1, G)
            step = ((np.abs(x3 * w.reshape(R.K, 1, 1)).max(-1) / 127)
                    .sum(0) / w.sum()).reshape(-1, 1)
            g0 = np.abs(g.reshape(-1, G))
            cast = 2.0 ** -7 * g0 if dt == "bfloat16" else 0.0
            near = 4 * 127 * 2.0 ** -23 * step + 2.0 ** -23 * g0 + cast
            d0 = np.abs(g - jit).reshape(-1, G)
            assert (d0 <= step + near).all(), k
            assert (d0 <= near).mean() >= 0.99, (k, (d0 <= near).mean())
        else:
            tol = 2e-5 * np.abs(jit) + 1e-6
            if dt == "bfloat16":
                tol = np.maximum(tol, bf16_ulp(jit))
            assert (np.abs(g - jit) <= tol).all(), (
                k, np.abs(g - jit).max())


@pytest.mark.slow
@pytest.mark.parametrize("dead", [False, True], ids=["all_live", "dead_row"])
@pytest.mark.parametrize("strat", R.STRATEGIES)
@pytest.mark.parametrize("kind", R.KINDS)
def test_aggregate_over_ranks_matches_reference_mesh(agg_runs, kind, strat,
                                                     dead):
    ref, ranks, _ = agg_runs
    for r, out in enumerate(ranks):
        for chunk in R.CHUNKS:
            got = out[(chunk, kind, strat, dead)]
            # every rank holds the same aggregate
            for k in R.SHAPES:
                np.testing.assert_array_equal(
                    got[k], ranks[0][(chunk, kind, strat, dead)][k])
            _assert_matches_reference(got, ref, kind, strat, dead)


@pytest.mark.slow
@pytest.mark.parametrize("dead", [False, True], ids=["all_live", "dead_row"])
@pytest.mark.parametrize("strat", R.STRATEGIES)
@pytest.mark.parametrize("kind", R.KINDS)
def test_aggregate_over_ranks_matches_single_device(agg_runs, kind, strat,
                                                    dead):
    """``compressed`` and the stack strategies bit for bit; the sums over
    ranks (``tree``/``flat``/``rs_ag``) within one rounding of the f32 sum
    at each leaf's largest magnitude, or one bf16 ulp for a bf16 leaf."""
    _, ranks, single = agg_runs
    want = single[(kind, strat, dead)]
    exact = kind == "compressed" or strat in R.STACK
    for chunk in R.CHUNKS:
        got = ranks[0][(chunk, kind, strat, dead)]
        for k, (_, dt) in R.SHAPES.items():
            if exact:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                tol = np.full(want[k].shape, 4 * 2.0 ** -23
                              * np.abs(want[k]).max(), np.float32)
                if dt == "bfloat16":
                    tol = np.maximum(tol, bf16_ulp(want[k]))
                assert (np.abs(got[k] - want[k]) <= tol).all(), k


def test_tree_schedules_agree_between_packages():
    """The test tree has at least two levels, and the port's copied
    clustering compiles it to the reference's groups and masks."""
    clients = [f"c{i}" for i in range(R.K)]
    want = ref_compile_tree(ref_build_tree("s", clients, clients,
                                           aggregator_ratio=0.5, levels=3))
    got = R.tree_schedule()
    assert len(got.level_groups) >= 2
    assert (got.level_groups, got.head_masks) == (want.level_groups,
                                                  want.head_masks)


# ---------------------------------------------------------------------------
# rounds over 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def round_runs():
    ranks = mesh_lib.spawn(R.round_rank, R.K, device="cpu",
                           timeout_s=SPAWN_S)
    single = [R.trainer_round(R.qwen2_smoke(), *case)
              for case in R.ROUND_CASES]
    return ranks, single


@pytest.mark.slow
def test_rank_init_state_is_the_single_device_slot(round_runs):
    """Parameters and AdamW moments (qwen2-7b), and Adafactor's factored
    state (mixtral-8x22b), of rank r equal slot r of the single-device
    ``init_state(cfg, K, seed)``."""
    ranks, _ = round_runs
    for name, cfg, seed in (("init", R.qwen2_smoke(), 0),
                            ("adafactor", R.adafactor_smoke(), 3)):
        full = fl_step.init_state(cfg, R.K, seed, "cpu")
        full = R.numpy_tree({"params": full["params"], "opt": full["opt"]})
        for r, out in enumerate(ranks):
            got = T.leaves(out[name])
            want = T.leaves(full)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.shape == (1,) + b.shape[1:]
                np.testing.assert_array_equal(a[0], b[r])


@pytest.mark.slow
@pytest.mark.parametrize("i", range(len(R.ROUND_CASES)),
                         ids=[f"{k}-{s}" for k, s, _ in R.ROUND_CASES])
def test_round_over_ranks_matches_single_device(round_runs, i):
    """One qwen2-7b smoke round (K = 4, one client a rank) against the
    single-device K = 4 round from the same bank and batches: the loss
    within 1e-6 relative; the global bit for bit under ``compressed`` and
    the stack strategies (c3 dead), within one bf16 ulp under the sum
    schedules; the same global on every rank."""
    ranks, single = round_runs
    kind, strat, _ = R.ROUND_CASES[i]
    want_ms, want = single[i]
    for r, out in enumerate(ranks):
        ms, got = out["rounds"][i]
        assert ms[0]["n_clients"] == want_ms[0]["n_clients"]
        assert ms[0]["level_groups"] == want_ms[0]["level_groups"]
        assert abs(ms[0]["loss"] - want_ms[0]["loss"]) <= 1e-6 * abs(
            want_ms[0]["loss"])
        for a, b, z in zip(T.leaves(got), T.leaves(want),
                           T.leaves(ranks[0]["rounds"][i][1])):
            np.testing.assert_array_equal(a, z)
            if kind == "compressed" or strat in ("trimmed_mean",
                                                  "multi_krum"):
                np.testing.assert_array_equal(a, b)
            else:
                assert (np.abs(a - b) <= bf16_ulp(b)).all()


@pytest.mark.slow
def test_fl_step_schedules_agree():
    """Port of tests/test_multidevice.py::test_fl_step_schedules_agree
    (scripts/smoke_flstep.py) on 4 ranks, a model axis of 1: tree == flat
    at its tolerance (rtol 2e-2, atol 1e-3), every rank the same global,
    and the abstract state's leaves."""
    ranks = mesh_lib.spawn(R.schedules_rank, R.K,
                           ("qwen2-7b", ("tree", "flat")), device="cpu",
                           timeout_s=SPAWN_S)
    for out, n_abstract in ranks:
        tree, flat = out["tree"][1], out["flat"][1]
        assert n_abstract == len(T.leaves(tree))
        for a, b, z in zip(T.leaves(tree), T.leaves(flat),
                           T.leaves(ranks[0][0]["tree"][1])):
            np.testing.assert_array_equal(a, z)
            np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-3)
        assert np.isfinite(out["tree"][0])


@pytest.mark.slow
def test_compressed_and_rsag_schedules_match_flat():
    """Port of tests/test_multidevice.py::
    test_compressed_and_rsag_schedules_match_flat (hymba-1.5b's smoke
    config, weights 1..4) on 4 ranks, at its tolerances: rs_ag 5e-3,
    compressed 2e-2."""
    ranks = mesh_lib.spawn(R.schedules_rank, R.K,
                           ("hymba-1.5b", ("flat", "rs_ag", "compressed")),
                           device="cpu", timeout_s=SPAWN_S)
    for out, _ in ranks:
        for kind, tol in (("rs_ag", 5e-3), ("compressed", 2e-2)):
            for a, b in zip(T.leaves(out[kind][1]),
                            T.leaves(out["flat"][1])):
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.slow
def test_e2e_trainer_with_failure_and_resume(tmp_path):
    """Port of tests/test_multidevice.py::
    test_e2e_trainer_with_failure_and_resume on 4 ranks: qwen1.5-4b's
    smoke config, c3 dies at round 2, 3 clients after it, losses finite
    and not rising, and a new trainer on the checkpoint starts at 4."""
    ranks = mesh_lib.spawn(R.resume_rank, R.K,
                           (str(tmp_path), "qwen1.5-4b", 4, {2: ["c3"]}),
                           device="cpu", timeout_s=SPAWN_S)
    for first, start, second, _, _ in ranks:
        assert len(first) == 4
        assert first[-1]["n_clients"] == 3, first[-1]
        assert all(np.isfinite(m["loss"]) for m in first)
        assert first[-1]["loss"] <= first[0]["loss"] + 0.1
        assert start == 4 and second == []
    assert (tmp_path / "step_4" / "COMMITTED").exists()


@pytest.mark.slow
def test_resume_over_ranks_is_bit_for_bit(tmp_path):
    """2 ranks, interrupted after round 1 and resumed from its checkpoint
    (rank 0 gathers every slot into the single-device format and scatters
    them back), against an uninterrupted 2-rank run of 4 rounds: the
    same losses, parameters, moments and step count, bit for bit; and the
    checkpoint restores into a single-device K = 2 state."""
    args = ("qwen2-7b", 4, {})
    resumed = mesh_lib.spawn(R.resume_rank, 2, (str(tmp_path),) + args
                             + (1,), device="cpu", timeout_s=SPAWN_S)
    straight = mesh_lib.spawn(R.straight_rank, 2, args, device="cpu",
                              timeout_s=SPAWN_S)
    for (first, start, second, state, step), (ms, want, want_step) in zip(
            resumed, straight):
        assert start == 2 and len(first) == 2 and len(second) == 2
        assert [m["loss"] for m in first + second] == [m["loss"]
                                                       for m in ms]
        assert step == want_step
        for a, b in zip(T.leaves(state), T.leaves(want)):
            np.testing.assert_array_equal(a, b)
    # the last checkpoint (round 4) is the final state in the
    # single-device format: slot r is rank r's
    from repro_torch.ckpt.manager import CheckpointManager
    one = fl_step.init_state(R.qwen2_smoke(), 2, 5, "cpu")
    CheckpointManager(str(tmp_path)).restore_latest(one)
    assert one["step"] == resumed[0][4]
    full = T.leaves(R.numpy_tree({"opt": one["opt"],
                                 "params": one["params"]}))
    for r, (_, _, _, state, _) in enumerate(resumed):
        for a, b in zip(T.leaves(state), full):
            np.testing.assert_array_equal(a[0], b[r])


@pytest.mark.slow
def test_resume_over_ranks_with_split_leaves_is_bit_for_bit(tmp_path):
    """2 ranks with the checkpoint's part limit lowered to 16 KiB in each
    rank's process: rank 0 saves the gathered state's larger leaves as
    parts (``_gathered_state``), and a resume after round 0 scatters them
    back (``_restore_mesh``): the losses, parameters, moments and step of
    an uninterrupted 2-rank run, bit for bit; the newest checkpoint
    restores into a single-device K = 2 state, slot r rank r's."""
    args = ("qwen2-7b", 2, {})
    resumed = mesh_lib.spawn(R.split_resume_rank, 2,
                             (1 << 14, str(tmp_path)) + args + (0,),
                             device="cpu", timeout_s=SPAWN_S)
    straight = mesh_lib.spawn(R.straight_rank, 2, args, device="cpu",
                              timeout_s=SPAWN_S)
    for (first, start, second, state, step), (ms, want, want_step) in zip(
            resumed, straight):
        assert start == 1 and len(first) == 1 and len(second) == 1
        assert [m["loss"] for m in first + second] == [m["loss"]
                                                       for m in ms]
        assert step == want_step
        for a, b in zip(T.leaves(state), T.leaves(want)):
            np.testing.assert_array_equal(a, b)
    for step in (1, 2):
        manifest = json.loads(
            (tmp_path / f"step_{step}" / "manifest.json").read_text())
        split = [s for s in manifest["leaves"] if "parts" in s]
        assert len(split) >= 3 and all(len(s["parts"]) > 1 for s in split)
    from repro_torch.ckpt.manager import CheckpointManager
    one = fl_step.init_state(R.qwen2_smoke(), 2, 5, "cpu")
    CheckpointManager(str(tmp_path)).restore_latest(one)
    assert one["step"] == resumed[0][4]
    full = T.leaves(R.numpy_tree({"opt": one["opt"],
                                 "params": one["params"]}))
    for r, (_, _, _, state, _) in enumerate(resumed):
        for a, b in zip(T.leaves(state), full):
            np.testing.assert_array_equal(a[0], b[r])


@pytest.mark.slow
def test_cli_data_mesh_matches_single_device():
    """``--data-mesh 2`` (2 gloo ranks, started by the CLI) prints the
    single-device ``--clients 2`` trainer's losses, to the 4 decimals it
    prints: at 2 clients every sum has two terms, so both are equal."""
    common = ["-m", "repro_torch.launch.train", "--device", "cpu",
              "--smoke", "--rounds", "2", "--seq", "32",
              "--batch-per-client", "2"]

    def losses(*extra):
        out = subprocess.run([sys.executable, *common, *extra],
                             capture_output=True, text=True,
                             timeout=SPAWN_S, cwd=ROOT, env=_env())
        assert out.returncode == 0, out.stderr[-3000:]
        rows = [ln.split() for ln in out.stdout.splitlines()
                if ln.startswith("round")]
        return [(r[1], r[3], r[-1]) for r in rows]
    got, want = losses("--data-mesh", "2"), losses("--clients", "2")
    assert len(got) == 2 and got == want


@pytest.mark.slow
def test_a_failing_rank_fails_the_spawn():
    with pytest.raises(Exception, match="fails on purpose"):
        mesh_lib.spawn(R.failing_rank, 2, (1,), device="cpu", timeout_s=60)


@pytest.mark.slow
def test_a_hung_rank_times_out():
    with pytest.raises(TimeoutError):
        mesh_lib.spawn(R.sleeping_rank, 2, (120,), device="cpu",
                       timeout_s=5)
