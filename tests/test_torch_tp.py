"""Tensor parallelism over the mesh's ``model`` axis (a client split over
M gloo ranks, spawned on the CPU) against the port on one device and
against the JAX package, at qwen2-7b's smoke config (4 q heads and 2 kv
heads: both split at M = 2; at M = 4 the q heads split and the kv heads
stay whole, the mixed layout).

* (a) every rank's ``local_block`` of each leaf, for (1, 2), (1, 4) and
  (2, 2) meshes, reassembles the leaf (pure logic);
* (b) the vocab-parallel lookup and cross-entropy equal the single-device
  ones;
* (c) at f32 parameters a (1, 2) and a (1, 4) client's loss and every
  gradient equal the single-device client's (the (1, 4) one with remat),
  and the (1, 2) client the reference's ``loss_fn`` under ``jax.grad``;
* (d) one (2, 2) trainer round equals the single-device K = 2 round, and
  a rank's ``init_state`` block is the single-device bank's block;
* (e) ``aggregate_params`` over (2, 2) ranks equals the reference's on a
  (2, 2) host mesh with model-split specs, and the single-device
  ``aggregate_params`` on each model block; on a (4, 2) mesh multi_krum
  chooses its clients in each model shard, as the reference does;
* (f) the CLI's ``--data-mesh 2 --model-mesh 2`` equals ``--clients 2``,
  and resumes; a (2, 2) trainer resumes bit for bit;
* (g) the other families and serving on a model axis above 1 build
  (tests/test_torch_linear_tp.py, tests/test_torch_encdec_tp.py hold
  them), and so does a config whose MLP, vocab or experts stay whole or
  whose q heads straddle kv groups (tests/test_torch_whole_tp.py runs
  them); the shared mode (the MoE configs' declared mode) and pods run
  there (tests/test_torch_shared.py holds them).

The reference runs in one subprocess (jax fixes its device count at its
first use) while the ranks run; each mesh is spawned once.  The
multi-process tests carry the ``slow`` marker."""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tp_ranks as R
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import model_api
from repro_torch.serve.engine import ServeEngine
from test_torch_common import (assert_model_axis_resolves,
                               assert_model_axis_runs, assert_trees_close,
                               bf16_ulp, np_f32, ref_params, smoke_cfgs)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_S = 300
# f32 client against the single device: the row-parallel sums add M
# partial products (and the vocab-parallel loss M partial sums) in another
# order than one GEMM; a few f32 roundings of the terms
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-6


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def _grid(D, M, rank=0):
    return types.SimpleNamespace(shape={"data": D, "model": M}, rank=rank,
                                 world=D * M, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# (a) local blocks, pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,M", [(1, 2), (1, 4), (2, 2)])
def test_local_blocks_reassemble_every_leaf(D, M):
    """Each leaf of the client-stacked bank is covered by its ranks'
    blocks: once a copy along the axes its spec does not name, and each
    block's values are the leaf's there."""
    cfg = R.qwen2_smoke()
    specs = T.leaves(fl_step.param_specs(cfg, {"data": D, "model": M}))
    bank = T.leaves(fl_step.init_state(cfg, D, 0, "cpu")["params"])
    for leaf, spec in zip(bank, specs):
        got = torch.zeros_like(leaf, dtype=torch.float32)
        cover = torch.zeros_like(got)
        for r in range(D * M):
            blk = shd.local_block(leaf, spec, _grid(D, M), r)
            for dim, ax in enumerate(spec):
                n = {"data": D, "model": M}.get(ax, 1)
                assert blk.shape[dim] == leaf.shape[dim] // n
            shd.local_block(got, spec, _grid(D, M), r).copy_(blk.float())
            shd.local_block(cover, spec, _grid(D, M), r).add_(1.0)
        copies = (1 if "data" in spec or D == 1 else D) * \
            (1 if "model" in spec else M)
        assert torch.equal(got, leaf.float())
        assert bool((cover == copies).all()), (spec, copies)


def test_mixed_heads_layout_at_four_ranks():
    """At M = 4 the smoke config's 4 q heads split and its 2 kv heads stay
    whole; rank m's q head m reads kv head m // 2.  With 6 q heads and 3
    kv heads at M = 2 a rank's 3 q heads straddle kv groups of 2: each
    reads its own kv head, the layout resolves as the reference's
    ``specs_for`` does and the round step builds."""
    cfg = R.qwen2_smoke()
    specs = fl_step.param_specs(cfg, {"data": 1, "model": 4})["layers"]
    assert specs["attn"]["wq"] == (None, None, "model", None)
    assert specs["attn"]["wk"] == (None, None, None, None)
    assert specs["attn"]["bk"] == (None, None, None)
    for m in range(4):
        axis = tpar.ModelAxis(None, 4, m, cfg)
        assert tpar.kv_index(axis, 1).tolist() == [m // 2]
    axis = tpar.ModelAxis(None, 2, 1, cfg)
    assert axis.blocks["kv_heads"] and tpar.kv_index(axis, 2) is None
    # a rank's q heads straddling two kv groups: one kv head a q head
    straddle = cfg.replace(n_heads=6, n_kv_heads=3)
    for m, reads in enumerate([[0, 0, 1], [1, 2, 2]]):
        axis = tpar.ModelAxis(None, 2, m, straddle)
        assert axis.straddle and tpar.kv_index(axis, 3).tolist() == reads
    assert_model_axis_runs(straddle, {"data": 1, "model": 2})


# ---------------------------------------------------------------------------
# the spawns and the reference, shared by the module
# ---------------------------------------------------------------------------

_REF_AGG = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.aggregation import aggregate_params
from repro.core.clustering import build_tree
from repro.core.topology import AggSchedule, compile_tree
import test_torch_tp_ranks as R

assert jax.device_count() == 8
out = {}
for D in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:2 * D]).reshape(D, 2),
                ("data", "model"))
    bank, ref = R.agg_case(D, outliers=D == 4)
    specs = {k: P(*R.spec_of(k)) for k in bank}
    clients = [f"c{i}" for i in range(D)]
    tree = compile_tree(build_tree("s", clients, clients,
                                   aggregator_ratio=0.5, levels=3))
    jx = lambda t: {k: jnp.asarray(t[k]).astype(R.SHAPES[k][1])
                    for k in sorted(t)}
    for kind, strat, dead in R.agg_cases(D):
        sched = tree if kind == "tree" else AggSchedule(kind, D)
        def run(t, w, r):
            return aggregate_params(t, w, mesh, "data", sched, specs,
                                    strategy=strat, ref_params=r)
        legs = [("jit", jax.jit(run))] + [("eager", run)] * (
            kind == "compressed")
        for leg, fn in legs:
            with mesh:
                got = fn(jx(bank), jnp.asarray(R.WEIGHTS[D][dead]), jx(ref))
            for k in bank:
                a = np.asarray(got[k].astype(jnp.float32))
                out[f"{D}|{kind}|{strat}|{dead}|{leg}|{k}"] = a[0]
np.savez(sys.argv[1], **out)
print("REFERENCE AGGREGATED", len(out))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module, while the reference's aggregation runs
    in its subprocess: the (1, 2) and (1, 4) clients, the (2, 2) grid and
    the (4, 2) aggregation."""
    tmp = tmp_path_factory.mktemp("tp")
    ref_path = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_AGG, str(ref_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    try:
        ref_cfg, cfg = smoke_cfgs()
        rp = np_f32(ref_params(ref_cfg, seed=0))
        batch = R.grad_batch(cfg.vocab)
        out = {"params": rp, "batch": batch}
        for M, remat in ((2, False), (4, True)):
            out[(1, M)] = mesh_lib.spawn(R.client_rank, 1, (rp, batch, remat),
                                         model=M, device="cpu",
                                         timeout_s=SPAWN_S)
        out[(2, 2)] = mesh_lib.spawn(R.grid_rank, 2, (str(tmp / "ck"), 2),
                                     model=2, device="cpu", timeout_s=SPAWN_S)
        out[(4, 2)] = mesh_lib.spawn(R.agg_rank, 4, model=2, device="cpu",
                                     timeout_s=SPAWN_S)
        stdout, stderr = proc.communicate(timeout=SPAWN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"{stdout[-2000:]}\n{stderr[-3000:]}"
    out["ref"] = dict(np.load(ref_path))
    out["ckpt"] = tmp / "ck"
    return out


def _single_grads(cfg, params_np, batch_np):
    params = T.tree_map(lambda a: torch.from_numpy(np.array(a))
                        .requires_grad_(), params_np)
    loss, _ = model_api.loss_fn(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch_np.items()})
    grads = torch.autograd.grad(loss, T.leaves(params))
    return loss.item(), T.unflatten_like(params, list(grads))


# ---------------------------------------------------------------------------
# (b), (c) one client over its model ranks
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("M", [2, 4])
def test_vocab_parallel_lookup_and_cross_entropy(runs, M):
    """Each rank's lookup is the whole table's; the loss and its gradient
    (each rank's vocab columns) equal ``model_api.cross_entropy``'s, the
    loss within one f32 rounding of its sums."""
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((256, 16)).astype(np.float32))
    logits = torch.from_numpy(
        rng.standard_normal((2, 5, 256)).astype(np.float32) * 3)
    ids = torch.from_numpy(rng.integers(0, 256, (2, 5)).astype(np.int64))
    lg = logits.clone().requires_grad_()
    ce = model_api.cross_entropy(lg, ids)
    grad = torch.autograd.grad(ce, lg)[0].numpy()
    for m, out in enumerate(runs[(1, M)]):
        np.testing.assert_array_equal(out["lookup"], table[ids].numpy())
        np.testing.assert_allclose(out["ce"], ce.item(), rtol=LOSS_RTOL)
        cols = slice(m * 256 // M, (m + 1) * 256 // M)
        np.testing.assert_allclose(out["ce_grad"], grad[..., cols],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("M", [2, 4])
def test_client_over_model_ranks_matches_single_device_f32(runs, M):
    """The loss and every leaf's gradient (each rank's block of it; the
    norm scales, and at M = 4 ``wk``/``wv``/``bk``/``bv``, whole on every
    rank) against the single-device client at f32, within
    ``GRAD_RTOL``/``GRAD_ATOL``."""
    cfg = R.qwen2_smoke(remat=M == 4)
    loss, grads = _single_grads(cfg, runs["params"], runs["batch"])
    specs = fl_step.param_specs(cfg, {"data": 1, "model": M})
    for r, out in enumerate(runs[(1, M)]):
        np.testing.assert_allclose(out["loss"], loss, rtol=LOSS_RTOL)
        want = R.blocks_of(grads, specs, _grid(1, M), r)
        for (path, g), w, s in zip(T.leaves_with_path(out["grads"]),
                                   T.leaves(want), T.leaves(specs)):
            assert g.shape == tuple(w.shape), path
            np.testing.assert_allclose(g, w.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg="/".join(path))
    kv = runs[(1, M)][0]["grads"]["layers"]["attn"]
    if M == 4:                    # kv whole: its gradient counted once
        assert kv["wk"].shape == tuple(grads["layers"]["attn"]["wk"].shape)


@pytest.mark.slow
def test_client_over_two_ranks_matches_reference_loss_fn(runs):
    """The (1, 2) client against the reference's ``model_api.loss_fn``
    under ``jax.grad`` on one device, at f32 (the tolerances of
    tests/test_torch_model.py's f32 test)."""
    ref_cfg, cfg = smoke_cfgs()
    params = jax.tree_util.tree_map(jnp.asarray, runs["params"])
    batch = {k: jnp.asarray(v) for k, v in runs["batch"].items()}
    fn = lambda p: ref_model_api.loss_fn(ref_cfg, p, batch)[0]
    want_loss, want = jax.jit(jax.value_and_grad(fn))(params)
    specs = fl_step.param_specs(cfg, {"data": 1, "model": 2})
    for r, out in enumerate(runs[(1, 2)]):
        np.testing.assert_allclose(out["loss"], float(want_loss), rtol=1e-5)
        blocks = R.blocks_of(
            T.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                       np_f32(want)), specs, _grid(1, 2), r)
        got = T.tree_map(torch.from_numpy, out["grads"])
        assert_trees_close(got, T.tree_map(lambda t: t.numpy(), blocks),
                           rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (d) rounds over a (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_grid_init_state_is_the_single_device_block(runs):
    cfg = R.qwen2_smoke()
    full = fl_step.init_state(cfg, 2, 0, "cpu")
    full = {"params": full["params"], "opt": full["opt"]}
    specs = fl_step.state_specs(cfg, {"data": 2, "model": 2}, "adamw")
    specs = {"params": specs["params"], "opt": specs["opt"]}
    for r, out in enumerate(runs[(2, 2)]):
        want = R.blocks_of(full, specs, _grid(2, 2), r)
        for a, b in zip(T.leaves(out["init"]), T.leaves(want)):
            np.testing.assert_array_equal(a, b.float().numpy())


@pytest.mark.slow
@pytest.mark.parametrize("i", range(len(R.ROUND_CASES)),
                         ids=[f"{k}-{s}" for k, s, _ in R.ROUND_CASES])
def test_grid_round_matches_single_device(runs, i):
    """bf16 qwen2-7b smoke rounds of the trainer, K = 2 clients each split
    over 2 ranks, against the single-device K = 2 rounds from the same bank
    and batches: each round's loss within 1e-5 relative, and the same
    block on both ranks of a model column.  Round 0 runs at a learning
    rate of 0 (the warmup), so after it the globals differ only by the
    aggregation: within one bf16 ulp, except under ``compressed``, whose
    int8 rows are the model block's rows (the reference's per-shard
    quantization): there within one bf16 ulp and one quantization step of
    the row (below 2 x its largest value / 127).  Round 1 updates: an
    element whose f32 gradient is near 0 can take AdamW's step of about
    the learning rate (3e-4 there) with the other sign, so after two
    rounds each value is within one bf16 ulp and 2 x 3e-4, and at most
    1 % of them beyond one bf16 ulp."""
    kind, strat, rounds = R.ROUND_CASES[i]
    want_ms, want = R.trainer_round(R.qwen2_smoke(), kind, strat,
                                    rounds=rounds)
    specs = fl_step.param_specs(R.qwen2_smoke(), {"data": 1, "model": 2})
    whole = T.tree_map(torch.from_numpy, want)
    ranks = runs[(2, 2)]
    beyond = total = 0
    for r, out in enumerate(ranks):
        ms, got = out["rounds"][i]
        assert [m["level_groups"] for m in ms] == [
            m["level_groups"] for m in want_ms]
        for a, b in zip(ms, want_ms):
            assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        blocks = R.blocks_of(whole, specs, _grid(1, 2), r % 2)
        for a, b, z in zip(T.leaves(got), T.leaves(blocks),
                           T.leaves(ranks[r % 2]["rounds"][i][1])):
            np.testing.assert_array_equal(a, z)     # same on its column
            b = b.numpy()
            err, ulp = np.abs(a - b), bf16_ulp(b)
            if kind == "compressed":
                rows = np.abs(b).reshape(-1, b.shape[-1] if b.ndim else 1)
                ulp = ulp + (2 * rows.max(-1, keepdims=True) / 127).reshape(
                    b.shape[:-1] + (1,) if b.ndim else ())
            if rounds == 1:
                assert (err <= ulp).all()
                continue
            assert (err <= ulp + 2 * 3e-4).all()
            beyond += int((err > ulp).sum())
            total += err.size
    assert beyond <= 0.01 * total, (beyond, total)


# ---------------------------------------------------------------------------
# (e) aggregate_params over (data, model) ranks
# ---------------------------------------------------------------------------

def _assert_matches_reference(got, ref, D, kind, strat, dead):
    """multi_krum and ``compressed`` (against the reference's eager form)
    bit for bit; the other sums within rtol 2e-5, atol 1e-6, or one bf16
    ulp for a bf16 leaf (tests/test_torch_dist.py's rule)."""
    for k in got:
        key = f"{D}|{kind}|{strat}|{dead}|{{}}|{k}"
        if strat == "multi_krum":
            np.testing.assert_array_equal(got[k], ref[key.format("jit")],
                                          err_msg=k)
        elif kind == "compressed":
            np.testing.assert_array_equal(got[k], ref[key.format("eager")],
                                          err_msg=k)
        else:
            want = ref[key.format("jit")]
            tol = 2e-5 * np.abs(want) + 1e-6
            if R.SHAPES[k][1] == "bfloat16":
                tol = np.maximum(tol, bf16_ulp(want))
            assert (np.abs(got[k] - want) <= tol).all(), k


def _whole(blocks_by_rank, D, M):
    """The rank 0 .. M-1 blocks (client 0's column of slot 0) put back
    together, leaf by leaf (the aggregate is the same in every slot)."""
    out = {}
    for k, (shape, _, spec) in R.SHAPES.items():
        if k not in blocks_by_rank[0]:
            continue
        leaf = torch.zeros(shape)
        for m in range(M):
            shd.local_block(leaf, spec, _grid(1, M), m).copy_(
                torch.from_numpy(blocks_by_rank[m][k]))
        out[k] = leaf.numpy()
    return out


@pytest.mark.slow
@pytest.mark.parametrize("dead", [False, True], ids=["all_live", "dead_row"])
@pytest.mark.parametrize("strat", R.STRATEGIES)
@pytest.mark.parametrize("kind", R.KINDS)
def test_aggregate_over_grid_matches_reference_mesh(runs, kind, strat, dead):
    ranks = runs[(2, 2)]
    for chunk in R.CHUNKS:
        case = (chunk, kind, strat, dead)
        for r, out in enumerate(ranks):       # the same on its column
            for k, v in out["agg"][case].items():
                np.testing.assert_array_equal(
                    v, ranks[r % 2]["agg"][case][k])
        got = _whole([ranks[m]["agg"][case] for m in range(2)], 2, 2)
        _assert_matches_reference(got, runs["ref"], 2, kind, strat, dead)


@pytest.mark.slow
@pytest.mark.parametrize("dead", [False, True], ids=["all_live", "dead_row"])
@pytest.mark.parametrize("strat", R.STRATEGIES)
@pytest.mark.parametrize("kind", R.KINDS)
def test_aggregate_over_grid_matches_single_device_blocks(runs, kind, strat,
                                                          dead):
    """Each rank's block against the single-device ``aggregate_params`` on
    that model block of the bank: multi_krum and ``compressed`` bit for
    bit, the sums within one rounding of the f32 sum at the block's
    largest magnitude, or one bf16 ulp for a bf16 leaf."""
    bank, ref = R.agg_case(2)
    for r, out in enumerate(runs[(2, 2)]):
        cut = lambda t: {k: shd.local_block(
            torch.from_numpy(v), (None,) + R.SHAPES[k][2], _grid(2, 2),
            r).numpy() for k, v in t.items()}
        want = R.aggregate(cut(bank), cut(ref), kind, strat, dead)
        for chunk in R.CHUNKS:
            got = out["agg"][(chunk, kind, strat, dead)]
            for k, w in want.items():
                if kind == "compressed" or strat == "multi_krum":
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
                else:
                    tol = np.full(w.shape, 4 * 2.0 ** -23 * np.abs(w).max(),
                                  np.float32)
                    if R.SHAPES[k][1] == "bfloat16":
                        tol = np.maximum(tol, bf16_ulp(w))
                    assert (np.abs(got[k] - w) <= tol).all(), k


@pytest.mark.slow
def test_multi_krum_chooses_in_each_model_shard(runs):
    """(4, 2): client 1 is far off in model shard 0 only and client 2 in
    shard 1 only.  The reference's multi_krum drops client 1 in shard 0
    and client 2 in shard 1; the ranks match it bit for bit, and the
    result differs from the whole-model choice of one device."""
    ranks = runs[(4, 2)]
    case = ("flat", "multi_krum", False)
    bank, _ = R.agg_case(4, outliers=True)
    whole_choice = R.aggregate(bank, bank, *case)
    for chunk in R.CHUNKS:
        for r, out in enumerate(ranks):
            for k, v in out[(chunk,) + case].items():
                np.testing.assert_array_equal(v, ranks[r % 2][(chunk,) + case][k])
        got = _whole([ranks[m][(chunk,) + case] for m in range(2)], 4, 2)
        _assert_matches_reference(got, runs["ref"], 4, *case)
        for k, v in got.items():
            spec = R.SHAPES[k][2]
            dim = spec.index("model")
            half = v.shape[dim] // 2
            keep = [[0, 2, 3], [0, 1, 3]]        # each shard's choice
            for m in range(2):
                part = (slice(None),) * dim + (slice(m * half,
                                                     (m + 1) * half),)
                want = bank[k][keep[m]][(slice(None),) + part].mean(0)
                tol = bf16_ulp(want) if R.SHAPES[k][1] == "bfloat16" \
                    else 1e-6 * np.abs(want) + 1e-6
                assert (np.abs(v[part] - want) <= tol).all(), (k, m)
            assert not np.allclose(v, whole_choice[k])


# ---------------------------------------------------------------------------
# (f) the CLI and resume
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_grid_resume_is_bit_for_bit(runs):
    """A (2, 2) trainer interrupted after round 0 and resumed from its
    checkpoint (rank 0 assembles every rank's block into the single-device
    format, and scatters the blocks back) against an uninterrupted run:
    the same losses, parameters, moments and step, bit for bit; and the
    checkpoint restores into a single-device K = 2 state whose blocks are
    the ranks'."""
    from repro_torch.ckpt.manager import CheckpointManager
    cfg = R.qwen2_smoke()
    one = fl_step.init_state(cfg, 2, 5, "cpu")
    CheckpointManager(str(runs["ckpt"])).restore_latest(one)
    one = {"params": one["params"], "opt": one["opt"]}
    specs = fl_step.state_specs(cfg, {"data": 2, "model": 2}, "adamw")
    specs = {"params": specs["params"], "opt": specs["opt"]}
    for r, out in enumerate(runs[(2, 2)]):
        first, start, second, state, step = out["resumed"]
        ms, want, want_step = out["straight"]
        assert start == 1 and len(first) == 1 and len(second) == 1
        assert [m["loss"] for m in first + second] == [m["loss"] for m in ms]
        assert step == want_step
        for a, b in zip(T.leaves(state), T.leaves(want)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(T.leaves(state), T.leaves(
                R.blocks_of(one, specs, _grid(2, 2), r))):
            np.testing.assert_array_equal(a, b.float().numpy())


@pytest.mark.slow
def test_cli_grid_matches_single_device_and_resumes(tmp_path):
    """``--data-mesh 2 --model-mesh 2`` (4 gloo ranks, started by the CLI)
    prints the single-device ``--clients 2`` trainer's losses; a second
    run on its checkpoint directory resumes at round 2 and prints the
    single device's round 2.  The losses agree within 2e-4: one unit of
    the 4 decimals printed and the bf16 rounds' drift (1e-5 relative a
    round, ``test_grid_round_matches_single_device``)."""
    common = ["-m", "repro_torch.launch.train", "--device", "cpu",
              "--smoke", "--seq", "32", "--batch-per-client", "2"]

    def losses(*extra):
        out = subprocess.run([sys.executable, *common, *extra],
                             capture_output=True, text=True,
                             timeout=SPAWN_S, cwd=ROOT, env=_env())
        assert out.returncode == 0, out.stderr[-3000:]
        rows = [ln.split() for ln in out.stdout.splitlines()
                if ln.startswith("round")]
        return [(r[1], float(r[3]), r[-1]) for r in rows]
    grid = ["--data-mesh", "2", "--model-mesh", "2", "--ckpt-dir",
            str(tmp_path)]
    got = losses("--rounds", "2", *grid) + losses("--rounds", "3", *grid)
    want = losses("--rounds", "3", "--clients", "2")
    assert [(r, c) for r, _, c in got] == [(r, c) for r, _, c in want]
    assert len(got) == 3 and all(abs(a[1] - b[1]) <= 2e-4
                                 for a, b in zip(got, want)), (got, want)


# ---------------------------------------------------------------------------
# (g) what a model axis does not run yet
# ---------------------------------------------------------------------------

def _with(arch, mode="replica", **kw):
    cfg = smoke_config(get_arch(arch)).replace(**kw)
    return cfg.replace(fl=cfg.fl.__class__(mode=mode))


def _fake_mesh(D, M, rank=0):
    """``_grid`` with what building a step reads of a mesh: no process
    group (every group is the default one)."""
    d, m = divmod(rank, M)
    return types.SimpleNamespace(
        shape={"data": D, "model": M}, rank=rank, world=D * M,
        device=torch.device("cpu"), group=lambda ax: None,
        coord=lambda ax: {"data": d, "model": m}[ax])


# the MoE configs run on a model axis in replica mode (the trainer's CLI
# mode) and, since item 5b-iii, in their declared shared mode (a mesh
# without pods: one client, FSDP over data and TP over model); RWKV6 and
# Hymba run there in their declared replica mode since item 5b-iv
# (tests/test_torch_linear_tp.py), and so do the encoder-decoder and the
# VLM since item 5b-vii (tests/test_torch_encdec_tp.py)
@pytest.mark.parametrize("arch,item,mode", [
    ("mixtral-8x22b", "5b-iii", "shared"),
    ("kimi-k2-1t-a32b", "5b-iii", "shared"),
    ("rwkv6-7b", "5b-iv", "replica"), ("hymba-1.5b", "5b-iv", "replica"),
    ("whisper-small", "5b-vii", "replica"),
    ("internvl2-2b", "5b-vii", "replica")])
def test_other_families_on_model_axis_raise(arch, item, mode):
    cfg = _with(arch, mode, optimizer="adamw")
    sizes = {"data": 2, "model": 2}
    for r in range(4):
        got = fl_step.init_state(cfg, _grid(2, 2, r), 0)["params"]
        want = fl_step.abstract_state(cfg, _grid(2, 2, r))["params"]
        assert [t.shape for t in T.leaves(got)] == [
            t.shape for t in T.leaves(want)]
    specs = fl_step.param_specs(cfg, sizes)
    layer = specs.get("layers")
    if mode == "shared":
        assert layer["moe"]["w_gate"] == (None, "model", "data", None)
    elif item == "5b-iv":           # the clients on data, the heads split
        heads = layer["tm"]["wr"] if "tm" in layer else layer["ssm"]["in_w"]
        assert heads == ("data", None, None, "model", None)
    elif cfg.family == "encdec":    # the cross-attention's heads split
        assert specs["dec_layers"]["cross"]["wq"] == (
            "data", None, None, "model", None)
    else:                           # the patch projection's feat_dim
        assert specs["vis_proj"]["w"] == ("data", "model", None)
    assert callable(fl_step.build_fl_round_step(
        cfg, _fake_mesh(2, 2), R.schedule("flat", 2)))


def test_adafactor_shared_mode_and_pods_on_model_axis_raise():
    # Adafactor runs on a model axis, also where the experts and their
    # width stay whole: every rank's state holds the whole expert leaves
    moe = _with("mixtral-8x22b", optimizer="adafactor")
    moe = moe.replace(moe=moe.moe.__class__(n_experts=3, top_k=2,
                                            d_ff_expert=30))
    got = fl_step.init_state(moe, _grid(1, 4), 0)["params"]["layers"]
    want = fl_step.abstract_state(moe, 1)["params"]["layers"]
    assert [t.shape for t in T.leaves(got["moe"])] == [
        t.shape for t in T.leaves(want["moe"])]
    assert_model_axis_runs(moe, {"data": 1, "model": 4})
    # the shared mode and pods on a model axis run (item 5b-iii): a step
    # builds, with a data axis (FSDP) beside the model axis
    cfg = R.qwen2_smoke()
    shared = cfg.replace(fl=cfg.fl.__class__(mode="shared"))
    assert callable(fl_step.build_fl_round_step(shared, _fake_mesh(2, 2),
                                                R.schedule("flat", 2)))
    assert fl_step.data_axis_for(shared, _fake_mesh(2, 2)).size == 2
    assert mesh_lib.check_axes(2, pods=2) is None
    # a model axis that leaves the smoke vocab (256) and MLP (128) whole
    # runs: the CLI's config resolves as the reference's and its step
    # builds (tests/test_torch_whole_tp.py runs such clients)
    cfg = train._config(types.SimpleNamespace(
        arch="whisper-small", smoke=True, local_steps=1, schedule="tree",
        pod_mesh=0))
    blocks = tpar.split_blocks(cfg, 3)
    assert not blocks["vocab"] and not blocks["mlp"]
    assert_model_axis_runs(cfg, {"data": 1, "model": 3})


def test_serving_on_model_axis_raises():
    """Serving on a model axis runs for the dense family (ROADMAP item
    5b-v) and, since item 5b-vii, for the encoder-decoder and the VLM: the
    engine builds on (1, 2) with its model axis; so it does for a config
    whose MLP stays whole on the axis, which resolves as the reference's
    ``specs_for`` does (tests/test_torch_whole_tp.py serves such
    configs)."""
    mesh = _grid(1, 2)
    mesh.group = lambda ax: None
    mesh.coord = lambda ax: 0
    for arch in ("whisper-small", "internvl2-2b"):
        cfg = smoke_config(get_arch(arch))
        assert ServeEngine(cfg, {}, mesh=mesh).tp.size == 2
        odd = cfg.replace(d_ff=129)
        engine = ServeEngine(odd, {}, mesh=mesh)
        assert engine.tp.size == 2 and not engine.tp.blocks["mlp"]
        assert_model_axis_resolves(odd, {"data": 1, "model": 2})
    engine = ServeEngine(R.qwen2_smoke(), {}, mesh=mesh)
    assert engine.tp.size == 2 and engine.device == torch.device("cpu")
    engine = ServeEngine(R.qwen2_smoke(), {}, mesh=_grid(1, 1))  # a card
    assert engine.tp is None and engine.device == torch.device("cpu")
