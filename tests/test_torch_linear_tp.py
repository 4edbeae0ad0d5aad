"""RWKV6 and Hymba on the rank path: tensor parallelism over the mesh's
``model`` axis (``replica`` mode, their declared mode) and the ``shared``
mode (FSDP over ``data``), on gloo ranks spawned on the CPU, against the
JAX package and the port on one device.  The smoke configs: rwkv6-7b's
4 heads of 16 split at M = 2 and 4; hymba-1.5b's 4 q and 2 kv heads split
at M = 2, the kv heads whole at M = 4 (the mixed layout); and two configs
whose heads stay whole, as the reference's resolver leaves them: Hymba
with 5 q and 5 kv heads (hymba-1.5b's 25 / 5 at M = 2 or 4) and qwen2-7b
with 6 q heads at M = 4.

* (a) ``param_specs`` and ``opt_state_specs`` of rwkv6-7b and hymba-1.5b,
  full and smoke, in both modes, equal the reference's on (1, 2), (1, 4),
  (2, 2), (2, 2, 1) and (1, 2, 2) (pure logic); hymba-1.5b's heads stay
  whole at M = 2 and 4; whole mlp or vocab still raise;
* (b) a (1, M) client's f32 loss and gradients (rwkv6 at M = 2 and 4,
  Hymba at 2 and 4, the heads-whole Hymba at 2; rwkv6 and Hymba on
  (1, 2, 2) in shared mode, batch 2 split over data) against the
  reference's ``loss_fn`` under ``jax.grad`` at no mesh; every WKV call
  runs on the rank's heads with a contiguous decay;
* (c) the replicated leaves that feed a head-split computation get their
  whole gradient, equal on every model rank;
* (d) f32 rounds on (2, 2) and (2, 2, 1) against the port's single-device
  rounds aggregated per block;
* (e) qwen2-7b with its heads whole at M = 4 (part of (b));
* (f) a (2, 2) rwkv6 trainer under Adafactor resumes bit for bit and its
  checkpoint loads in the single-device trainer; the CLI on ``--model-mesh``
  and ``--pod-mesh``.

The multi-process tests carry the ``slow`` marker; the spawns run in a
thread while this process computes the reference's gradients."""
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import test_torch_linear_tp_ranks as L
import test_torch_shared_ranks as S
import test_torch_tp_ranks as R
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core import fl_step as ref_fl_step
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import model_api
from test_torch_common import assert_model_axis_runs, np_f32, ref_params
from test_torch_tp import ROOT, SPAWN_S, _env

# (b) the f32 client against the port's single device and against the
# reference's loss_fn at no mesh: the loss within 1e-5 relative; a
# gradient element within 5e-5 of its leaf's largest magnitude.  The
# row-parallel f32 sums round the activations differently from one GEMM,
# and a leaf whose gradient is a sum over the B x S positions of terms of
# both signs (Hymba's ``dt_bias``) keeps that difference at its scale: seen
# up to 2.2e-5 against the single device (``dt_bias`` at M = 4; every
# other leaf under 1.2e-5) and 2.8e-5 against the reference, from which
# the port's single device is itself 1.4e-5 on the heads-whole Hymba's
# ``dt_bias``.  A replicated leaf that lost a rank's part is off by
# tens of per cent.
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-5
# (d) the rounds, per element: parameters within ``ROUND_RTOL`` relative
# or 2 x lr (an AdamW step of an element whose gradient is near 0 can take
# the other sign), optimizer state within ``ROUND_RTOL`` relative or
# ``ROUND_RTOL`` of its leaf's largest magnitude; and at most 1 % of
# either beyond ``SHARE_RTOL`` relative, so that an error common to a
# leaf's elements fails even below the floor.  In shared mode (the data
# axis alone) both are tests/test_torch_shared.py's 1e-5 (0.24 % seen
# beyond it).  On the model axis the row-parallel sums leave the client's
# gradients up to 1.2e-5 of their leaf's largest magnitude apart (see
# above), AdamW's second moment squares that, and 2-7 % of the optimizer
# state's elements end beyond 1e-5 relative (the moments of near-zero
# gradients), under 0.5 % beyond 1e-4: there the element rule is 3e-5 and
# the share is taken at 1e-4
ROUND_RTOL = {"shared": 1e-5, "replica": 3e-5}
SHARE_RTOL = {"shared": 1e-5, "replica": 1e-4}
MAX_SHARE = 0.01
MESHES = [(1, 2), (1, 4), (2, 2), (2, 2, 1), (1, 2, 2)]
ARCHS = ("rwkv6-7b", "hymba-1.5b")


def _sizes(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return dict(zip(names, shape))


def _ref_mesh(shape):
    """The reference's spec functions read only ``shape`` and
    ``axis_names`` of a mesh."""
    sizes = _sizes(shape)
    return types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, PartitionSpec), tree
    return tuple(tree)


def _ref_cfg(name, mode="replica"):
    """The reference's config of an ``L.config`` case."""
    cfg = ref_smoke_config(ref_get_arch(L.ARCHS[name])).replace(
        **L.HEADS.get(name, {}))
    return cfg.replace(fl=cfg.fl.__class__(mode=mode))


# ---------------------------------------------------------------------------
# (a) specs and what still raises, pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES,
                         ids=["x".join(map(str, s)) for s in MESHES])
@pytest.mark.parametrize("mode", ["replica", "shared"])
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_linear_specs_match_reference(arch, size, mode, shape):
    """``param_specs`` and ``opt_state_specs`` under AdamW and Adafactor
    equal the reference's, spec for spec, and so do the client axis and
    count."""
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    if size == "smoke":
        ref_cfg, cfg = ref_smoke_config(ref_cfg), smoke_config(cfg)
    ref_cfg = ref_cfg.replace(fl=ref_cfg.fl.__class__(mode=mode))
    cfg = cfg.replace(fl=cfg.fl.__class__(mode=mode))
    sizes, mesh = _sizes(shape), _ref_mesh(shape)
    assert fl_step.param_specs(cfg, sizes) == _as_tuples(
        ref_fl_step.param_specs(ref_cfg, mesh))
    for opt in ("adamw", "adafactor"):
        assert fl_step.opt_state_specs(cfg, sizes, opt) == _as_tuples(
            ref_fl_step.opt_state_specs(ref_cfg, mesh, opt)), opt
    assert fl_step.client_axis_for(cfg, sizes) == \
        ref_fl_step.client_axis_for(ref_cfg, mesh)
    assert fl_step.n_clients_for(cfg, sizes) == \
        ref_fl_step.n_clients_for(ref_cfg, mesh)


@pytest.mark.parametrize("M", [2, 4])
def test_hymba_heads_stay_whole_where_they_do_not_divide(M):
    """hymba-1.5b's 25 q and 5 kv heads divide neither 2 nor 4: every
    ``heads`` and ``kv_heads`` dim stays whole on the model axis (the
    attention and the SSM branch whole on each rank), its conv (on
    ``embed``) too, while the MLP and the vocab split; rwkv6-7b's 64 heads
    split.  The model axis records which."""
    cfg = get_arch("hymba-1.5b")
    layer = fl_step.param_specs(cfg, {"data": 1, "model": M})["layers"]
    for leaf in ("wq", "wk", "wv", "wo"):
        assert "model" not in layer["attn"][leaf], leaf
    for leaf, spec in layer["ssm"].items():
        assert "model" not in spec, leaf
    assert layer["mlp"]["w_gate"] == (None, None, "model")
    axis = tpar.ModelAxis(None, M, 0, cfg)
    assert not axis.blocks["heads"] and not axis.blocks["kv_heads"]
    assert tpar.along(axis, "heads") is None
    blocks = tpar.split_blocks(cfg, M)
    assert blocks["mlp"] and blocks["vocab"] and not blocks["heads"]
    rwkv = get_arch("rwkv6-7b")
    assert tpar.head_counts(rwkv) == (64, 64)
    axis = tpar.axis_for(rwkv, types.SimpleNamespace(
        shape={"data": 1, "model": M}, group=lambda ax: None,
        coord=lambda ax: 0))
    assert axis.blocks["heads"] and tpar.along(axis, "heads") is axis
    assert fl_step.param_specs(rwkv, {"data": 1, "model": M})["layers"][
        "tm"]["wr"] == (None, None, "model", None)


@pytest.mark.parametrize("arch,kw,size,dim", [
    ("rwkv6-7b", {"d_model": 36, "rwkv_head_dim": 12}, 8, "mlp"),  # cm.wr
    ("rwkv6-7b", {"d_ff": 100}, 8, "mlp"),
    ("hymba-1.5b", {"d_ff": 100}, 8, "mlp"),
    ("hymba-1.5b", {"d_ff": 96}, 3, "vocab")])
def test_whole_mlp_or_vocab_on_model_axis_raise(arch, kw, size, dim):
    """A config whose ``mlp`` (for rwkv6 d_ff, or ``cm.wr``'s d_model, the
    ``mlp_r`` block) or ``vocab`` does not divide the model axis keeps it
    whole (``split_blocks``), as the heads may stay whole: the specs
    resolve as the reference's ``specs_for`` does and the round step
    builds (tests/test_torch_whole_tp.py runs such clients)."""
    cfg = smoke_config(get_arch(arch)).replace(**kw)
    block = "mlp_r" if "d_model" in kw else dim
    assert not tpar.split_blocks(cfg, size)[block]
    assert_model_axis_runs(cfg, {"data": 1, "model": size})


# ---------------------------------------------------------------------------
# the spawns, shared by the module
# ---------------------------------------------------------------------------

def _spawn(fn, shape, args=()):
    if len(shape) == 2:
        return mesh_lib.spawn(fn, shape[0], args, model=shape[1],
                              device="cpu", timeout_s=SPAWN_S)
    return mesh_lib.spawn(fn, shape[1], args, model=shape[2], pods=shape[0],
                          device="cpu", timeout_s=SPAWN_S)


def _ref_loss_and_grads(ref_cfg, params_np, batch_np):
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    fn = lambda p: ref_model_api.loss_fn(ref_cfg, p, batch)[0]
    loss, grads = jax.jit(jax.value_and_grad(fn))(params)
    return float(loss), np_f32(grads)


def _single_loss_and_grads(cfg, params_np, batch_np):
    """The port's single-device f32 loss and gradients."""
    params = T.tree_map(lambda a: torch.from_numpy(np.array(a))
                        .requires_grad_(), params_np)
    loss, _ = model_api.loss_fn(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch_np.items()})
    grads = torch.autograd.grad(loss, T.leaves(params))
    return loss.item(), T.unflatten_like(params, [g.numpy() for g in grads])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module, in a thread, while this process computes
    the reference's loss and gradients of each client case."""
    tmp = tmp_path_factory.mktemp("linear_tp")
    params = {name: np_f32(ref_params(_ref_cfg(name), seed=0))
              for name in L.ARCHS}
    batch = {name: R.grad_batch(L.config(name).vocab) for name in L.ARCHS}
    out, errors = {}, []

    def spawns():
        try:
            for shape, cases in L.CLIENT_CASES.items():
                out[shape] = _spawn(L.client_rank, shape, (
                    [c + (params[c[0]], batch[c[0]]) for c in cases],))
            out[(2, 2)] = _spawn(L.grid_rank, (2, 2), (str(tmp / "ck"),))
            out[(2, 2, 1)] = _spawn(L.shared_grid_rank, (2, 2, 1))
        except Exception as e:          # raised again below
            errors.append(e)
    th = threading.Thread(target=spawns)
    th.start()
    try:
        out["ref"] = {name: _ref_loss_and_grads(_ref_cfg(name), params[name],
                                                batch[name])
                      for name in L.ARCHS}
        out["single"] = {name: _single_loss_and_grads(
            L.config(name), params[name], batch[name]) for name in L.ARCHS}
    finally:
        th.join()
    if errors:
        raise errors[0]
    out["ckpt"] = tmp / "ck"
    return out


# ---------------------------------------------------------------------------
# (b), (e) one client against the reference
# ---------------------------------------------------------------------------

CLIENTS = [(shape, name) for shape, cases in L.CLIENT_CASES.items()
           for name, _, _ in cases]


def _mode(shape, name):
    return next(m for n, m, _ in L.CLIENT_CASES[shape] if n == name)


@pytest.mark.slow
@pytest.mark.parametrize("shape,name", CLIENTS,
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s, n in CLIENTS])
def test_client_matches_reference_loss_fn(runs, shape, name):
    """The client's f32 loss (the mean of its data ranks' losses in shared
    mode) and each rank's block of every leaf's gradient (of the leaf's
    largest magnitude) against the port's single device and against the reference's ``loss_fn`` at no mesh, within
    ``LOSS_RTOL`` and ``GRAD_RTOL``; every WKV call on the rank's heads
    (its block of ``u``), its decay contiguous."""
    ranks = [r[name] for r in runs[shape]]
    sizes = _sizes(shape)
    loss = np.mean([r["loss"] for r in ranks[::sizes["model"]]])
    cfg = L.config(name, _mode(shape, name))
    specs = fl_step.param_specs(cfg, sizes)
    for want_loss, want in (runs["single"][name], runs["ref"][name]):
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        whole = T.tree_map(torch.from_numpy, want)
        for r, out in enumerate(ranks):
            blocks = R.blocks_of(whole, specs, sizes, r)
            for (path, g), w in zip(T.leaves_with_path(out["grads"]),
                                    T.leaves(blocks)):
                w = w.numpy()
                assert g.shape == w.shape, path
                tol = GRAD_RTOL * np.abs(w).max()
                assert np.abs(g - w).max() <= tol, (
                    "/".join(path), r, np.abs(g - w).max(), tol)
    H, M = tpar.head_counts(cfg)[0], sizes["model"]
    split = H % M == 0
    assert ranks[0]["heads_split"] == split
    local = H // M if split else H
    n_wkv = 0 if cfg.family == "dense" else cfg.n_layers
    for out in ranks:
        assert len(out["wkv"]) == n_wkv
        for call in out["wkv"]:
            assert call["r"][2] == local and call["w_contiguous"]
            assert call["w"] == call["r"][:3] + (
                call["r"][3] if cfg.family == "rwkv" else 1,)
            assert call["u"] == ((local, cfg.rwkv_head_dim)
                                 if cfg.family == "rwkv" else None)


# ---------------------------------------------------------------------------
# (c) replicated leaves count once
# ---------------------------------------------------------------------------

# the replicated leaves whose outputs feed a head-split computation
REPLICATED = {"rwkv": ["layers/tm/mu", "layers/tm/lora_A", "layers/tm/lora_B",
                       "layers/tm/w0", "layers/ln1/scale", "layers/ln1/bias",
                       "layers/ln2/scale", "layers/ln2/bias",
                       "layers/cm/mu_k", "layers/cm/mu_r"],
              "hymba": ["layers/ssm/conv_w", "layers/ssm/conv_b"]}


@pytest.mark.slow
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", ["rwkv", "hymba"])
def test_replicated_leaves_count_once(runs, name, M):
    """With the heads split over M ranks, each replicated leaf in
    ``REPLICATED`` (rwkv6's ddlerp, decay, norms and channel-mix mixes;
    Hymba's conv, declared on ``embed`` and whole on the model axis) has
    the same gradient on every model rank, bit for bit, within
    ``GRAD_RTOL`` of the leaf's largest magnitude of the port's single
    device at f32.  A stream that skipped ``copy_to_model`` would carry
    only its rank's part of the gradient."""
    named = lambda t: dict(zip(fl_step.leaf_path_names(t), T.leaves(t)))
    ranks = [named(r[name]["grads"]) for r in runs[(1, M)]]
    assert runs[(1, M)][0][name]["heads_split"]
    want = named(runs["single"][name][1])
    for leaf in REPLICATED[name]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[leaf], ranks[0][leaf],
                                          err_msg=leaf)
        tol = GRAD_RTOL * np.abs(want[leaf]).max()
        assert np.abs(ranks[0][leaf] - want[leaf]).max() <= tol, leaf


# ---------------------------------------------------------------------------
# (d) rounds against the single device
# ---------------------------------------------------------------------------

ROUNDS = [((2, 2), c) for c in L.ROUND_CASES] + \
    [((2, 2, 1), c) for c in L.SHARED_ROUND_CASES]


@pytest.mark.slow
@pytest.mark.parametrize("shape,case", ROUNDS,
                         ids=[f"{'x'.join(map(str, s))}-{'-'.join(c)}"
                              for s, c in ROUNDS])
def test_grid_rounds_match_single_device(runs, shape, case):
    """Two f32 rounds, K = 2, batch 2 (split over the data ranks in shared
    mode), against the single-device K = 2 rounds aggregated per block as
    the ranks aggregate them: losses within 1e-5 relative; parameters
    within ``ROUND_RTOL`` relative or 2 x lr, optimizer state within
    ``ROUND_RTOL`` relative or of its leaf's largest magnitude; at most
    ``MAX_SHARE`` of either beyond ``SHARE_RTOL`` relative."""
    name, opt, kind = case
    mode = "shared" if len(shape) == 3 else "replica"
    cfg = L.round_cfg(name, opt, mode)
    sizes = _sizes(shape)
    want_losses, want = S.f32_rounds(cfg, kind, 2, blocks=sizes)
    specs = fl_step.state_specs(cfg, sizes, opt)
    specs = {"params": specs["params"], "opt": specs["opt"]}
    cases = L.ROUND_CASES if mode == "replica" else L.SHARED_ROUND_CASES
    i = cases.index(case)
    rtol, share = ROUND_RTOL[mode], SHARE_RTOL[mode]
    total = {"params": [0, 0, 0], "opt": [0, 0, 0]}
    for r, out in enumerate(runs[shape]):
        losses, got = out["rounds"][i]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        blocks = R.numpy_tree(R.blocks_of(S.whole(want), specs, sizes, r))
        for part, n in total.items():
            for a, b in zip(T.leaves(got[part]), T.leaves(blocks[part])):
                floor = 2 * S.LR if part == "params" else \
                    rtol * float(np.abs(b).max(initial=0.0))
                err = np.abs(a - b)
                n[0] += b.size
                n[1] += int((err > rtol * np.abs(b) + floor).sum())
                n[2] += int((err > share * np.abs(b)).sum())
    print(f"{shape} {name}/{opt}/{kind}: " + "; ".join(
        f"{part} {n[2]} of {n[0]} beyond {share} relative"
        for part, n in total.items()))
    for part, (n, bad, beyond) in total.items():
        assert bad == 0, (part, bad)
        assert beyond <= MAX_SHARE * n, (part, beyond, n)


# ---------------------------------------------------------------------------
# (f) resume and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_grid_resume_under_adafactor_is_bit_for_bit(runs):
    """A (2, 2) rwkv6 smoke trainer under Adafactor interrupted after
    round 0 and resumed from its block checkpoint against an uninterrupted
    run: the same losses, parameters, factors and step, bit for bit; the
    single-device K = 2 trainer restores the last checkpoint (the
    single-device format), its state's blocks the ranks'."""
    cfg = L.resume_cfg()
    one = SDFLMQTrainer(cfg, 2, S.ROUNDS, L.BPC, L.SEQ, seed=0, device="cpu",
                        ckpt_dir=str(runs["ckpt"]))
    assert one.start_round == 2
    state = {"params": one.state["params"], "opt": one.state["opt"]}
    sizes = {"data": 2, "model": 2}
    specs = fl_step.state_specs(cfg, sizes, "adafactor")
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
                R.blocks_of(state, specs, sizes, r))):
            np.testing.assert_array_equal(a, b.float().numpy())


@pytest.mark.slow
@pytest.mark.parametrize("arch,mesh", [
    ("rwkv6-7b", ["--data-mesh", "2", "--model-mesh", "2"]),
    ("hymba-1.5b", ["--pod-mesh", "2", "--data-mesh", "2"])])
def test_cli_mesh_matches_single_device(arch, mesh):
    """``--smoke --arch rwkv6-7b --data-mesh 2 --model-mesh 2`` and
    ``--arch hymba-1.5b --pod-mesh 2 --data-mesh 2`` (4 gloo ranks each,
    started by the CLI; batch 2, split over the data ranks in shared mode)
    print the single-device trainer's K = 2 losses, within 2e-4 (one unit
    of the 4 decimals printed and the bf16 rounds' drift)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--seq", "32", "--batch-per-client", "2", "--arch",
         arch, "--rounds", "2", *mesh], capture_output=True, text=True,
        timeout=SPAWN_S, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    got = [float(ln.split()[3]) for ln in out.stdout.splitlines()
           if ln.startswith("round")]
    cfg = train._config(types.SimpleNamespace(
        arch=arch, smoke=True, local_steps=1, schedule="tree",
        pod_mesh=2 if "--pod-mesh" in mesh else 0))
    assert cfg.fl.mode == ("shared" if "--pod-mesh" in mesh else "replica")
    want = [m["loss"] for m in SDFLMQTrainer(
        cfg, 2, 2, 2, 32, device="cpu").run()]
    assert len(got) == 2 and all(abs(a - b) <= 2e-4
                                 for a, b in zip(got, want)), (got, want)
