"""The model axis where the reference's resolver leaves a dim whole: the
padded vocab, an MLP width (the FFN, an MoE config's shared expert and
dense layers, RWKV6's ``cm.wr``, the VLM's ``feat_dim``), the experts and
their width; and the q heads that split while the kv heads stay whole,
where a rank's q heads straddle kv groups.  Each block whose dim stays
whole runs its plain code on every rank of the client
(``tensor_parallel.split_blocks``, ``along``).

* (a) for every config, published and smoke, at M = 2, 3, 4, 6, 8 and 16,
  in ``replica`` and ``shared`` mode: each leaf's split or whole decision
  (``split_blocks`` through the block the leaf belongs to) is the
  reference's ``specs_for``'s, and ``param_specs`` and ``serve_specs``
  equal the reference's; where the q heads split and the kv heads stay
  whole, each rank's kv heads are those its q heads read and the gather
  of every rank's keys holds each kv head (pure logic);
* (b) on gloo ranks spawned on the CPU, a (1, 3) and a (1, 2) client's
  f32 loss and gradients against the port's single device and the
  reference's ``loss_fn`` under ``jax.grad``, for configs with the vocab,
  an MLP, the experts or every dim whole at M = 3 and with straddling q
  heads at M = 2 and 3; every leaf the axis leaves whole has the same
  gradient on every rank; every flash call on the rank's q heads, with one
  kv head a q head where they straddle; serving (prefill and
  teacher-forced decode) on (1, 2) and (1, 3) against the single device;
  f32 rounds on (2, 2) (``compressed`` with a whole MLP, Adafactor) and
  on (2, 1, 2) in shared mode against the single device aggregated per
  block; a (2, 2) trainer with whole leaves under Adafactor resumed from
  its block checkpoint bit for bit.

The spawns run in a thread while this process computes the reference's
and the single device's results.  The multi-process tests carry the
``slow`` marker."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_encdec_tp_ranks as E
import test_torch_shared_ranks as S
import test_torch_tp_ranks as R
import test_torch_whole_tp_ranks as W
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, list_archs, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import model_api
from test_torch_common import (as_jax, assert_model_axis_resolves,
                               bf16_normal, np_f32, ref_params)
from test_torch_serve_tp import REL, _rel
from test_torch_tp import SPAWN_S

# (b) the client: the loss within 1e-5 relative, a gradient element
# within 5e-5 of its leaf's largest magnitude (tests/test_torch_linear_tp.py's
# tolerances: the row-parallel f32 sums round the activations once where
# one GEMM does)
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-5
# the rounds: tests/test_torch_linear_tp.py's rule on the model axis
ROUND_RTOL = {"shared": 3e-5, "replica": 3e-5}
SHARE_RTOL = {"shared": 1e-4, "replica": 1e-4}
MAX_SHARE = 0.01
SIZES = (2, 3, 4, 6, 8, 16)


def _with_mode(cfg, mode):
    return cfg.replace(fl=cfg.fl.__class__(mode=mode))


# ---------------------------------------------------------------------------
# (a) decisions and specs, pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("mode", ["replica", "shared"])
@pytest.mark.parametrize("arch,smoke", [(a, s) for a in list_archs()
                                        for s in (False, True)],
                         ids=[f"{a}{'-smoke' if s else ''}"
                              for a in list_archs() for s in (False, True)])
def test_split_blocks_match_reference_specs(arch, smoke, mode, M):
    """Each parameter leaf puts on ``model`` exactly the dim the
    reference's ``specs_for`` does under ``rules_for(mode)`` on a (2, M)
    mesh, as the port decides it block by block (``split_blocks``: the
    MoE layer's form names the experts or their width, or neither); and
    ``param_specs`` and ``serve_specs`` equal the reference's."""
    cfg = get_arch(arch)
    cfg = _with_mode(smoke_config(cfg) if smoke else cfg, mode)
    assert_model_axis_resolves(cfg, {"data": 2, "model": M})


@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("arch", list_archs())
def test_kv_heads_read_where_q_heads_straddle(arch, M):
    """Where the q heads split and the kv heads stay whole, rank r's
    ``kv_index`` is the kv head each of its q heads reads (h // (H / Kv))
    or, where they lie in one group, that one; ``kv_read`` projects those
    kv heads once each; and in the rank-ordered gather of every rank's
    keys, ``kv_gather_index`` finds every kv head."""
    cfg = get_arch(arch)
    H, Kv = tpar.head_counts(cfg)
    axes = [tpar.ModelAxis(None, M, r, cfg) for r in range(M)]
    if not axes[0].blocks["heads"] or axes[0].blocks["kv_heads"]:
        assert not axes[0].straddle
        return
    local, group = H // M, H // Kv
    gathered = []
    for r, axis in enumerate(axes):
        reads = [(r * local + i) // group for i in range(local)]
        got = tpar.kv_index(axis, local).tolist()
        assert got == (reads if axis.straddle else reads[:1])
        heads, expand = tpar.kv_read(axis, local)
        assert heads.tolist() == sorted(set(reads))
        seen = heads.tolist() if expand is None else \
            heads[expand].tolist()
        assert seen == got
        gathered += got
    assert axes[0].straddle == (group % local != 0)
    assert [gathered[i] for i in tpar.kv_gather_index(axes[0])] == \
        list(range(Kv))


# ---------------------------------------------------------------------------
# (b) the spawns and the single device's and the reference's results
# ---------------------------------------------------------------------------

def _ref_cfg(name, mode="replica"):
    arch, over = W.CASES[name]
    cfg = ref_smoke_config(ref_get_arch(arch)).replace(**over)
    if cfg.family == "encdec":
        import dataclasses
        cfg = cfg.replace(frontend=dataclasses.replace(
            cfg.frontend, n_tokens=E.FRAMES))
    return cfg.replace(fl=cfg.fl.__class__(mode=mode))


def _grad_batch(name, seed=1):
    """Two rows of GRAD_SEQ tokens (and frames or patches, exact in
    bf16)."""
    cfg = W.config(name)
    b = R.grad_batch(cfg.vocab, seed)
    if cfg.frontend is not None:
        fe = cfg.frontend
        b[E.frontend_name(cfg)] = bf16_normal(
            (2, fe.n_tokens, fe.feat_dim), seed + 10)
    return b


def _ref_loss_and_grads(ref_cfg, params_np, batch_np):
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    batch = as_jax(batch_np)            # frames and patches in bf16
    fn = lambda p: ref_model_api.loss_fn(ref_cfg, p, batch)[0]
    loss, grads = jax.jit(jax.value_and_grad(fn))(params)
    return float(loss), np_f32(grads)


def _single_loss_and_grads(cfg, params_np, batch_np):
    params = T.tree_map(lambda a: torch.from_numpy(np.array(a))
                        .requires_grad_(), params_np)
    loss, _ = model_api.loss_fn(cfg, params, E.as_batch(batch_np))
    grads = torch.autograd.grad(loss, T.leaves(params))
    return loss.item(), T.unflatten_like(params, [g.numpy() for g in grads])


def _sizes(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return dict(zip(names, shape))


def _spawn(fn, shape, args=()):
    if len(shape) == 2:
        return mesh_lib.spawn(fn, shape[0], args, model=shape[1],
                              device="cpu", timeout_s=SPAWN_S)
    return mesh_lib.spawn(fn, shape[1], args, model=shape[2], pods=shape[0],
                          device="cpu", timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module, in a thread, while this process computes
    the reference's and the single device's client losses and gradients
    and the single device's serving."""
    tmp = tmp_path_factory.mktemp("whole_tp")
    names = sorted({n for ns in W.CLIENT_CASES.values() for n in ns})
    params = {n: np_f32(ref_params(_ref_cfg(n), seed=0)) for n in names}
    batch = {n: _grad_batch(n) for n in names}
    out, errors = {}, []

    def spawns():
        try:
            for shape, cases in W.CLIENT_CASES.items():
                out[shape] = _spawn(W.client_rank, shape, (
                    [(n, params[n], batch[n]) for n in cases],
                    W.SERVE_CASES[shape], params))
            out[(2, 2)] = _spawn(W.grid_rank, (2, 2), (str(tmp / "ck"),))
            out[(2, 1, 2)] = _spawn(W.shared_rank, (2, 1, 2))
        except Exception as e:          # raised again below
            errors.append(e)
    th = threading.Thread(target=spawns)
    th.start()
    try:
        out["ref"] = {n: _ref_loss_and_grads(_ref_cfg(n), params[n],
                                             batch[n]) for n in names}
        out["single"] = {n: _single_loss_and_grads(W.config(n), params[n],
                                                   batch[n]) for n in names}
        for shape, cases in W.SERVE_CASES.items():
            for i, (name, lens, _) in enumerate(cases):
                out[("serve", shape, i)] = W.serve(
                    W.config(name), S.whole(params[name]), lens, i)
    finally:
        th.join()
    if errors:
        raise errors[0]
    out["ckpt"] = tmp / "ck"
    return out


CLIENTS = [(shape, name) for shape, names in W.CLIENT_CASES.items()
           for name in names]
CLIENT_IDS = [f"{'x'.join(map(str, s))}-{n}" for s, n in CLIENTS]


@pytest.mark.slow
@pytest.mark.parametrize("shape,name", CLIENTS, ids=CLIENT_IDS)
def test_client_matches_single_device_and_reference(runs, shape, name):
    """The client's f32 loss and each rank's block of every leaf's
    gradient against the port's single device and the reference's
    ``loss_fn`` at no mesh, within ``LOSS_RTOL`` and ``GRAD_RTOL`` of the
    leaf's largest magnitude; the rank's decisions are ``split_blocks``';
    every flash call runs on the rank's q heads (all of them where the
    heads stay whole), with one kv head a q head where they straddle kv
    groups."""
    ranks = [r[name] for r in runs[shape]]
    sizes = _sizes(shape)
    cfg = W.config(name)
    M = sizes["model"]
    specs = fl_step.param_specs(cfg, sizes)
    for want_loss, want in (runs["single"][name], runs["ref"][name]):
        np.testing.assert_allclose(ranks[0]["loss"], want_loss,
                                   rtol=LOSS_RTOL)
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
    H, Kv = tpar.head_counts(cfg)
    axis = tpar.ModelAxis(None, M, 0, cfg)
    local = H // M if axis.blocks["heads"] else H
    if axis.blocks["kv_heads"]:
        kv = Kv // M
    elif not axis.blocks["heads"]:
        kv = Kv
    else:
        kv = local if axis.straddle else 1
    for out in ranks:
        assert out["blocks"] == tpar.split_blocks(cfg, M)
        assert out["straddle"] == axis.straddle
        assert bool(out["flash"]) == (cfg.family != "rwkv")
        assert all(call == (local, kv) for call in out["flash"]), (
            out["flash"], local, kv)


@pytest.mark.slow
@pytest.mark.parametrize("shape,name", CLIENTS, ids=CLIENT_IDS)
def test_whole_leaves_have_their_whole_gradient_on_every_rank(
        runs, shape, name):
    """Every leaf that the model axis leaves whole (no dim on ``model``:
    the whole vocab's tables, a whole MLP, the whole MoE layer, kv weights
    read by straddling q heads, the norms) has the same gradient on every
    model rank, bit for bit: each rank runs the whole block on the same
    whole activations, or sums its ranks' parts (``copy_to_model``)."""
    sizes = _sizes(shape)
    cfg = W.config(name)
    specs = T.leaves(fl_step.param_specs(cfg, sizes))
    ranks = [T.leaves_with_path(r[name]["grads"]) for r in runs[shape]]
    n_whole = 0
    for j, spec in enumerate(specs):
        if "model" in spec:
            continue
        n_whole += 1
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[j][1], ranks[0][j][1],
                                          err_msg="/".join(ranks[0][j][0]))
    assert n_whole > 0


SERVES = [(shape, i) for shape, cases in W.SERVE_CASES.items()
          for i in range(len(cases))]


@pytest.mark.slow
@pytest.mark.parametrize("shape,i", SERVES, ids=[
    f"{'x'.join(map(str, s))}-{W.SERVE_CASES[s][i][0]}-"
    f"{W.SERVE_CASES[s][i][2]}" for s, i in SERVES])
def test_serving_matches_single_device(runs, shape, i):
    """Each rank of the case holds the cache layout stated; its prefill
    and teacher-forced decode logits are within ``REL`` relative of the
    single device's (the padded vocab columns included) and every
    request's greedy tokens equal the single device's."""
    name, lens, kind = W.SERVE_CASES[shape][i]
    single = runs[("serve", shape, i)]
    for r, rank in enumerate(runs[shape]):
        got = rank["serve"][i]
        assert got["layout"].kind == kind, (r, got["layout"])
        for step, (a, s) in enumerate(zip(got["logits"], single["logits"])):
            assert a.shape == s.shape, step
            assert _rel(a, s) <= REL, (r, step, _rel(a, s))
        assert got["tokens"] == single["tokens"], r


ROUNDS = [((2, 2), c) for c in W.GRID_CASES] + \
    [((2, 1, 2), c) for c in W.SHARED_CASES]


@pytest.mark.slow
@pytest.mark.parametrize("shape,case", ROUNDS,
                         ids=[f"{'x'.join(map(str, s))}-{'-'.join(c)}"
                              for s, c in ROUNDS])
def test_rounds_with_whole_mlp_match_single_device(runs, shape, case):
    """Two f32 rounds, K = 2, d_ff 129 (the MLP whole on the model axis of
    2) against the single-device K = 2 rounds aggregated per block as the
    ranks aggregate them (under ``compressed`` a whole leaf's block is the
    whole leaf): losses within 1e-5 relative; parameters within
    ``ROUND_RTOL`` relative or 2 x lr, optimizer state within
    ``ROUND_RTOL`` relative or of its leaf's largest magnitude; at most
    ``MAX_SHARE`` of either beyond ``SHARE_RTOL``."""
    name, opt, kind = case
    mode = "shared" if len(shape) == 3 else "replica"
    cfg = W.round_cfg(name, opt, mode)
    sizes = _sizes(shape)
    assert not tpar.split_blocks(cfg, sizes["model"])["mlp"]
    want_losses, want = S.f32_rounds(cfg, kind, 2, blocks=sizes)
    specs = fl_step.state_specs(cfg, sizes, opt)
    specs = {"params": specs["params"], "opt": specs["opt"]}
    cases = W.GRID_CASES if mode == "replica" else W.SHARED_CASES
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
    for part, (n, bad, beyond) in total.items():
        assert bad == 0, (part, bad)
        assert beyond <= MAX_SHARE * n, (part, beyond, n)


@pytest.mark.slow
def test_resume_with_whole_leaves_under_adafactor_is_bit_for_bit(runs):
    """A (2, 2) trainer with d_ff 129 (its MLP whole on every model rank)
    under Adafactor, interrupted after round 0 and resumed from its block
    checkpoint, against an uninterrupted run: the same losses, parameters,
    factors and step, bit for bit; the single-device K = 2 trainer
    restores the last checkpoint, its state's blocks the ranks'."""
    cfg = W.resume_cfg()
    one = SDFLMQTrainer(cfg, 2, S.ROUNDS, R.BPC, R.SEQ, seed=0,
                        device="cpu", ckpt_dir=str(runs["ckpt"]))
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
