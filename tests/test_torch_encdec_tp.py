"""The encoder-decoder (whisper-small) and the VLM (internvl2-2b) on the
rank path: tensor parallelism over the mesh's ``model`` axis, the
``shared`` mode (FSDP over ``data``), training and serving, on gloo ranks
spawned on the CPU, against the JAX package and the port on one device.
The smoke configs have 4 q and 2 kv heads: split at M = 2, the kv heads
whole at M = 4 (the mixed layout, the cross-attention's too); whisper's
client cases take 96 frames, so the encoder, the decoder's self-attention
and its cross-attention all run the flash path.

* (a) ``param_specs`` and ``opt_state_specs`` of both, full and smoke, in
  both modes, equal the reference's on (1, 2), (1, 4), (2, 2), (2, 2, 1)
  and (1, 2, 2) (pure logic); on each of those meshes a round step and a
  ``ServeEngine`` build; a whole ``mlp`` (whisper's ``d_ff``, the VLM's
  ``feat_dim``) still raises;
* (b) a (1, M) client's f32 loss and gradients at M = 2 and 4, and a
  (1, 2, 2) client's in shared mode (batch 2 split over data), every bias
  and norm drawn from a seed (not the decls' zeros and ones), against
  the reference's ``loss_fn`` under ``jax.grad`` at no mesh and against
  the port's single device; every flash call on the rank's heads;
* (c) the replicated leaves (``enc_in``, every LayerNorm, ``b_out``,
  ``vis_proj``'s norm) get their whole gradient, equal on every model
  rank;
* (d) f32 rounds on (2, 2) and (2, 2, 1) against the port's single-device
  rounds aggregated per block;
* (e) serving on (1, 2), (2, 2) and (1, 4): prefill and teacher-forced
  decode logits against the single-device engine, whisper's self and
  cross caches each in the layout its spec gives (``seq``, ``heads``,
  ``whole``); a (1, 1) mesh bit for bit.

The multi-process tests carry the ``slow`` marker; the spawns run in a
thread while this process computes the reference's gradients and the
single device's rounds and logits."""
import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_encdec_tp_ranks as E
import test_torch_shared_ranks as S
import test_torch_tp_ranks as R
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core import fl_step as ref_fl_step
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_api
from repro_torch.serve.engine import ServeEngine
from test_torch_common import (as_jax, assert_model_axis_runs, bf16_normal,
                               np_f32, ref_params)
from test_torch_linear_tp import _as_tuples, _ref_mesh, _sizes
from test_torch_tp import SPAWN_S

# (b) the f32 client against the port's single device and the reference's
# loss_fn at no mesh: the loss within 1e-5 relative, a gradient element
# within 5e-5 of its leaf's largest magnitude (tests/test_torch_linear_tp.py's
# rule: the row-parallel f32 sums round the activations differently from
# one GEMM); a replicated leaf that lost a rank's part is off by tens of
# per cent
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-5
# but the VLM's patch norm: the normed patches are rounded to the patches'
# bf16 (as in the reference), so the backward rounds their gradient to
# bf16 too, and one GEMM and the ranks' row-parallel product can round an
# element of it to neighbouring bf16 values: that element's term of the
# norm's gradient then moves by up to one bf16 ulp (2^-8) of itself
BF16_INPUT_RTOL = {"vis_proj/norm/scale": 2.0 ** -8}
# (d) the rounds: tests/test_torch_linear_tp.py's rules
ROUND_RTOL = {"shared": 1e-5, "replica": 3e-5}
SHARE_RTOL = {"shared": 1e-5, "replica": 1e-4}
MAX_SHARE = 0.01
# (e) the logits against the single device, relative to their largest
# magnitude (tests/test_torch_serve_tp.py's)
SERVE_REL = 1e-5
MESHES = [(1, 2), (1, 4), (2, 2), (2, 2, 1), (1, 2, 2)]
ARCHS = ("whisper-small", "internvl2-2b")


def _ref_cfg(name, mode="replica", frames=None):
    cfg = ref_smoke_config(ref_get_arch(E.ARCHS[name]))
    if frames is not None:
        cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend,
                                                       n_tokens=frames))
    return cfg.replace(fl=cfg.fl.__class__(mode=mode))


def _fake_mesh(shape, rank=0):
    """A mesh object as far as building a step or an engine reads one: no
    process group (every group is the default one)."""
    sizes = _sizes(shape)
    coords = shd.mesh_coords(sizes, rank)
    return types.SimpleNamespace(
        shape=sizes, rank=rank, world=int(np.prod(shape)),
        device=torch.device("cpu"), group=lambda ax: None,
        coord=lambda ax: coords[ax], axis_names=tuple(sizes))


# ---------------------------------------------------------------------------
# (a) specs, what builds and what still raises, pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES,
                         ids=["x".join(map(str, s)) for s in MESHES])
@pytest.mark.parametrize("mode", ["replica", "shared"])
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_encdec_vlm_specs_match_reference(arch, size, mode, shape):
    """``param_specs`` and ``opt_state_specs`` under AdamW and Adafactor
    equal the reference's, spec for spec (whisper's cross-attention,
    ``enc_in`` and biases, the VLM's patch projection among them), and so
    do the client axis and count."""
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    if size == "smoke":
        ref_cfg, cfg = ref_smoke_config(ref_cfg), smoke_config(cfg)
    ref_cfg = ref_cfg.replace(fl=ref_cfg.fl.__class__(mode=mode))
    cfg = cfg.replace(fl=cfg.fl.__class__(mode=mode))
    sizes, mesh = _sizes(shape), _ref_mesh(shape)
    got = fl_step.param_specs(cfg, sizes)
    assert got == _as_tuples(ref_fl_step.param_specs(ref_cfg, mesh))
    for opt in ("adamw", "adafactor"):
        assert fl_step.opt_state_specs(cfg, sizes, opt) == _as_tuples(
            ref_fl_step.opt_state_specs(ref_cfg, mesh, opt)), opt
    assert fl_step.client_axis_for(cfg, sizes) == \
        ref_fl_step.client_axis_for(ref_cfg, mesh)
    assert fl_step.n_clients_for(cfg, sizes) == \
        ref_fl_step.n_clients_for(ref_cfg, mesh)


@pytest.mark.parametrize("shape", MESHES,
                         ids=["x".join(map(str, s)) for s in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_round_step_and_engine_build_on_ranks(arch, shape):
    """Both families, in their declared replica mode and in shared mode
    where the mesh has pods: every rank's ``init_state`` is its block of
    the abstract state, a round step builds, and a ``ServeEngine`` builds
    with the mesh's model axis (and data axis, where it has one)."""
    cfg = smoke_config(get_arch(arch))
    if len(shape) == 3:
        cfg = cfg.replace(fl=cfg.fl.__class__(mode="shared"))
    sizes = _sizes(shape)
    for r in range(int(np.prod(shape))):
        mesh = _fake_mesh(shape, r)
        got = fl_step.init_state(cfg, mesh, 0)["params"]
        want = fl_step.abstract_state(cfg, mesh)["params"]
        assert [t.shape for t in T.leaves(got)] == [
            t.shape for t in T.leaves(want)]
    assert callable(fl_step.build_fl_round_step(
        cfg, _fake_mesh(shape), R.schedule("flat", max(
            fl_step.n_clients_for(cfg, sizes), 1))))
    engine = ServeEngine(cfg, {}, mesh=_fake_mesh(shape))
    assert (engine.tp.size if engine.tp else 1) == sizes["model"]
    assert (engine.data is None) == (sizes["data"] == 1)


@pytest.mark.parametrize("arch,kw,size", [
    ("whisper-small", {"d_ff": 100}, 8),
    ("internvl2-2b", {"feat_dim": 66}, 4)])
def test_whole_mlp_still_raises(arch, kw, size):
    """Whisper's GELU MLP width, and the VLM's patch projection input
    (``feat_dim`` on ``mlp``), may stay whole as the heads may: where one
    does not divide the model axis it stays whole (``split_blocks``), the
    specs resolve as the reference's ``specs_for`` does and the round step
    builds (tests/test_torch_whole_tp.py runs such clients)."""
    cfg = smoke_config(get_arch(arch))
    if "feat_dim" in kw:
        cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, **kw))
    else:
        cfg = cfg.replace(**kw)
    blocks = tpar.split_blocks(cfg, size)
    assert not blocks["vis" if "feat_dim" in kw else "mlp"]
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


def _grad_batch(name, seed=1):
    """Two rows of GRAD_SEQ tokens and their frames or patches, exact in
    bf16."""
    cfg = E.client_cfg(name)
    fe = cfg.frontend
    b = R.grad_batch(cfg.vocab, seed)
    b[E.frontend_name(cfg)] = bf16_normal((2, fe.n_tokens, fe.feat_dim),
                                          seed + 10)
    return b


def _with_norms_and_biases(params_np, seed=5):
    """The reference's parameters with every bias and norm drawn from a
    numpy seed (biases N(0, 0.1), scales 1 + N(0, 0.1)) in place of their
    zeros and ones: a bias added on each rank before a row-parallel sum,
    or a norm whose output misses a rank's part of its gradient, then
    moves the loss and the gradients."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1] in ("b_in", "b_out", "bias"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if path[-1] == "scale":
            return (1.0 + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        return a
    return T.unflatten_like(params_np, [draw(path, a) for path, a in
                                        T.leaves_with_path(params_np)])


def _ref_loss_and_grads(ref_cfg, params_np, batch_np):
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    batch = as_jax(batch_np)
    fn = lambda p: ref_model_api.loss_fn(ref_cfg, p, batch)[0]
    loss, grads = jax.jit(jax.value_and_grad(fn))(params)
    return float(loss), np_f32(grads)


def _single_loss_and_grads(cfg, params_np, batch_np):
    params = T.tree_map(lambda a: torch.from_numpy(np.array(a))
                        .requires_grad_(), params_np)
    loss, _ = model_api.loss_fn(cfg, params, E.as_batch(batch_np))
    grads = torch.autograd.grad(loss, T.leaves(params))
    return loss.item(), T.unflatten_like(params, [g.numpy() for g in grads])


@pytest.fixture(scope="module")
def runs():
    """Every spawn of the module, in a thread, while this process computes
    the reference's and the single device's loss and gradients, the single
    device's rounds and its engines' logits."""
    names = tuple(E.ARCHS)
    params = {n: _with_norms_and_biases(np_f32(ref_params(_ref_cfg(
        n, frames=E.FRAMES if n == "whisper" else None)))) for n in names}
    batch = {n: _grad_batch(n) for n in names}
    out, errors = {}, []

    def spawns():
        try:
            for shape, cases in E.CLIENT_CASES.items():
                out[shape] = _spawn(E.client_and_serve_rank, shape, (
                    [c + (params[c[0]], batch[c[0]]) for c in cases],
                    params))
            out[(2, 2)] = _spawn(E.grid_and_serve_rank, (2, 2), (
                E.ROUND_CASES, "replica", params))
            out[(2, 2, 1)] = _spawn(E.grid_rank, (2, 2, 1), (
                E.SHARED_ROUND_CASES, "shared"))
            out["world1"] = _spawn(E.world1_rank, (1, 1), (list(names),))[0]
        except Exception as e:          # raised again below
            errors.append(e)
    th = threading.Thread(target=spawns)
    th.start()
    try:
        out["ref"] = {n: _ref_loss_and_grads(
            _ref_cfg(n, frames=E.FRAMES if n == "whisper" else None),
            params[n], batch[n]) for n in names}
        out["single"] = {n: _single_loss_and_grads(
            E.client_cfg(n), params[n], batch[n]) for n in names}
        for shape, cases in (((2, 2), E.ROUND_CASES),
                             ((2, 2, 1), E.SHARED_ROUND_CASES)):
            mode = "shared" if len(shape) == 3 else "replica"
            for case in cases:
                out[("rounds", shape, case)] = E.frontend_rounds(
                    E.round_cfg(case[0], case[1], mode), case[2], 2,
                    blocks=_sizes(shape))
        for shape, cases in E.SERVE_CASES.items():
            for i, (name, lens, frames, _, _) in enumerate(cases):
                out[("serve", shape, i)] = E.serve(
                    E.config(name, frames=frames), S.whole(params[name]), lens,
                    i)
    finally:
        th.join()
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# (b) one client against the reference and the single device
# ---------------------------------------------------------------------------

CLIENTS = [(shape, name) for shape, cases in E.CLIENT_CASES.items()
           for name, _, _ in cases]


def _mode(shape, name):
    return next(m for n, m, _ in E.CLIENT_CASES[shape] if n == name)


@pytest.mark.slow
@pytest.mark.parametrize("shape,name", CLIENTS,
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s, n in CLIENTS])
def test_client_matches_reference_loss_fn(runs, shape, name):
    """The client's f32 loss (the mean of its data ranks' losses in shared
    mode) and each rank's block of every leaf's gradient, against the
    port's single device and the reference's ``loss_fn`` at no mesh,
    within ``LOSS_RTOL`` and ``GRAD_RTOL`` of the leaf's largest
    magnitude; every flash call (whisper: encoder, self and cross; the
    VLM's causal GQA) on the rank's q heads and the kv heads they read."""
    ranks = [r[name] for r in runs[shape]]
    sizes = _sizes(shape)
    loss = np.mean([r["loss"] for r in ranks[::sizes["model"]]])
    cfg = E.client_cfg(name, _mode(shape, name))
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
                tol = BF16_INPUT_RTOL.get("/".join(path), GRAD_RTOL) \
                    * np.abs(w).max()
                assert np.abs(g - w).max() <= tol, (
                    "/".join(path), r, np.abs(g - w).max(), tol)
    M = sizes["model"]
    local = cfg.n_heads // M
    kv = cfg.n_kv_heads // M if cfg.n_kv_heads % M == 0 else 1
    n = cfg.n_layers * (2 if cfg.family == "encdec" else 1) + \
        cfg.n_enc_layers
    for out in ranks:
        assert out["flash"] == [(local, kv)] * n, out["flash"]


# ---------------------------------------------------------------------------
# (c) replicated leaves count once
# ---------------------------------------------------------------------------

REPLICATED = {
    "whisper": ["enc_in/w", "enc_norm/scale", "enc_norm/bias",
                "final_norm/scale", "final_norm/bias",
                "enc_layers/mlp/b_out", "dec_layers/mlp/b_out"]
    + [f"{stack}/{ln}/{p}" for stack, lns in (
        ("enc_layers", ("ln1", "ln2")), ("dec_layers", ("ln1", "ln2", "ln_x")))
       for ln in lns for p in ("scale", "bias")],
    "vlm": ["vis_proj/norm/scale", "final_norm/scale", "layers/ln1/scale",
            "layers/ln2/scale"]}


@pytest.mark.slow
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", ["whisper", "vlm"])
def test_replicated_leaves_count_once(runs, name, M):
    """With the heads (and the MLP, the vocab, the VLM's ``feat_dim``)
    split over M ranks, each replicated leaf in ``REPLICATED`` has the
    same gradient on every model rank, bit for bit, within ``GRAD_RTOL``
    of the leaf's largest magnitude of the port's single device at f32.
    ``b_out`` added before the row-parallel sum would count M times; a
    norm whose output skipped ``copy_to_model`` would carry only its
    rank's part."""
    named = lambda t: dict(zip(fl_step.leaf_path_names(t), T.leaves(t)))
    ranks = [named(r[name]["grads"]) for r in runs[(1, M)]]
    want = named(runs["single"][name][1])
    for leaf in REPLICATED[name]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[leaf], ranks[0][leaf],
                                          err_msg=leaf)
        tol = BF16_INPUT_RTOL.get(leaf, GRAD_RTOL) * np.abs(want[leaf]).max()
        assert tol > 0 and np.abs(ranks[0][leaf] - want[leaf]).max() <= tol, \
            leaf


# ---------------------------------------------------------------------------
# (d) rounds against the single device
# ---------------------------------------------------------------------------

ROUNDS = [((2, 2), c) for c in E.ROUND_CASES] + \
    [((2, 2, 1), c) for c in E.SHARED_ROUND_CASES]


@pytest.mark.slow
@pytest.mark.parametrize("shape,case", ROUNDS,
                         ids=[f"{'x'.join(map(str, s))}-{'-'.join(c)}"
                              for s, c in ROUNDS])
def test_grid_rounds_match_single_device(runs, shape, case):
    """Two f32 rounds, K = 2, batch 2 with frames or patches (split over
    the data ranks in shared mode), against the single-device K = 2 rounds
    aggregated per block as the ranks aggregate them: losses within 1e-5
    relative; parameters within ``ROUND_RTOL`` relative or 2 x lr,
    optimizer state within ``ROUND_RTOL`` relative or of its leaf's
    largest magnitude (the patch norm's moments within twice its gradient's
    ``BF16_INPUT_RTOL``); at most ``MAX_SHARE`` of either beyond
    ``SHARE_RTOL`` relative."""
    name, opt, kind = case
    mode = "shared" if len(shape) == 3 else "replica"
    cfg = E.round_cfg(name, opt, mode)
    sizes = _sizes(shape)
    want_losses, want = runs[("rounds", shape, case)]
    specs = fl_step.state_specs(cfg, sizes, opt)
    specs = {"params": specs["params"], "opt": specs["opt"]}
    cases = E.ROUND_CASES if mode == "replica" else E.SHARED_ROUND_CASES
    i = cases.index(case)
    rtol, share = ROUND_RTOL[mode], SHARE_RTOL[mode]
    total = {"params": [0, 0, 0], "opt": [0, 0, 0]}
    where = set()
    for r, out in enumerate(runs[shape]):
        losses, got = out["rounds"][i]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        blocks = R.numpy_tree(R.blocks_of(S.whole(want), specs, sizes, r))
        for part, n in total.items():
            for (path, a), b in zip(T.leaves_with_path(got[part]),
                                    T.leaves(blocks[part])):
                name = "/".join(path)
                # a moment of the patch norm: its gradient's bf16 rule,
                # twice for the second moment's square
                el = max(rtol, 2 * max((t for k, t in BF16_INPUT_RTOL.items()
                                        if name.endswith(k)), default=0.0))
                floor = 2 * S.LR if part == "params" else \
                    el * float(np.abs(b).max(initial=0.0))
                err = np.abs(a - b)
                n[0] += b.size
                bad = int((err > el * np.abs(b) + floor).sum())
                n[1] += bad
                n[2] += int((err > share * np.abs(b)).sum())
                if bad:
                    where.add(name)
    print(f"{shape} {name}/{opt}/{kind}: " + "; ".join(
        f"{part} {n[2]} of {n[0]} beyond {share} relative"
        for part, n in total.items()))
    for part, (n, bad, beyond) in total.items():
        assert bad == 0, (part, bad, sorted(where))
        assert beyond <= MAX_SHARE * n, (part, beyond, n)


# ---------------------------------------------------------------------------
# (e) serving against the single device
# ---------------------------------------------------------------------------

SERVES = [(shape, i) for shape, cases in E.SERVE_CASES.items()
          for i in range(len(cases))]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.slow
@pytest.mark.parametrize("shape,i", SERVES, ids=[
    f"{'x'.join(map(str, s))}-{E.SERVE_CASES[s][i][0]}-"
    f"{E.SERVE_CASES[s][i][2]}-{max(E.SERVE_CASES[s][i][1])}"
    for s, i in SERVES])
def test_rank_engine_matches_single_device(runs, shape, i):
    """Every rank of the case: the self cache's and the cross cache's
    layouts each as its keys' spec gives it; its rows' prefill logits and
    teacher-forced decode logits within ``SERVE_REL`` of the single
    device's (with frames or patches from the seed); the greedy tokens of
    every request equal to the single device's; each cache leaf the block
    of the whole one its spec gives (a ``seq`` cross cache holds
    n_frames / M frames)."""
    name, lens, frames, kind, cross = E.SERVE_CASES[shape][i]
    single = runs[("serve", shape, i)]
    for r, rank in enumerate(runs[shape]):
        got = rank["serve"][i]
        assert got["layout"].kind == kind, (r, got["layout"])
        got_cross = got["cross_layout"]
        assert (got_cross.kind if got_cross else None) == cross, r
        lo, hi = got["rows"]
        for step, (a, s) in enumerate(zip(got["logits"], single["logits"])):
            assert a.shape == (hi - lo, s.shape[1]), step
            assert _rel(a, s[lo:hi]) <= SERVE_REL, (r, step,
                                                    _rel(a, s[lo:hi]))
        assert got["tokens"] == single["tokens"], r
        mesh = _fake_mesh(shape, r)
        for key, spec in got["specs"].items():
            want = shd.local_block(torch.empty(got["decl_shapes"][key],
                                               device="meta"), spec,
                                   mesh.shape, r)
            assert got["shapes"][key] == tuple(want.shape), key
        if cross == "seq":
            assert got["shapes"]["cross_k"][2] * shape[1] == frames


@pytest.mark.slow
def test_world1_mesh_is_bit_for_bit(runs):
    """On a (1, 1) mesh whisper's and the VLM's parameters from a seed
    and their engines' logits and tokens (frames or patches from the
    seed) equal the single device's bit for bit."""
    assert len(runs["world1"]) == 2
    for case in runs["world1"]:
        assert case["params_equal"] and case["logits_equal"]
        assert case["tokens"][0] == case["tokens"][1]
