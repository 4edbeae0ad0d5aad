"""Serving on the ``model`` and ``data`` axes: ``ServeEngine`` on gloo
ranks spawned on the CPU, against the port on one device and the JAX
package's ``prefill`` and ``decode_step``, on the smoke configs in f32
(the reference's parameters cast to f32 before every call).

* The parameters from a seed: a stacked leaf is drawn one layer at a time
  (a spy sees no draw larger than one layer's slice), and a rank's blocks
  equal the whole tree's, on every mesh (pure logic);
* the cache's specs (``kvcache.cache_specs``) of every family's
  ``cache_decl``, full and smoke configs, on (1, 2), (1, 4) and (2, 2), at
  lengths that do and do not divide the model axis, equal the reference's
  ``specs_for`` under its serving rules, but for Hymba's ``conv`` where its
  heads stay whole (the port keeps it whole); the layout each gives;
* f32 engines on (1, 2), (1, 4) and (2, 2) in each cache layout (``seq``,
  ``heads``, ``whole``), for the dense family (qwen2-7b), the MoE family
  (mixtral-8x22b in its declared ``shared`` mode on (2, 2), experts split),
  RWKV6 (heads split) and Hymba (heads split, and whole with 5 q and 5 kv
  heads): prefill's logits and three teacher-forced decode steps' within
  1e-5 relative of the single device's and the reference's, the greedy
  tokens equal to the single device's, the cache a rank holds the block of
  the whole one its spec gives (a ``seq`` cache 1/M of the single
  device's slots); a batch whose rank blocks hold no valid slot; R3 and
  R4 reproduced;
* a (1, 1) mesh's parameters and engine equal the plain ones bit for bit;
* the CLI's ``--model-mesh 2 [--data-mesh 2]`` tokens equal the single
  device's.

The multi-process tests carry the ``slow`` marker; the spawns run in a
thread while this process computes the single device's and the
reference's logits."""
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

import test_torch_serve_tp_ranks as R
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_shd
from repro.models import kvcache as ref_kvc
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, list_archs, smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import kvcache as kvc
from repro_torch.models import model_api
from test_torch_common import np_f32, ref_params
from test_torch_tp import ROOT, SPAWN_S, _env

MESHES = [(1, 2), (1, 4), (2, 2)]
REL = 1e-5


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_cfg(name):
    cfg = ref_smoke_config(ref_get_arch(R.ARCHS[name]))
    return cfg.replace(**R.OVERRIDES.get(name, {}))


def _fake_mesh(shape, rank=0):
    return types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                                 rank=rank, axis_names=("data", "model"))


# ---------------------------------------------------------------------------
# the parameters from a seed, one layer at a time (pure logic)
# ---------------------------------------------------------------------------

def test_materialize_draws_one_layer_at_a_time(monkeypatch):
    """Every ``randn`` of a stacked leaf draws one layer's slice, whole
    leaves draw whole, and a rank's blocks of mixtral's smoke tree (its
    stacked expert leaves split on ``model``, ``embed`` on ``data`` in
    shared mode) reassemble into the single device's tree."""
    cfg = R.config("mixtral")
    decls = model_api.param_decls(cfg)
    want = {d.shape[1:] if d.axes[0] == "layers" else d.shape
            for d in T.leaves(decls) if d.init in ("normal", "embed")}
    seen, real = [], torch.randn

    def spy(*shape, **kw):
        seen.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real(*shape, **kw)
    monkeypatch.setattr(torch, "randn", spy)
    whole = model_api.init_params(cfg, 7, "cpu")
    assert set(seen) == want
    for shape in MESHES:
        for r in range(shape[0] * shape[1]):
            seen.clear()
            mesh = _fake_mesh(shape, r)
            part = model_api.init_params(cfg, 7, "cpu", mesh=mesh)
            assert set(seen) == want
            specs = model_api.serve_specs(cfg, mesh)
            for a, b, s in zip(T.leaves(part), T.leaves(whole),
                               T.leaves(specs)):
                assert torch.equal(a, shd.local_block(b, s, mesh)), (
                    shape, r, s)


# ---------------------------------------------------------------------------
# the cache specs and layouts against the reference (pure logic)
# ---------------------------------------------------------------------------

def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, PartitionSpec), tree
    return tuple(tree)


@pytest.mark.parametrize("shape", MESHES,
                         ids=["x".join(map(str, s)) for s in MESHES])
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, size, shape):
    """Each family's cache leaves take the reference's specs under its
    serving rules (``launch/dryrun.py``: ``specs_for(cache_decl,
    rules_for(mode), mesh)``) at lengths that do and do not divide the
    model axis and batches that do and do not divide the data axis; where
    Hymba's heads stay whole its ``conv`` stays whole too (the reference
    splits its Din dim).  The layout is ``seq`` exactly where the keys'
    ``cache_seq`` dim takes ``model``, ``heads`` where their kv heads do.
    The encoder-decoder's cross cache (``cross_k``/``cross_v``, whisper's
    1500 frames) takes its own layout from its own spec, ``seq`` wherever
    its frames divide the model axis, whatever the self cache's."""
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    if size == "smoke":
        ref_cfg, cfg = ref_smoke_config(ref_cfg), smoke_config(cfg)
    mesh = _fake_mesh(shape, rank=shape[1] - 1)
    rules = ref_shd.rules_for(ref_cfg.fl.mode)
    M = shape[1]
    for B in (4, 3):
        for C in (32, 33, 30, 4096):
            decls = model_api.get_model(cfg).cache_decl(cfg, B, C)
            got = kvc.cache_specs(cfg, decls, mesh.shape)
            want = _as_tuples(ref_shd.specs_for(
                ref_model_api.get_model(ref_cfg).cache_decl(ref_cfg, B, C),
                rules, mesh))
            if cfg.family == "hybrid" and cfg.n_heads % M:
                din = want["conv"]
                assert din[3] == ("model" if (cfg.n_heads * cfg.head_dim)
                                  % M == 0 else None)
                want["conv"] = din[:3] + (None,)
            assert got == want, (B, C)
            lay = kvc.layout_for(cfg, decls, mesh)
            if "k" not in decls:
                assert lay is None
                continue
            k = got["k"]
            kind = ("seq" if k[2] == "model" else "heads" if k[3] == "model"
                    else "whole")
            assert (lay.kind, lay.length, lay.size, lay.rank) == (
                kind, C, M, M - 1)
            assert lay.local * (M if kind == "seq" else 1) == C
            cross = kvc.layout_for(cfg, decls, mesh, "cross_")
            if "cross_k" not in decls:
                assert cross is None and cfg.family != "encdec"
                continue
            # the encoder-decoder's cross cache: its own layout from its
            # own spec, split on its frames wherever they divide M
            ck, T_ = got["cross_k"], cfg.frontend.n_tokens
            assert (ck[2] == "model") == (T_ % M == 0)
            kind = ("seq" if ck[2] == "model" else "heads" if ck[3]
                    == "model" else "whole")
            assert (cross.kind, cross.length, cross.size, cross.rank) == (
                kind, T_, M, M - 1)
            assert "cross_kv_pos" not in decls


# ---------------------------------------------------------------------------
# the spawns, and the single device's and the reference's logits
# ---------------------------------------------------------------------------

NAMES = sorted(R.ARCHS)


def _ref_logits(name, rp, lens, seed):
    """The reference's prefill and MAX_NEW teacher-forced decode steps (its
    engine's cache: padded to S + MAX_NEW + 1 slots where it has no
    window, left at its prefilled length where it has one)."""
    cfg = _ref_cfg(name)
    mod = ref_model_api.get_model(cfg)
    _, toks, forced = R.case_inputs(cfg.vocab, lens, seed)
    B, S = toks.shape
    logits, cache = jax.jit(lambda p, b: mod.prefill(cfg, p, b))(
        rp, {"tokens": jnp.asarray(toks)})
    if cfg.window is None and cfg.family != "rwkv":
        cache = ref_kvc.pad_cache(cache, min(S + R.MAX_NEW + 1, 256))
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(lambda p, c, b: mod.decode_step(cfg, p, c, b))
    for j in range(R.MAX_NEW):
        logits, cache = step(rp, cache, {
            "token": jnp.asarray(forced[:, j:j + 1]),
            "pos": jnp.full((B,), S + j, jnp.int32)})
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.fixture(scope="module")
def runs():
    """Every spawn of the module, in a thread, while this process computes
    each case on the port's single device and on the reference."""
    rp = {name: ref_params(_ref_cfg(name), seed=0) for name in NAMES}
    params = {name: np_f32(p) for name, p in rp.items()}
    out, errors = {}, []

    def spawns():
        try:
            for shape, cases in R.CASES.items():
                out[shape] = mesh_lib.spawn(
                    R.serve_rank, shape[0], (cases, params), model=shape[1],
                    device="cpu", timeout_s=SPAWN_S)
            out["world1"] = mesh_lib.spawn(
                R.world1_rank, 1, (["qwen2", "mixtral", "rwkv", "hymba"],),
                device="cpu", timeout_s=SPAWN_S)[0]
        except Exception as e:          # raised again below
            errors.append(e)
    th = threading.Thread(target=spawns)
    th.start()
    try:
        for shape, cases in R.CASES.items():
            for i, (name, lens, _) in enumerate(cases):
                out[("single", shape, i)] = R.serve(
                    R.config(name), R.whole_params(params[name]), lens, i)
                out[("ref", shape, i)] = _ref_logits(name, rp[name], lens, i)
    finally:
        th.join()
    if errors:
        raise errors[0]
    return out


CASE_IDS = [(shape, i) for shape, cases in R.CASES.items()
            for i in range(len(cases))]


@pytest.mark.slow
@pytest.mark.parametrize("shape,i", CASE_IDS, ids=[
    f"{'x'.join(map(str, s))}-{R.CASES[s][i][0]}-{max(R.CASES[s][i][1])}"
    for s, i in CASE_IDS])
def test_rank_engine_matches_single_device_and_reference(runs, shape, i):
    """Every rank of the case: the layout it was meant to exercise; its
    rows' prefill logits and teacher-forced decode logits within 1e-5
    relative of the single device's and of the reference's (the padded
    vocab columns included); the greedy tokens of every request equal to
    the single device's on every rank; each cache leaf the block of the
    whole one its spec gives (a ``seq`` cache holds C / M slots)."""
    name, lens, kind = R.CASES[shape][i]
    single, ref = runs[("single", shape, i)], runs[("ref", shape, i)]
    for r, rank in enumerate(runs[shape]):
        got = rank[i]
        lay = got["layout"]
        assert (lay.kind if lay is not None else None) == kind, (r, lay)
        lo, hi = got["rows"]
        assert (hi - lo) * (shape[0] if len(lens) % shape[0] == 0 else 1) \
            == len(lens)
        for step, (a, s, w) in enumerate(zip(got["logits"],
                                             single["logits"], ref)):
            assert a.shape == (hi - lo, w.shape[1]), step
            assert _rel(a, s[lo:hi]) <= REL, (r, step, _rel(a, s[lo:hi]))
            assert _rel(a, w[lo:hi]) <= REL, (r, step, _rel(a, w[lo:hi]))
        assert got["tokens"] == single["tokens"], r
        mesh = _fake_mesh(shape, r)
        for key, spec in got["specs"].items():
            want = shd.local_block(torch.empty(got["decl_shapes"][key],
                                               device="meta"), spec, mesh)
            assert got["shapes"][key] == tuple(want.shape), key
        if kind == "seq":
            assert got["shapes"]["k"][2] * shape[1] == \
                single["shapes"]["k"][2]


@pytest.mark.slow
def test_rank_blocks_with_no_valid_slot_add_nothing(runs):
    """(1, 4) with prompts of 4 tokens and a cache of 8 slots, 2 a rank:
    ranks 2 and 3 hold no valid slot at prefill, rank 3 none until the
    third decode step, and every step still equals the single device's
    (``split_decode_attention`` gives an empty block a max of NEG_INF and a
    sum of 0)."""
    i = next(j for j, c in enumerate(R.CASES[(1, 4)]) if max(c[1]) == 4)
    single = runs[("single", (1, 4), i)]
    for rank in runs[(1, 4)]:
        got = rank[i]
        assert got["layout"].local == 2 and got["layout"].length == 8
        for a, s in zip(got["logits"], single["logits"]):
            assert _rel(a, s) <= REL


@pytest.mark.slow
@pytest.mark.parametrize("shape,name,S", [((1, 2), "hymba", 40),
                                          ((1, 2), "qwen2_window", 12)])
def test_r3_r4_reproduced_on_ranks(runs, shape, name, S):
    """The two reference faults of the serving path, reproduced on ranks
    as on one device (ROADMAP R3, R4): Hymba's prefill keeps the window's
    keys at slots 0..W-1 while decode writes position S to slot S % W
    (32 does not divide 40), and a windowed decoder's cache is left at its
    prefilled length, so the first step evicts position 0 though it is
    still in the window.  The first decode step of every rank equals the
    reference's, and the reference's differs from the step that keeps the
    window whole (the fault shows)."""
    i = next(j for j, c in enumerate(R.CASES[shape])
             if c[0] == name and max(c[1]) == S)
    lens = R.CASES[shape][i][1]
    ref = runs[("ref", shape, i)]
    cfg = R.config(name)
    rp = ref_params(_ref_cfg(name), seed=0)
    params = shd.from_reference(np_f32(rp), model_api.param_decls(cfg),
                                "cpu", dtype=torch.float32)
    _, toks, forced = R.case_inputs(cfg.vocab, lens, i)
    with torch.inference_mode():
        fwd = model_api.get_model(cfg).forward(cfg, params, {
            "tokens": torch.from_numpy(np.concatenate(
                [toks, forced[:, :1]], axis=1))})[0][:, -1].numpy()
    assert float(np.abs(ref[1] - fwd).max()) > 1e-3
    for rank in runs[shape]:
        lo, hi = rank[i]["rows"]
        assert _rel(rank[i]["logits"][1], ref[1][lo:hi]) <= REL


@pytest.mark.slow
def test_world1_mesh_is_bit_for_bit(runs):
    """On a (1, 1) mesh the parameters from a seed and the engine's logits
    and tokens equal the single device's bit for bit."""
    for case in runs["world1"]:
        assert case["params_equal"] and case["logits_equal"]
        assert case["tokens"][0] == case["tokens"][1]


@pytest.mark.slow
@pytest.mark.parametrize("arch,mesh", [
    ("qwen2-7b", ["--model-mesh", "2"]),
    ("qwen2-7b", ["--model-mesh", "2", "--data-mesh", "2"]),
    ("mixtral-8x22b", ["--model-mesh", "2", "--data-mesh", "2"])])
def test_serve_cli_mesh_matches_single_device(arch, mesh):
    """``launch.serve --device cpu`` on a mesh (gloo ranks started by the
    CLI, bf16 parameters from the seed) prints every request's tokens as
    the single device does."""
    def reqs(extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--arch", arch, "--requests", "5", "--max-new", "3",
             *extra], capture_output=True, text=True, timeout=SPAWN_S,
            cwd=ROOT, env=_env())
        assert out.returncode == 0, out.stderr[-3000:]
        return [ln for ln in out.stdout.splitlines() if ln.startswith("req ")]
    want = reqs([])
    assert len(want) == 5
    assert reqs(mesh) == want
