"""The port's checkpoints (``repro_torch/ckpt``) and resume, against the JAX
package's format: round trips, checkpoints crossing between the packages
in both directions (a client-stacked Adafactor state too), keep-N
rotation, the trainer's resume, and the single-device federated-LM
example."""
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RCK
from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_shd
from repro.models import model_api as ref_model_api
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.ckpt import checkpoint as CK
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import init_state
from repro_torch.ft.failures import FailurePlan
from repro_torch.launch.train import SDFLMQTrainer

ROOT = Path(__file__).resolve().parents[1]


def _state(seed=0, K=3):
    """A train state of the port's form: bf16 params, f32 moments, an int
    step."""
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn((K, 10, 6), generator=g).bfloat16(),
              "layers": {"wq": torch.randn((K, 2, 6, 6), generator=g)
                         .bfloat16(),
                         "norm": torch.randn((K, 6), generator=g)},
              "scalar": torch.randn((K,), generator=g)}
    z = lambda t: torch.randn(t.shape, generator=g)
    return {"params": params,
            "opt": {"m": T.tree_map(z, params), "v": T.tree_map(z, params)},
            "step": 7 + seed}


def _zeros_like(state):
    out = T.tree_map(lambda t: torch.zeros_like(t) if torch.is_tensor(t)
                     else 0, state)
    return out


def _assert_equal_states(a, b):
    for (pa, x), (pb, y) in zip(T.leaves_with_path(a), T.leaves_with_path(b)):
        assert pa == pb
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), pa
        else:
            assert x == y, pa


@pytest.mark.parametrize("shard_bytes", [CK.SHARD_BYTES, 200])
def test_round_trip_is_bit_exact(tmp_path, monkeypatch, shard_bytes):
    monkeypatch.setattr(CK, "SHARD_BYTES", shard_bytes)
    state = _state()
    path = CK.save_checkpoint(str(tmp_path / "step_7"), state, {"loss": 1.5})
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert (len(manifest["shards"]) == 1) == (shard_bytes > 1000)
    assert [s["dtype"] for s in manifest["leaves"]][-2:] == ["float32", "int32"]
    live = _zeros_like(state)
    ptrs = [t.data_ptr() for t in T.leaves(live) if torch.is_tensor(t)]
    assert CK.restore_checkpoint(path, live) == {"loss": 1.5}
    _assert_equal_states(live, state)
    # in place: the live tensors keep their storage
    assert ptrs == [t.data_ptr() for t in T.leaves(live) if torch.is_tensor(t)]


def test_threaded_shards_equal_single_threaded(tmp_path, monkeypatch):
    """Shards compressed by several threads, and written as they finish,
    hold the bytes one thread writes, and read back with a read-ahead
    window smaller than the shard count."""
    monkeypatch.setattr(CK, "SHARD_BYTES", 200)
    blobs = {}
    for workers in (1, 3):
        monkeypatch.setattr(CK, "WORKERS", workers)
        path = Path(CK.save_checkpoint(str(tmp_path / f"w{workers}"),
                                       _state()))
        blobs[workers] = {f.name: f.read_bytes() for f in path.iterdir()}
    assert len(blobs[1]) > 3 + 2          # shards, manifest, COMMITTED
    assert blobs[3] == blobs[1]
    live = _zeros_like(_state())
    CK.restore_checkpoint(str(tmp_path / "w3"), live)
    _assert_equal_states(live, _state())


def test_restore_checks_shapes_and_dtypes_before_copying(tmp_path):
    path = CK.save_checkpoint(str(tmp_path / "s"), _state())
    live = _zeros_like(_state())
    live["params"]["layers"]["norm"] = torch.zeros((3, 7))
    with pytest.raises(ValueError, match="layers/norm"):
        CK.restore_checkpoint(path, live)
    assert all(not t.any() for t in T.leaves(live) if torch.is_tensor(t))
    live = _zeros_like(_state())
    live["params"]["embed"] = live["params"]["embed"].float()
    with pytest.raises(ValueError, match="params/embed"):
        CK.restore_checkpoint(path, live)


def _split(monkeypatch, leaf_max=700, shard_bytes=200):
    """Lowers the part limit (and the shard size) so that ``_state()``'s
    720- and 864-byte moments are written as parts."""
    monkeypatch.setattr(CK, "SHARD_BYTES", shard_bytes)
    monkeypatch.setattr(CK, "LEAF_BYTES_MAX", leaf_max)


def _shards_by_leaves(path):
    """{leaf indices of a shard holding no part: its bytes}."""
    manifest = json.loads(Path(path, "manifest.json").read_text())
    split = {p["shard"] for s in manifest["leaves"] for p in s.get("parts", [])}
    out = {}
    for k, fn in enumerate(manifest["shards"]):
        if k not in split:
            leaves = frozenset(s["i"] for s in manifest["leaves"]
                               if s["shard"] == k)
            out[leaves] = Path(path, fn).read_bytes()
    return out


@pytest.mark.parametrize("workers", [1, 3])
def test_split_leaves_round_trip_bit_for_bit(tmp_path, monkeypatch, workers):
    """Leaves over the part limit are written as parts of one shard's size,
    each closing its shard, listed in their manifest entry; the state reads
    back bit for bit, and every shard of unsplit leaves holds the bytes of
    a checkpoint written with the limit left alone."""
    monkeypatch.setattr(CK, "SHARD_BYTES", 200)
    monkeypatch.setattr(CK, "WORKERS", workers)
    whole = CK.save_checkpoint(str(tmp_path / "whole"), _state())
    _split(monkeypatch)
    path = CK.save_checkpoint(str(tmp_path / "split"), _state(), {"a": 1})
    manifest = json.loads(Path(path, "manifest.json").read_text())
    names = ["/".join(p) for p, _ in T.leaves_with_path(_state())]
    parts = {names[s["i"]]: s["parts"] for s in manifest["leaves"]
             if "parts" in s}
    assert sorted(parts) == ["opt/m/embed", "opt/m/layers/wq",
                             "opt/v/embed", "opt/v/layers/wq"]
    # 50 f32 elements (200 bytes) a part, each in a shard of its own
    assert [(q["start"], q["stop"]) for q in parts["opt/m/embed"]] == [
        (0, 50), (50, 100), (100, 150), (150, 180)]
    shards = [q["shard"] for qs in parts.values() for q in qs]
    assert len(set(shards)) == len(shards)
    live = _zeros_like(_state())
    ptrs = [t.data_ptr() for t in T.leaves(live) if torch.is_tensor(t)]
    assert CK.restore_checkpoint(path, live) == {"a": 1}
    _assert_equal_states(live, _state())
    assert ptrs == [t.data_ptr() for t in T.leaves(live) if torch.is_tensor(t)]
    leaves, _ = CK.load_checkpoint(path)
    for got, want in zip(leaves, T.leaves(_state())):
        assert torch.equal(got, want) if torch.is_tensor(want) \
            else int(got) == want
    got, want = _shards_by_leaves(path), _shards_by_leaves(whole)
    assert len(got) == 3
    for leaves, blob in got.items():
        assert want[leaves] == blob, sorted(leaves)


def test_trainer_with_split_leaves_resumes_bit_for_bit(tmp_path,
                                                      monkeypatch):
    """The trainer saves leaves over the part limit as parts (it raised
    before round 0 while the format held a leaf whole), and a fresh trainer
    restoring them runs on bit for bit."""
    monkeypatch.setattr(CK, "LEAF_BYTES_MAX", 1 << 14)
    cfg = smoke_config(get_arch("qwen2-7b"))
    make = lambda ckpt=None: SDFLMQTrainer(cfg, 4, 2, 2, 32, ckpt_dir=ckpt,
                                           device="cpu")
    whole = make()
    whole.run()
    first = make(str(tmp_path))
    first.on_round_end = _stop
    with pytest.raises(_Stop):
        first.run()
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    split = [s for s in manifest["leaves"] if "parts" in s]
    assert len(split) >= 3 and all(len(s["parts"]) > 1 for s in split)
    second = make(str(tmp_path))
    assert second.start_round == 1
    ms = second.run()
    assert ms[0]["loss"] == whole.metrics[1]["loss"]
    _assert_equal_states(second.state, whole.state)


def test_reference_loader_raises_on_a_split_checkpoint(tmp_path,
                                                      monkeypatch):
    """A split leaf is one the reference could never write: its reader keeps
    the last part it reads and fails on the reshape, with or without
    ``like``, instead of loading a wrong state."""
    _split(monkeypatch)
    path = CK.save_checkpoint(str(tmp_path / "split"), _state())
    with pytest.raises(ValueError, match="cannot reshape"):
        RCK.load_checkpoint(path)
    with pytest.raises(ValueError, match="cannot reshape"):
        RCK.load_checkpoint(path, like=_ref_state(_state()))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_zlib_checkpoint_restores_where_zstandard_imports(tmp_path,
                                                          monkeypatch,
                                                          writer):
    """A checkpoint compressed with zlib (as a machine without zstandard
    writes it) restores into the port wherever it runs: the reader picks
    each shard's codec by its first bytes."""
    zl = lambda b: zlib.compress(b, 3)
    state = _state(seed=3)
    if writer == "port":
        monkeypatch.setattr(CK, "_comp", zl)
        path = CK.save_checkpoint(str(tmp_path / "z"), state, {"step": 3})
    else:
        monkeypatch.setattr(RCK, "_comp", zl)
        path = RCK.save_checkpoint(str(tmp_path / "z"), _ref_state(state),
                                   {"step": 3})
    shard = Path(path, "shard_0.bin").read_bytes()
    assert shard[:1] == CK.ZLIB_MAGIC and shard[:4] != CK.ZSTD_MAGIC
    live = _zeros_like(state)
    assert CK.restore_checkpoint(path, live) == {"step": 3}
    _assert_equal_states(live, state)


def test_zstd_shard_without_zstandard_raises(tmp_path, monkeypatch):
    import zstandard
    monkeypatch.setattr(CK, "_comp",
                        lambda b: zstandard.ZstdCompressor(level=3).compress(b))
    path = CK.save_checkpoint(str(tmp_path / "z"), _state())
    assert Path(path, "shard_0.bin").read_bytes()[:4] == CK.ZSTD_MAGIC
    monkeypatch.setitem(sys.modules, "zstandard", None)     # not importable
    with pytest.raises(ImportError, match="zstd-compressed and zstandard is "
                                          "not installed"):
        CK.restore_checkpoint(path, _zeros_like(_state()))


@pytest.mark.parametrize("tear", ["gap", "overlap"])
def test_torn_part_list_raises_before_copying(tmp_path, monkeypatch, tear):
    _split(monkeypatch)
    path = CK.save_checkpoint(str(tmp_path / "split"), _state())
    mpath = Path(path, "manifest.json")
    manifest = json.loads(mpath.read_text())
    parts = next(s["parts"] for s in manifest["leaves"] if "parts" in s)
    parts[1]["start"] += 1 if tear == "gap" else -1
    mpath.write_text(json.dumps(manifest))
    live = _zeros_like(_state())
    with pytest.raises(ValueError, match="part 1 holds .* the parts before "
                                         "it end at"):
        CK.restore_checkpoint(path, live)
    assert all(not t.any() for t in T.leaves(live) if torch.is_tensor(t))
    with pytest.raises(ValueError, match="the parts before it end at"):
        CK.load_checkpoint(path)


def test_a_part_missing_from_its_shard_raises(tmp_path, monkeypatch):
    _split(monkeypatch)
    path = CK.save_checkpoint(str(tmp_path / "split"), _state())
    manifest = json.loads(Path(path, "manifest.json").read_text())
    last = next(s for s in manifest["leaves"] if "parts" in s)["parts"][-1]
    Path(path, manifest["shards"][last["shard"]]).write_bytes(CK._pack([]))
    with pytest.raises(IOError, match=r"no data for \(leaf, part\) \[\(0, 3\)"):
        CK.restore_checkpoint(path, _zeros_like(_state()))


def _ref_state(state):
    """The same state as the reference holds it (jax arrays, int32 step)."""
    def one(t):
        if not torch.is_tensor(t):
            return jnp.asarray(t, jnp.int32)
        return jnp.asarray(t.float().numpy()).astype(
            "bfloat16" if t.dtype == torch.bfloat16 else "float32")
    return T.tree_map(one, state)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    state = _state(seed=1)
    path = RCK.save_checkpoint(str(tmp_path / "step_8"), _ref_state(state),
                               {"loss": 2.0, "step": 8})
    live = _zeros_like(state)
    assert CK.restore_checkpoint(path, live) == {"loss": 2.0, "step": 8}
    _assert_equal_states(live, state)
    assert isinstance(live["step"], int)


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    state = _state(seed=2)
    path = CK.save_checkpoint(str(tmp_path / "step_9"), state, {"step": 9})
    ref_like = _ref_state(state)
    restored, meta = RCK.load_checkpoint(path, like=ref_like)
    assert meta == {"step": 9}
    want = jax.tree_util.tree_leaves(ref_like)
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))
    # both packages describe the tree alike
    ref_path = RCK.save_checkpoint(str(tmp_path / "ref"), ref_like)
    manifests = [json.loads(Path(p, "manifest.json").read_text())
                 for p in (path, ref_path)]
    assert manifests[0]["treedef"] == manifests[1]["treedef"]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]


def _adafactor_states(K=3):
    """mixtral-8x22b's smoke state under Adafactor in both packages: the
    port's ``init_state`` and the reference's client-stacked params with
    ``jax.vmap(opt.init)``, the factors filled from a seed."""
    cfg = smoke_config(get_arch("mixtral-8x22b"))
    ref_cfg = ref_smoke_config(ref_get_arch("mixtral-8x22b"))
    port = init_state(cfg, K, seed=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    for t in T.leaves(port["opt"]):
        t.copy_(torch.rand(t.shape, generator=g))
    port["step"] = 6
    rp = ref_shd.materialize(ref_shd.prepend_axis(
        ref_model_api.param_decls(ref_cfg), K, "clients"),
        jax.random.PRNGKey(1))
    ref = {"params": rp,
           "opt": jax.vmap(ref_make_optimizer(ref_cfg).init)(rp),
           "step": jnp.asarray(9, jnp.int32)}
    ref["opt"] = jax.tree_util.tree_map(
        lambda a: a + jnp.float32(0.5), ref["opt"])
    return port, ref


def test_adafactor_state_crosses_between_packages(tmp_path):
    """A port checkpoint of a client-stacked Adafactor state loads into the
    reference's reader with the reference's own state as ``like`` (same
    tree: ``{"f": {leaf: {"vr", "vc"} or {"v"}}}``), and the reference's
    checkpoint restores into the port's state, bit for bit both ways."""
    port, ref = _adafactor_states()
    path = CK.save_checkpoint(str(tmp_path / "port"), port, {"step": 6})
    restored, meta = RCK.load_checkpoint(path, like=ref)
    assert meta == {"step": 6}
    got = {"/".join(str(getattr(k, "key", k)) for k in p): leaf
           for p, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]}
    want = {"/".join(p): leaf for p, leaf in T.leaves_with_path(port)}
    assert list(got) == list(want)
    assert "opt/f/final_norm/scale/v" in got
    for name, leaf in want.items():
        if torch.is_tensor(leaf):
            np.testing.assert_array_equal(np.asarray(got[name], np.float32),
                                          leaf.float().numpy(), err_msg=name)
        else:
            assert int(got[name]) == leaf

    path = RCK.save_checkpoint(str(tmp_path / "ref"), ref, {"step": 9})
    live = _zeros_like(port)
    assert CK.restore_checkpoint(path, live) == {"step": 9}
    assert live["step"] == 9
    for (name, t), r in zip(T.leaves_with_path(live),
                            jax.tree_util.tree_leaves(ref)):
        if torch.is_tensor(t):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(r, np.float32),
                                          err_msg="/".join(name))


def test_manager_keeps_n_and_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(_zeros_like(_state())) == (None, None)
    for step in (1, 2, 3):
        mgr.save(step, _state(seed=step), {"loss": float(step)})
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    # a directory that never got its COMMITTED marker is not a checkpoint
    CK.save_checkpoint(str(tmp_path / "step_5"), _state(seed=5))
    os.remove(tmp_path / "step_5" / "COMMITTED")
    assert mgr.latest_step() == 3
    live = _zeros_like(_state())
    restored, meta = mgr.restore_latest(live)
    assert restored is live and meta == {"loss": 3.0, "step": 3}
    _assert_equal_states(live, _state(seed=3))
    with pytest.raises(IOError, match="not committed"):
        CK.restore_checkpoint(str(tmp_path / "step_5"), live)


def test_trainer_with_failure_and_resume(tmp_path):
    """The twin of the reference's ``test_e2e_trainer_with_failure_and_resume``
    (qwen1.5-4b's smoke config, 4 rounds, c3 fails at round 2)."""
    cfg = smoke_config(get_arch("qwen1.5-4b"))
    plan = FailurePlan(fail_at={2: ["c3"]})
    tr = SDFLMQTrainer(cfg, 4, 4, 2, 32, ckpt_dir=str(tmp_path),
                       failure_plan=plan, device="cpu")
    ms = tr.run()
    assert len(ms) == 4
    assert ms[-1]["n_clients"] == 3, ms[-1]
    assert all(np.isfinite(m["loss"]) for m in ms)
    assert ms[-1]["loss"] <= ms[0]["loss"] + 0.1
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    tr2 = SDFLMQTrainer(cfg, 4, 4, 2, 32, ckpt_dir=str(tmp_path),
                        device="cpu")
    assert tr2.start_round == 4
    _assert_equal_states(tr2.state, tr.state)
    assert tr2.run() == []


class _Stop(Exception):
    pass


def _stop(r, state):
    raise _Stop(r)


@pytest.mark.parametrize("strategy", ["fedavg", "fedprox"])
def test_resume_is_bit_exact(tmp_path, strategy):
    """Two rounds without a stop equal one round, a checkpoint, a process
    that stops, a fresh trainer restoring it, and one more round."""
    cfg = smoke_config(get_arch("qwen2-7b"))
    make = lambda ckpt=None: SDFLMQTrainer(
        cfg, 4, 2, 2, 32, ckpt_dir=ckpt, strategy=strategy, device="cpu")
    whole = make()
    whole.run()
    first = make(str(tmp_path))
    first.on_round_end = _stop
    with pytest.raises(_Stop):
        first.run()
    second = make(str(tmp_path))
    assert second.start_round == 1
    ms = second.run()
    assert [m["round"] for m in ms] == [1]
    assert ms[0]["loss"] == whole.metrics[1]["loss"]
    _assert_equal_states(second.state, whole.state)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


@pytest.mark.parametrize("strategy", ["fedavg", "trimmed_mean"])
def test_federated_lm_example_on_cpu(tmp_path, strategy):
    env = _env()
    env["TMPDIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.federated_lm",
         "--device", "cpu", "--rounds", "4", "--clients", "4", "--seq", "32",
         "--batch-per-client", "2", "--strategy", strategy],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rounds = [ln for ln in out.stdout.splitlines() if ln.startswith("round")]
    assert len(rounds) == 4
    assert "4 clients" in rounds[1] and "3 clients" in rounds[2]
    assert "rearrangement messages: 1" in out.stdout
    ckpt = [p for p in tmp_path.iterdir() if p.name.startswith("fedlm_ckpt_")]
    assert len(ckpt) == 1
    assert sorted(os.listdir(ckpt[0])) == ["step_3", "step_4"]


def test_train_cli_resumes_from_its_checkpoint_dir(tmp_path):
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--smoke", "--seq", "32", "--batch-per-client", "2",
            "--strategy", "fedprox", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(args + ["--rounds", "2"], env=_env(),
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    assert first.stdout.count("round") == 2
    again = subprocess.run(args + ["--rounds", "3"], env=_env(),
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr[-3000:]
    assert [ln.split()[1] for ln in again.stdout.splitlines()] == ["2"]
