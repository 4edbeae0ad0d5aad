"""The port's compressed aggregation round against the JAX package.

On the CPU the qagg and quant8 wrappers take their plain PyTorch versions;
those are held bit for bit against the reference's Pallas kernels in
interpret mode and against its plain functions.  The ``compressed``
schedule is held bit for bit against the reference's ``aggregate_params``
on a 4-device host mesh (in a subprocess, since jax fixes the device count
at its first use).  The host MQTT codecs of the copied control plane run
on the port's ``dist/compression`` and give the reference's globals bit for
bit.  The CUDA kernels are held against their plain versions on a card by
tests/test_torch_cuda.py."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Federation as RefFederation
from repro.dist import compression as RC
from repro.kernels.fedavg.ops import qagg as ref_qagg
from repro.kernels.fedavg.ref import qagg_ref as jax_qagg_ref
from repro.kernels.quant8.ops import dequantize as ref_dequantize
from repro.kernels.quant8.ops import quantize as ref_quantize
from repro_torch import tree as T
from repro_torch.api import Federation
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import aggregation
from repro_torch.core.client import _Accumulator
from repro_torch.core.fl_step import build_fl_round_step, init_state
from repro_torch.core.topology import AggSchedule
from repro_torch.data.federated import FederatedTokens
from repro_torch.dist import compression as C
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.ref import qagg_ref
from repro_torch.kernels.quant8 import ops as quant8_ops
from repro_torch.launch.train import SDFLMQTrainer

ROOT = Path(__file__).resolve().parents[1]
QAGG_SHAPES = [(4, 64, 256), (3, 33, 7), (8, 1, 1024), (1, 5, 5),
               (2, 128, 128)]            # tests/test_edge_lm.py's cases


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.update(extra)
    return env


# ---------------------------------------------------------------------------
# qagg: plain version vs the Pallas kernel (interpret) and the jnp oracle
# ---------------------------------------------------------------------------

def _qagg_case(seed, shape):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, shape).astype(np.int8)
    s = rng.uniform(0.5, 2.0, shape[:-1] + (1,)).astype(np.float32) / 127
    w = rng.uniform(0.5, 2.0, shape[0]).astype(np.float32)
    return q, s, w


def _qagg_both(shape, unit_weights):
    q, s, w = _qagg_case(sum(shape), shape)
    if len(shape) == 1:                 # scalar leaf: one scale per client
        s = np.linspace(0.5, 2.0, shape[0], dtype=np.float32)[:, None] / 127
    if unit_weights:
        w = np.ones_like(w)
    got = fedavg_ops.qagg(torch.from_numpy(q), torch.from_numpy(s),
                          torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[1:]
    want = {force: np.asarray(ref_qagg(jnp.asarray(q), jnp.asarray(s),
                                       jnp.asarray(w), force=force))
            for force in ("pallas", "ref")}
    return q, s, w, got.numpy(), want


@pytest.mark.parametrize("shape", QAGG_SHAPES + [(4, 3, 5, 16), (3,)])
def test_qagg_unit_weights_match_pallas_interpret_and_ref_bit_exact(shape):
    """Unit weights, as the ``compressed`` schedule calls qagg."""
    *_, got, want = _qagg_both(shape, unit_weights=True)
    for force, w in want.items():
        np.testing.assert_array_equal(got, w, err_msg=force)


@pytest.mark.parametrize("shape", QAGG_SHAPES + [(4, 3, 5, 16), (3,)])
def test_qagg_weighted_matches_pallas_interpret_and_ref(shape):
    """Non-unit weights.  The port rounds each product and each add on its
    own; XLA fuses ``sum(x * w)`` into fused multiply-adds when it compiles
    the reference (both of its paths), so the two differ by at most one
    rounding per term: 2 K eps sum_k |x_k w_k| bounds the difference."""
    q, s, w, got, want = _qagg_both(shape, unit_weights=False)
    x = np.abs(q.astype(np.float64) * s * w.reshape((-1,) + (1,) * (q.ndim - 1)))
    bound = 2 * q.shape[0] * np.finfo(np.float32).eps * x.sum(0)
    for force, ref in want.items():
        assert (np.abs(got.astype(np.float64) - ref) <= bound).all(), force


def test_qagg_rejects_mismatched_scales():
    q, s, w = _qagg_case(0, (3, 4, 8))
    with pytest.raises(ValueError, match="scales"):
        fedavg_ops.qagg(torch.from_numpy(q), torch.from_numpy(s[:, :2]),
                        torch.from_numpy(w))


def test_host_fused_accumulator_matches_qagg():
    """The host MQTT path's streaming f64 consume and the compiled path's
    qagg agree on identical codec output (port twin of
    test_edge_lm.py::test_host_fused_accumulator_matches_qagg_kernel, at its
    tolerance: the host accumulates in f64, qagg in f32)."""
    rng = np.random.default_rng(11)
    n_clients, shape = 4, (24, 96)
    qs, ss = [], []
    acc = _Accumulator()
    for _ in range(n_clients):
        x = rng.normal(size=shape).astype(np.float32) * 3
        q, s = C.quantize_int8(x, xp=np)
        qs.append(q)
        ss.append(np.asarray(s, np.float32))
        acc.add_sum_quantized({"w": q}, {"w": ss[-1]}, 1.0)
        acc.received += 1
    host = np.asarray(acc.acc_views()["w"], np.float32)
    kern = fedavg_ops.qagg(torch.from_numpy(np.stack(qs)),
                           torch.from_numpy(np.stack(ss)),
                           torch.ones(n_clients)).numpy()
    np.testing.assert_allclose(host, kern, rtol=1e-5, atol=1e-5)
    want = np.asarray(ref_qagg(jnp.asarray(np.stack(qs)),
                               jnp.asarray(np.stack(ss)),
                               jnp.ones((n_clients,), jnp.float32),
                               force="pallas"))
    np.testing.assert_array_equal(kern, want)


# ---------------------------------------------------------------------------
# quant8: plain versions vs the Pallas kernels (interpret), padding included
# ---------------------------------------------------------------------------

def _quant8_input(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 10.0)).astype(np.float32)
    x[: min(n, 256)] = 0.0               # an all-zero block
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    return xj, xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [65536, 1000, 70001])
def test_quant8_matches_pallas_interpret_with_padding(n, dtype):
    xj, xt = _quant8_input(n, dtype, seed=n)
    q, s, got_n = quant8_ops.quantize(xt)
    assert got_n == n and q.shape[1] == 256 and q.shape[0] % 256 == 0
    for force in ("pallas", "ref"):
        wq, ws, wn = ref_quantize(xj, force=force)
        assert wn == n
        # every row, the zero padding rows (q 0, scale 1e-12) included
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq), force)
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws), force)
    out = quant8_ops.dequantize(q, s, n)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n,)
    for force in ("pallas", "ref"):
        want = ref_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                              n, force=force)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want), force)
    # symmetric int8: error within half a step of each block's scale
    err = np.abs(out.numpy() - xt.float().numpy())
    step = np.repeat(s.numpy(), 256)[:n]
    assert (err <= step * 0.5 + 1e-6 * np.abs(xt.float().numpy())).all()


def test_quant8_nan_and_inf_blocks_match_pallas_interpret():
    """A block with a NaN keeps a NaN scale; a value that is NaN after the
    division (NaN input, or any value of an infinite-scale block) becomes
    q = 0, as XLA converts NaN to int8."""
    x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    x[3] = np.nan
    x[260] = np.inf
    x[600] = -np.inf
    q, s, _ = quant8_ops.quantize(torch.from_numpy(x))
    wq, ws, _ = ref_quantize(jnp.asarray(x), force="pallas")
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert np.isnan(s[0].item()) and np.isinf(s[1].item())


# ---------------------------------------------------------------------------
# the compressed schedule
# ---------------------------------------------------------------------------

_MESH_CHECK = r'''
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import PartitionSpec as P
from repro.core.aggregation import aggregate_params as ref_aggregate
from repro.core.topology import AggSchedule as RefSchedule
from repro_torch.core import aggregation
from repro_torch.core.topology import AggSchedule

assert jax.device_count() == 4
mesh = jax.make_mesh((4,), ("data",))
rng = np.random.default_rng(0)
shapes = {"w": ((4, 6, 40), "bfloat16"), "v": ((4, 5, 3, 24), "float32"),
          "b": ((4, 7), "bfloat16"), "s": ((4,), "float32")}
tree = {k: jnp.asarray(rng.standard_normal(shape) * 2, jnp.float32)
        .astype(dt) for k, (shape, dt) in shapes.items()}
specs = {k: P("data") for k in tree}
w = np.asarray([0.7, 0.1, 0.3, 0.0], np.float32)     # a zero-weight client
sched = RefSchedule("compressed", 4)
with mesh:
    eager = ref_aggregate(tree, jnp.asarray(w), mesh, "data", sched, specs)
    jitted = jax.jit(lambda t, w: ref_aggregate(t, w, mesh, "data", sched,
                                                specs))(tree, jnp.asarray(w))
for chunk in (aggregation.CHUNK, 64):
    port = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
            .to(getattr(torch, shapes[k][1])) for k, v in tree.items()}
    aggregation.CHUNK = chunk
    aggregation.aggregate_params(port, torch.from_numpy(w),
                                 AggSchedule("compressed", 4))
    for k, x in tree.items():
        got = port[k].float().numpy()
        want = np.asarray(eager[k].astype(jnp.float32))
        assert got.shape == want.shape, (k, got.shape, want.shape)
        assert np.array_equal(got, want), (k, chunk, np.abs(got - want).max())
        # jit: amax/127 becomes a reciprocal multiply and the sum fused
        # multiply-adds.  The fused sum of K terms of at most 127 steps
        # each moves the mean by a few f32 ulps of that sum; a bf16 leaf
        # may then round to the neighbouring bf16 value (2^-7 relative,
        # bf16 only).  A scale moved by an ulp flips a rounding only for
        # values within ~127 ulps of a half: at most one quantization step
        # per client over the weight total, and for a rare few values.
        G = x.shape[-1] if x.ndim > 1 else 1
        x3 = np.asarray(x.astype(jnp.float32)).reshape(4, -1, G)
        step = (np.abs(x3 * w.reshape(4, 1, 1)).max(-1) / 127).sum(0) \
            / w.sum()
        step = step.reshape(-1, 1)
        g0 = np.abs(got.reshape(4, -1, G)[0])
        cast = 2.0 ** -7 * g0 if shapes[k][1] == "bfloat16" else 0.0
        near = 4 * 127 * 2.0 ** -23 * step + 2.0 ** -23 * g0 + cast
        diff = np.abs(got - np.asarray(jitted[k].astype(jnp.float32)))
        d0 = diff.reshape(4, -1, G)[0]
        assert (d0 <= step + near).all(), k
        assert (d0 <= near).mean() >= 0.99, (k, (d0 <= near).mean())
print("COMPRESSED MATCHES")
'''


def test_compressed_schedule_matches_reference_on_4_device_mesh():
    """Bit for bit against the reference's ``aggregate_params`` as it runs
    op by op: bf16 and f32 leaves, a zero-weight client, non-dyadic weights,
    and the quantize pass cut into 64-element chunks.  Under ``jax.jit``
    XLA rewrites the reference's arithmetic (reciprocal multiply, fused
    multiply-adds), so that leg holds to a few f32 ulps of the sum (and
    one bf16 ulp for bf16 leaves), with a quantization step allowed for at
    most 1 % of the values."""
    out = subprocess.run(
        [sys.executable, "-c", _MESH_CHECK], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert out.returncode == 0, f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}"
    assert "COMPRESSED MATCHES" in out.stdout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compressed_schedule_matches_reference_composition(dtype):
    """No mesh: the reference's pieces composed by hand (quantize_int8 on
    each weighted contribution, qagg in interpret mode, / sum(w))."""
    rng = np.random.default_rng(1)
    K = 4
    w = np.asarray([1.0, 2.5, 3.0, 0.0], np.float32)
    x = rng.standard_normal((K, 6, 40)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    x_exact = xt.float().numpy()
    xj = jnp.asarray(x_exact).astype("bfloat16" if dtype == torch.bfloat16
                                     else "float32")
    q, s = RC.quantize_int8(xj.astype(jnp.float32) * w.reshape(K, 1, 1))
    want = (ref_qagg(q, s, jnp.ones((K,), jnp.float32), force="pallas")
            / jnp.sum(jnp.asarray(w))).astype(xj.dtype)
    bank = {"x": xt.clone()}
    aggregation.aggregate_params(bank, torch.from_numpy(w),
                                 AggSchedule("compressed", K))
    for k in range(K):
        np.testing.assert_array_equal(bank["x"][k].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def _count_calls(monkeypatch, name):
    calls = [0]
    real = getattr(aggregation, name)

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(aggregation, name, counted)
    return calls


def test_trainer_compressed_rounds_on_cpu(monkeypatch):
    cfg = smoke_config(get_arch("qwen2-7b"))
    qaggs = _count_calls(monkeypatch, "qagg")
    fedavgs = _count_calls(monkeypatch, "fedavg")
    tr = SDFLMQTrainer(cfg, 4, 2, 2, 32, schedule_kind="compressed",
                       device="cpu")
    metrics = tr.run()
    n_leaves = len(T.leaves(tr.state["params"]))
    assert [m["round"] for m in metrics] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert all(m["schedule"].startswith("compressed/4/") for m in metrics)
    assert len(tr._steps) == 1           # one cached step for the schedule
    assert qaggs[0] == n_leaves * 2 and fedavgs[0] == 0
    for t in T.leaves(tr.state["params"]):
        assert all(torch.equal(t[k], t[0]) for k in range(4))


def test_compressed_mean_stays_within_int8_error_of_fedavg():
    """The same bank through ``flat`` and ``compressed``: the means differ
    by the int8 rounding of each weighted contribution, at most half a
    quantization step (row amax / 127) per client, over the weight total;
    plus the f32 rounding of the two sums."""
    rng = np.random.default_rng(2)
    w = torch.tensor([1.0, 2.0, 3.0, 0.5])
    bank = {"a": torch.from_numpy(
                rng.standard_normal((4, 6, 50)).astype(np.float32)),
            "b": torch.from_numpy(
                rng.standard_normal((4, 9)).astype(np.float32) * 5)}
    contrib = {k: v.reshape(4, -1, v.shape[-1]) * w.view(4, 1, 1)
               for k, v in bank.items()}
    flat = {k: v.clone() for k, v in bank.items()}
    aggregation.aggregate_params(flat, w, AggSchedule("flat", 4))
    aggregation.aggregate_params(bank, w, AggSchedule("compressed", 4))
    for k in bank:
        step = contrib[k].abs().amax(-1, keepdim=True) / 127      # (K, R, 1)
        bound = (0.5 * step).sum(0) / w.sum()
        got = bank[k][0].reshape(-1, bank[k].shape[-1])
        want = flat[k][0].reshape(-1, bank[k].shape[-1])
        assert ((got - want).abs() <= bound + 1e-6).all(), k
        assert all(torch.equal(bank[k][i], bank[k][0]) for i in range(4))


def test_compressed_with_update_filter_aggregates_only_trainable(monkeypatch):
    cfg = smoke_config(get_arch("qwen2-7b"))
    filt = "*/attn/*"
    state = init_state(cfg, 4, 0, "cpu", update_filter=filt)
    before = [t.clone() for t in T.leaves(state["params"])]
    qaggs = _count_calls(monkeypatch, "qagg")
    step = build_fl_round_step(cfg, 4, AggSchedule("compressed", 4), "cpu",
                               update_filter=filt)
    batch = FederatedTokens(cfg.vocab, 4, seed=0).global_batch(4, 1, 16, 0)
    state, m = step(state, batch, np.ones(4, np.float32))
    assert np.isfinite(float(m["loss"]))
    names = ["/".join(p) for p, _ in T.leaves_with_path(state["params"])]
    trained = [n for n in names if "/attn/" in n]
    assert trained and qaggs[0] == len(trained)
    for name, old, new in zip(names, before, T.leaves(state["params"])):
        if name in trained:
            assert all(torch.equal(new[k], new[0]) for k in range(4)), name
        else:
            assert torch.equal(new, old), name
    assert any(not torch.equal(new, old) for name, old, new in zip(
        names, before, T.leaves(state["params"])) if name in trained)


def test_train_cli_compressed_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--rounds", "2", "--seq", "32", "--batch-per-client", "2",
         "--schedule", "compressed"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("sched=compressed/4/") == 2


# ---------------------------------------------------------------------------
# host codecs: the copied control plane on the port's compression module
# ---------------------------------------------------------------------------

CODECS = [
    dict(uplink_codec="int8_ef"),
    dict(uplink_codec="topk_int8_ef", topk_density=0.25),
    dict(downlink_codec="int8"),
    dict(uplink_codec="topk_int8_ef", topk_density=0.5,
         downlink_codec="int8", update_filter="*/lora_A,*/lora_B"),
]


def _run_federation(fed_cls, rounds=3, **kw):
    fed = fed_cls(aggregator_ratio=0.4, levels=2, **kw)
    clients = [fed.client(f"c{i}", preferred_role="aggregator" if i % 2
                          else "trainer") for i in range(5)]
    session = fed.create_session("s", "m", rounds=rounds,
                                 participants=clients)
    rng = np.random.default_rng(21)
    local = {f"c{i}": {"base/w": rng.normal(size=(12, 12)).astype(np.float32),
                       "head/lora_A": rng.normal(size=(12, 4))
                       .astype(np.float32),
                       "head/lora_B": rng.normal(size=(4, 12))
                       .astype(np.float32)} for i in range(5)}

    def train(cid, g, r):
        if g is None:
            return local[cid], 1 + int(cid[1:])
        return ({k: np.asarray(g.get(k, v), np.float32) * 0.5
                 + v * (0.1 * (r + 1)) for k, v in local[cid].items()},
                1 + int(cid[1:]))

    init = {k: np.zeros_like(v) for k, v in local["c0"].items()}
    seen = session.run(train, initial_params=init)
    return seen, fed


@pytest.mark.parametrize("codec", CODECS,
                         ids=lambda c: "+".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_federation_codecs_match_reference(codec):
    got, fed = _run_federation(Federation, **codec)
    want, _ = _run_federation(RefFederation, **codec)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
    stats = [c.codec_stats for c in fed.clients.values()]
    if "uplink_codec" in codec:
        assert sum(s["uplink_bytes"] for s in stats) > 0
