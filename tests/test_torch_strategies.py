"""The port's compiled aggregation strategies against the JAX package.

Every strategy whose ``compiled`` is true: the sum ones with a premap
(fedprox, fedprox_poly, norm_clip) and the stack ones (trimmed and
weighted means, medians, krum, multi_krum, the clipped weighted trimmed
mean), plus fedavg and fedavg_poly.  The port's ``aggregate_params`` on the
CPU is held against

* the reference's ``aggregate_params`` on a K-device host mesh, inside
  ``with mesh:`` (a subprocess, since jax fixes the device count at first
  use).  Op by op it is the reference's arithmetic as written, and the port
  matches it bit for bit.  Under ``jax.jit`` XLA fuses products into
  multiply-adds and reorders sums, so for the strategies with a premap or
  a weight-mass trim that leg holds to ``assert_close_ulps`` (4 f32 ulps of
  the leaf's largest magnitude, or one bf16 ulp of the value), and bit for
  bit for the others;
* the no-mesh composition of the reference's hooks on ``jax.numpy`` (a
  premap per client, then the weighted sum or ``combine_masked``), for
  K = 4 and 5 with one dead row: bit for bit, except that the norm clip's
  per-client sum of squares within a leaf runs in torch's order, not
  XLA's, which holds to ``assert_close_ulps``.

krum and multi_krum use rows whose distances are well separated (ROADMAP
R2: the selection of near-tied rows depends on the Gram's rounding)."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import strategies as RS
from repro.dist import compression as RC
from repro_torch.api import strategies as S
from repro_torch.core import aggregation
from repro_torch.core.topology import AggSchedule
from test_torch_common import bf16_ulp

ROOT = Path(__file__).resolve().parents[1]
COMPILED = sorted(n for n in S.list_strategies() if S.get_strategy(n).compiled)
SUM_PREMAP = {"fedprox", "fedprox_poly", "norm_clip"}
NORM = {"norm_clip", "clipped_weighted_trimmed_mean"}
SHAPES = {"w": ((6, 40), "bfloat16"), "v": ((5, 3, 24), "float32"),
          "s": ((), "float32")}


def _case(K, seed=0):
    """(bank, ref, weights) as f32 numpy holding exact values of each
    leaf's dtype.  Client k's rows spread with k, so krum's distances are
    well separated; each client's update from its ref grows with k, so the
    norm clip (10) binds for some clients and not for others."""
    rng = np.random.default_rng(seed)
    bank, ref = {}, {}
    for name, (shape, dt) in SHAPES.items():
        scale = (1.0 + np.arange(K)).reshape((K,) + (1,) * len(shape))
        base = rng.standard_normal(shape).astype(np.float32)
        x = base + 0.3 * scale * rng.standard_normal((K,) + shape)
        g = x + 0.2 * scale * rng.standard_normal((K,) + shape)
        bank[name] = np.asarray(jnp.asarray(x, jnp.float32).astype(dt)
                                .astype(jnp.float32))
        ref[name] = np.asarray(jnp.asarray(g, jnp.float32).astype(dt)
                               .astype(jnp.float32))
    w = np.asarray([1.0, 2.0, 0.0, 3.0] + [1.5] * (K - 4), np.float32)
    return bank, ref, w


def _port(tree):
    return {k: torch.from_numpy(v.copy()).to(getattr(torch, SHAPES[k][1]))
            for k, v in tree.items()}


def _jax(tree):
    """In sorted key order, as a jax tree flattens and unflattens (the norm
    clip sums its leaves in this order)."""
    return {k: jnp.asarray(tree[k]).astype(SHAPES[k][1]) for k in sorted(tree)}


def assert_close_ulps(got, want, dt):
    """4 f32 ulps of the leaf's largest magnitude (a sum in another order
    moves a small value by the ulps of the large terms it came from), or,
    for a bf16 leaf, one bf16 ulp of the value where that is more."""
    err = np.abs(got - want)
    tol = np.full(want.shape, 4 * 2.0 ** -23 * np.abs(want).max(), np.float32)
    if dt == "bfloat16":
        tol = np.maximum(tol, bf16_ulp(want))
    assert (err <= tol).all(), f"{(err > tol).sum()} beyond; max err {err.max()}"


def _port_agg(name, bank, ref, w, kind="tree"):
    K = len(w)
    out = _port(bank)
    aggregation.aggregate_params(out, torch.from_numpy(w),
                                 AggSchedule(kind, K), name, ref=_port(ref))
    return {k: v.float().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# the reference on a host mesh
# ---------------------------------------------------------------------------

_MESH_CHECK = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.aggregation import aggregate_params as ref_aggregate
from repro.core.topology import AggSchedule as RefSchedule
from test_torch_strategies import (COMPILED, NORM, SHAPES, SUM_PREMAP,
                                   _case, _jax, _port_agg, assert_close_ulps)

K = int(sys.argv[1])
EAGER = sys.argv[2].split(",") if sys.argv[2] else []
assert jax.device_count() == K
mesh = jax.make_mesh((K,), ("data",))
bank, ref, w = _case(K)
specs = {k: P("data") for k in SHAPES}
pairs = tuple((i, i + 1) for i in range(0, K - 1, 2)) + ((K - 1,),) * (K % 2)
sched = RefSchedule("tree", K, (pairs, (tuple(range(K)),)),
                    (tuple(1 - i % 2 for i in range(K)),))
for name in COMPILED:
    def run(t, w, r):
        return ref_aggregate(t, w, mesh, "data", sched, specs, strategy=name,
                             ref_params=r)
    legs = [("jit", jax.jit(run))] + [("eager", run)] * (name in EAGER)
    got = _port_agg(name, bank, ref, w)
    for leg, fn in legs:
        with mesh:
            out = fn(_jax(bank), jnp.asarray(w), _jax(ref))
        for k, (shape, dt) in SHAPES.items():
            # the stack branch returns the premapped (f32) leaf's dtype;
            # the port keeps the bank's
            want = np.asarray(out[k].astype(dt).astype(jnp.float32))
            assert got[k].shape == want.shape, (name, k)
            if leg == "eager" or name not in SUM_PREMAP | NORM | {
                    "weighted_trimmed_mean"}:
                assert np.array_equal(got[k], want), (
                    name, leg, k, np.abs(got[k] - want).max())
            else:
                assert_close_ulps(got[k], want, dt)
print("MESH MATCHES", len(COMPILED))
'''


@pytest.mark.parametrize("K,eager", [
    (4, "fedprox,norm_clip,weighted_trimmed_mean,"
        "clipped_weighted_trimmed_mean"),
    (5, "")])
def test_strategies_match_reference_on_host_mesh(K, eager):
    """Jitted: every compiled strategy, to the stated tolerances.  Op by
    op (K = 4, the four strategies that differ under jit): bit for bit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={K}"
    out = subprocess.run([sys.executable, "-c", _MESH_CHECK, str(K), eager],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}"
    assert f"MESH MATCHES {len(COMPILED)}" in out.stdout


# ---------------------------------------------------------------------------
# the reference's hooks composed without a mesh
# ---------------------------------------------------------------------------

def _ref_composition(name, bank, ref, w):
    """What the reference's compiled branch computes, on one process: each
    client's premap against its own ref row, then the weighted sum over
    clients k = 0..K-1 / sum(w), or ``combine_masked`` over the stack."""
    strat = RS.get_strategy(name)
    K = len(w)
    x, g = _jax(bank), _jax(ref)
    rows = [{k: v[i:i + 1] for k, v in x.items()} for i in range(K)]
    if strat.needs_ref:
        rows = [strat.premap(r, {k: v[i:i + 1] for k, v in g.items()}, jnp)
                for i, r in enumerate(rows)]
    if strat.reduction == "stack":
        stacked = {k: jnp.concatenate([r[k] for r in rows]) for k in x}
        out = strat.combine_masked(stacked, jnp.asarray(w), jnp)
    else:
        wj = jnp.asarray(w)
        out = {}
        for k in x:
            acc = rows[0][k].astype(jnp.float32)[0] * wj[0]
            tw = wj[0]
            for i in range(1, K):
                acc = acc + rows[i][k].astype(jnp.float32)[0] * wj[i]
                tw = tw + wj[i]
            out[k] = acc / tw
    return {k: np.asarray(out[k].astype(SHAPES[k][1]).astype(jnp.float32))
            for k in x}


@pytest.mark.parametrize("K", [4, 5])
@pytest.mark.parametrize("name", COMPILED)
def test_strategy_matches_reference_composition(name, K):
    bank, ref, w = _case(K, seed=K)
    got = _port_agg(name, bank, ref, w)
    want = _ref_composition(name, bank, ref, w)
    for k, (_, dt) in SHAPES.items():
        want_k = np.broadcast_to(want[k], got[k].shape)
        if name in NORM:
            assert_close_ulps(got[k], want_k, dt)
        else:
            np.testing.assert_array_equal(got[k], want_k, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", COMPILED)
def test_chunked_equals_unchunked(name, monkeypatch):
    """Chunks of 7 elements per client give the unchunked bits; for the
    norm clip the per-client sums of squares add up in another order, so
    its scale (and the result) moves by f32 rounding: 4 f32 ulps, one bf16
    ulp."""
    bank, ref, w = _case(4, seed=3)
    whole = _port_agg(name, bank, ref, w)
    monkeypatch.setattr(aggregation, "CHUNK", 7)
    chunked = _port_agg(name, bank, ref, w)
    for k, (_, dt) in SHAPES.items():
        if name in NORM:
            assert_close_ulps(chunked[k], whole[k], dt)
        else:
            np.testing.assert_array_equal(chunked[k], whole[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(SUM_PREMAP))
def test_premapped_sums_launch_fedavg_once_a_chunk(name, monkeypatch):
    bank, ref, w = _case(4, seed=4)
    calls = []
    real = aggregation.fedavg

    def counted(x, weights):
        calls.append((tuple(x.shape), x.dtype))
        return real(x, weights)
    monkeypatch.setattr(aggregation, "fedavg", counted)
    monkeypatch.setattr(aggregation, "CHUNK", 100)
    _port_agg(name, bank, ref, w)
    # leaves in sorted order: s 1 -> 1 chunk, v 360 -> 4, w 240 -> 3;
    # every one an f32 (K, c) block
    assert [c[0] for c in calls] == [(4, n) for n in
                                     (1, 100, 100, 100, 60, 100, 100, 40)]
    assert {c[1] for c in calls} == {torch.float32}


@pytest.mark.parametrize("name", ["fedprox", "norm_clip"])
def test_compressed_schedule_premaps_like_the_reference(name):
    """The compressed schedule quantizes the premapped weighted
    contributions, as the reference's ``_compressed`` does: bit for bit
    with its pieces composed on jnp (quantize_int8, the sequential qagg
    sum, / sum(w))."""
    bank, ref, w = _case(4, seed=5)
    got = _port_agg(name, bank, ref, w, kind="compressed")
    strat = RS.get_strategy(name)
    x, g = _jax(bank), _jax(ref)
    rows = [strat.premap({k: v[i:i + 1] for k, v in x.items()},
                         {k: v[i:i + 1] for k, v in g.items()}, jnp)
            for i in range(4)]
    for k, (shape, dt) in SHAPES.items():
        G = shape[-1] if shape else 1
        acc = None
        for i in range(4):
            q, s = RC.quantize_int8(
                (rows[i][k].astype(jnp.float32) * w[i]).reshape(-1, G))
            part = q.astype(jnp.float32) * s
            acc = part if acc is None else acc + part
        want = (acc / jnp.asarray(w).sum()).reshape(shape).astype(dt)
        np.testing.assert_array_equal(
            got[k], np.broadcast_to(np.asarray(want.astype(jnp.float32)),
                                    got[k].shape), err_msg=k)


def test_one_ref_row_equals_k_identical_rows():
    """A ref with leading dim 1 (every slot holds the same global) premaps
    exactly as K copies of it."""
    bank, ref, w = _case(4, seed=6)
    one = {k: v[:1] for k, v in ref.items()}
    many = {k: np.repeat(v, 4, axis=0) for k, v in one.items()}
    for name in sorted(SUM_PREMAP | NORM):
        a = _port(bank)
        aggregation.aggregate_params(a, torch.from_numpy(w),
                                     AggSchedule("tree", 4), name,
                                     ref=_port(one))
        assert all(np.array_equal(a[k].float().numpy(), v) for k, v in
                   _port_agg(name, bank, many, w).items()), name


@pytest.mark.parametrize("name", ["krum", "multi_krum"])
def test_krum_with_a_dead_row_equals_combine_over_live_rows(name):
    bank, _, w = _case(5, seed=8)
    got = _port_agg(name, bank, bank, w)
    live = np.flatnonzero(w > 0)
    stacked = {k: jnp.asarray(v[live]).astype(SHAPES[k][1])
               for k, v in bank.items()}
    want = RS.get_strategy(name).combine(stacked, jnp.asarray(w[live]), jnp)
    for k, (_, dt) in SHAPES.items():
        np.testing.assert_array_equal(
            got[k][0], np.asarray(want[k].astype(dt).astype(jnp.float32)))


def test_every_compiled_strategy_is_accepted_and_fedadam_raises():
    assert len(COMPILED) == 12
    for name in COMPILED:
        assert aggregation.check_strategy(name).name == name
    with pytest.raises(ValueError, match="no compiled"):
        aggregation.check_strategy("fedadam")

    class Shifted(S.AggregationStrategy):
        name = "shifted"

        def premap(self, params, ref, xp):
            return params
    with pytest.raises(NotImplementedError, match="no torch form"):
        aggregation.check_strategy(Shifted())
