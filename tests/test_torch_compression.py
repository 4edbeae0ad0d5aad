"""The port's ``dist/compression`` against the JAX package's.

The port's module takes numpy (the host MQTT codecs call it with
``xp=np``) and torch tensors (the ``compressed`` schedule); the reference
takes numpy and ``jax.numpy``.  Every leg is exact: both sides divide by
the scale and round half to even.  Top-k inputs are tie-free, since numpy,
jax and torch may break ties between equal magnitudes differently."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as RC
from repro_torch.dist import compression as C

SRC = Path(__file__).resolve().parents[1] / "src"
SHAPES = [(37, 129), (5, 3, 17), (64,), ()]
DENSITIES = [0.01, 0.1, 0.5, 1.0]


def _x(shape, seed=0, scale=3.0):
    rng = np.random.default_rng(seed + 17 * len(shape))
    x = np.asarray(rng.standard_normal(shape) * scale, np.float32)
    if x.ndim >= 1 and x.size > 4:
        x.reshape(-1)[::7] = 0.0           # zero runs, and an all-zero row
        if x.ndim >= 2:
            x[0] = 0.0
    return x


def _tie_free(shape, seed=0):
    """Distinct magnitudes: a shuffled ramp with random signs."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    mag = (np.arange(1, n + 1, dtype=np.float32) / n) * 4.0
    sign = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0).astype(np.float32)
    return (rng.permutation(mag) * sign).reshape(shape)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_int8_matches_reference_numpy_torch_jnp(shape):
    x = _x(shape)
    want_q, want_s = RC.quantize_int8(x, xp=np)
    jq, js = RC.quantize_int8(jnp.asarray(x))
    _assert_same(jq, want_q)
    _assert_same(js, want_s)
    for got in (C.quantize_int8(x, xp=np), C.quantize_int8(x),
                C.quantize_int8(torch.from_numpy(x)),
                C.quantize_int8(x, xp=torch)):
        _assert_same(got[0], want_q)
        _assert_same(got[1], want_s)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_int8_torch_input_dtypes(dtype):
    xj = jnp.asarray(_x((16, 48), seed=3)).astype(dtype)
    x_exact = np.asarray(xj.astype(jnp.float32))
    want_q, want_s = RC.quantize_int8(xj)
    q, s = C.quantize_int8(torch.from_numpy(x_exact).to(getattr(torch, dtype)))
    _assert_same(q, np.asarray(want_q))
    _assert_same(s, np.asarray(want_s))


@pytest.mark.parametrize("shape", SHAPES)
def test_dequantize_int8_matches_reference(shape):
    q, s = RC.quantize_int8(_x(shape, seed=1), xp=np)
    want = RC.dequantize_int8(q, s, xp=np)
    _assert_same(C.dequantize_int8(q, s, xp=np), want)
    _assert_same(C.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s)),
                 want)
    _assert_same(RC.dequantize_int8(jnp.asarray(q), jnp.asarray(s)), want)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_quantize_with_error_feedback_matches_reference(shape):
    x = _x(shape, seed=2)
    err = (np.random.default_rng(5).standard_normal(shape) * 0.01) \
        .astype(np.float32)
    want = RC.quantize_with_error_feedback(x, err, xp=np)
    for got in (C.quantize_with_error_feedback(x, err, xp=np),
                C.quantize_with_error_feedback(torch.from_numpy(x),
                                               torch.from_numpy(err))):
        for g, w in zip(got, want):
            _assert_same(g, w)
    # the residual stays within one quantization step
    _, scale, new_err = want
    assert (np.abs(new_err) <= scale * 0.5 + 1e-6).all()


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("shape", [(40, 25), (3, 7, 11), (9,)])
def test_topk_sparsify_matches_reference(shape, density):
    x = _tie_free(shape, seed=len(shape))
    want_i, want_v = RC.topk_sparsify(x, density, xp=np)
    ji, jv = RC.topk_sparsify(jnp.asarray(x), density)
    _assert_same(ji, want_i)
    _assert_same(jv, want_v)
    for got in (C.topk_sparsify(x, density, xp=np),
                C.topk_sparsify(torch.from_numpy(x), density)):
        _assert_same(got[0], want_i)
        _assert_same(got[1], want_v)


@pytest.mark.parametrize("density", [0.3, 0.6])
def test_topk_numpy_ties_resolve_as_reference_numpy(density):
    """numpy inputs keep the reference's numpy index choice on ties: a
    sparse delta whose zeros must fill part of the top-k (exact)."""
    x = np.zeros((20, 30), np.float32)
    x.reshape(-1)[::5] = _tie_free((120,), seed=2)
    x[3, 4] = x[7, 9] = 2.5                       # a tie among non-zeros too
    want_i, want_v = RC.topk_sparsify(x, density, xp=np)
    got_i, got_v = C.topk_sparsify(x, density, xp=np)
    _assert_same(got_i, want_i)
    _assert_same(got_v, want_v)
    err = np.zeros_like(x)
    for g, w in zip(C.quantize_topk_int8_ef(x, err, density, xp=np),
                    RC.quantize_topk_int8_ef(x, err, density, xp=np)):
        _assert_same(g, w)


def test_topk_count_and_empty_input():
    for n, d in [(0, 0.5), (1, 0.01), (10, 0.25), (100, 1.0), (7, 0.999)]:
        assert C.topk_count(n, d) == RC.topk_count(n, d)
    for xp, arr in ((np, np.zeros((0,), np.float32)),
                    (torch, torch.zeros((0,)))):
        idx, vals = C.topk_sparsify(arr, 0.5, xp=xp)
        assert tuple(idx.shape) == (0,) and tuple(vals.shape) == (0,)


@pytest.mark.parametrize("density", DENSITIES)
def test_quantize_topk_int8_ef_matches_reference_and_conserves_mass(density):
    shape = (24, 33)
    x = _tie_free(shape, seed=9)
    err = (np.random.default_rng(4).standard_normal(shape) * 1e-3) \
        .astype(np.float32)
    want = RC.quantize_topk_int8_ef(x, err, density, xp=np)
    jgot = RC.quantize_topk_int8_ef(jnp.asarray(x), jnp.asarray(err), density)
    for g, w in zip(jgot, want):
        _assert_same(g, w)
    for got in (C.quantize_topk_int8_ef(x, err, density, xp=np),
                C.quantize_topk_int8_ef(torch.from_numpy(x),
                                        torch.from_numpy(err), density)):
        for g, w in zip(got, want):
            _assert_same(g, w)
        idx, q, scale, new_err = (_np(t) for t in got)
        dense = C.densify_topk(idx, q, scale, shape, xp=np)
        # mass conservation, in f32: exact up to the rounding of one add
        np.testing.assert_allclose(dense + new_err, x + err, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("density", [0.05, 1.0])
def test_densify_topk_matches_reference(density):
    shape = (12, 20)
    idx, q, s, _ = RC.quantize_topk_int8_ef(
        _tie_free(shape, seed=1), np.zeros(shape, np.float32), density, xp=np)
    want = RC.densify_topk(idx, q, s, shape, xp=np)
    _assert_same(RC.densify_topk(jnp.asarray(idx), jnp.asarray(q),
                                 jnp.asarray(s), shape), want)
    _assert_same(C.densify_topk(idx, q, s, shape, xp=np), want)
    _assert_same(C.densify_topk(torch.from_numpy(idx), torch.from_numpy(q),
                                torch.from_numpy(s), shape), want)


def test_unknown_namespace_is_refused():
    with pytest.raises(TypeError, match="xp"):
        C.quantize_int8(np.ones(3, np.float32), xp=jnp)


def test_compression_module_has_no_jax_import_line():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    text = (SRC / "repro_torch" / "dist" / "compression.py").read_text()
    bad = [ln for ln in text.splitlines() if pat.match(ln)]
    assert not bad, bad
