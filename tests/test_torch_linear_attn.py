"""The port's decayed linear attention (RWKV6 WKV / SSD scan) against the
JAX package: the recurrent and chunked forms, ``linear_attention``, the
``wkv``/``ssm_scan`` ops on the CPU (their plain version) against the
reference's Pallas kernel in interpret mode, and the ``WKV`` Function's
gradients against ``jax.grad`` of the reference's chunked form.  Inputs
are made from a numpy seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as ref_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_ref as ref_ssm_ref
from repro.kernels.wkv6.ops import wkv as ref_wkv
from repro.kernels.wkv6.ref import wkv_ref as ref_wkv_ref
from repro.models import layers as ref_layers
from repro.models import linear_attn as ref_la
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_ref
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv_ref
from repro_torch.models import layers
from repro_torch.models import linear_attn as la

# f32 sums in another order than the reference's: the chunked and
# recurrent forms agree to ~1e-6 relative; 3e-4 is the reference's own
# kernel-test tolerance (tests/test_kernels.py)
TOL = dict(rtol=3e-4, atol=3e-4)


def _inputs(B, T, H, dk, dv, seed, scalar=False, s0=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = -np.exp(f(B, T, H, 1 if scalar else dk) * 0.5)
    d = {"r": f(B, T, H, dk) * 0.5, "k": f(B, T, H, dk) * 0.5,
         "v": f(B, T, H, dv), "w_log": w, "u": f(H, dk) * 0.3}
    d["s0"] = f(B, H, dk, dv) * 0.2 if s0 else None
    return d


def _torch(d):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in d.items()}


def _jax(d):
    return {k: None if v is None else jnp.asarray(v) for k, v in d.items()}


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **(tol or TOL))


FORMS = [  # B, T, H, dk, dv, chunk: multiples of the chunk and ragged
    (2, 32, 3, 8, 16, 8), (1, 48, 2, 16, 16, 16), (2, 30, 2, 4, 8, 8),
    (1, 21, 1, 8, 4, 16), (1, 5, 2, 4, 4, 8),
]


@pytest.mark.parametrize("s0", [False, True])
@pytest.mark.parametrize("use_u,scalar", [(True, False), (False, True)])
@pytest.mark.parametrize("B,T,H,dk,dv,chunk", FORMS)
def test_forms_match_reference(B, T, H, dk, dv, chunk, use_u, scalar, s0):
    d = _inputs(B, T, H, dk, dv, seed=T * 7 + dk, scalar=scalar, s0=s0)
    if not use_u:
        d["u"] = None
    t, j = _torch(d), _jax(d)
    want_rec = ref_la.recurrent(**j)
    want_chk = ref_la.chunked(**j, chunk=chunk)
    _close(la.recurrent(**t), want_rec)
    _close(la.chunked(**t, chunk=chunk), want_chk)
    o, sf = la.linear_attention(**t, chunk=chunk)
    _close((o, sf), want_chk)
    assert o.dtype == torch.float32 and sf.shape == (B, H, dk, dv)
    _close(la.linear_attention(**t, chunk=chunk, impl="recurrent"), want_rec)


@pytest.mark.parametrize("B,T,H,dk,dv,chunk", [
    (2, 32, 3, 8, 16, 8), (1, 64, 2, 16, 16, 16), (1, 16, 1, 4, 4, 4),
])
def test_wkv_op_matches_pallas_interpret_and_oracle(B, T, H, dk, dv, chunk):
    d = _inputs(B, T, H, dk, dv, seed=T)
    t, j = _torch(d), _jax(d)
    got = wkv_ops.wkv(**t, chunk=chunk)
    _close(got, ref_wkv(**j, chunk=chunk, force="pallas"))
    _close(got, ref_wkv_ref(**j))
    _close(wkv_ref(**t), ref_wkv_ref(**j))


def test_wkv_op_state_continuation():
    d = _torch(_inputs(1, 32, 2, 8, 8, seed=3))
    half = {k: v[:, :16] if v is not None and v.dim() == 4 else v
            for k, v in d.items()}
    rest = {k: v[:, 16:] if v is not None and v.dim() == 4 else v
            for k, v in d.items()}
    _, s_half = wkv_ops.wkv(**half, chunk=8)
    o2, s2 = wkv_ops.wkv(**{**rest, "s0": s_half}, chunk=8)
    o_ref, s_ref = wkv_ref(**d)
    _close((o2, s2), (o_ref[:, 16:], s_ref))


def test_wkv_op_keeps_the_value_dtype():
    d = _torch(_inputs(1, 16, 2, 4, 8, seed=4))
    d = {**d, "v": d["v"].bfloat16()}
    o, sf = wkv_ops.wkv(**d, chunk=8)
    assert o.dtype == torch.bfloat16 and sf.dtype == torch.float32
    o32, _ = wkv_ops.wkv_f32(**d, chunk=8)
    assert o32.dtype == torch.float32
    assert torch.equal(o, o32.bfloat16())


@pytest.mark.parametrize("B,T,H,N,hd", [(2, 32, 3, 8, 16), (1, 24, 2, 4, 8),
                                        (1, 20, 2, 4, 8)])
def test_ssm_scan_matches_pallas_interpret_and_oracle(B, T, H, N, hd):
    d = _inputs(B, T, H, N, hd, seed=7, scalar=True)
    args = ("r", "k", "v", "w_log")
    t, j = _torch(d), _jax(d)
    got = ssm_scan(*(t[a] for a in args), chunk=8)
    _close(got, ref_ssm_ref(*(j[a] for a in args)))
    _close(ssm_ref(*(t[a] for a in args)), ref_ssm_ref(*(j[a] for a in args)))
    if T % 8 == 0:          # the reference's Pallas path takes T % chunk == 0
        _close(got, ref_ssm_scan(*(j[a] for a in args), chunk=8,
                                 force="pallas"))


def test_wkv_op_rejects_bad_shapes():
    d = _torch(_inputs(1, 8, 2, 4, 4, seed=0))
    with pytest.raises(ValueError):
        wkv_ops.wkv(d["r"], d["k"], d["v"], d["w_log"][..., :2])
    with pytest.raises(ValueError):
        wkv_ops.wkv(d["r"], d["k"], d["v"], d["w_log"], u=d["u"][:1])
    with pytest.raises(ValueError):
        wkv_ops.wkv(d["r"], d["k"][:, :4], d["v"], d["w_log"])


# The backward recomputes in f32 what jax.grad differentiates in f32;
# both sum in their own orders, so the gradients agree to ~1e-5 relative
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("s0", [False, True])
@pytest.mark.parametrize("use_u,scalar", [(True, False), (False, True)])
@pytest.mark.parametrize("B,T,H,dk,dv,chunk", [
    (2, 32, 2, 8, 16, 8), (1, 30, 2, 4, 8, 8), (1, 12, 1, 8, 4, 16)])
def test_wkv_function_grads_match_reference(B, T, H, dk, dv, chunk, use_u,
                                            scalar, s0):
    d = _inputs(B, T, H, dk, dv, seed=T + dv, scalar=scalar, s0=s0)
    if not use_u:
        d["u"] = None
    rng = np.random.default_rng(99)
    go = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    gs = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    names = [n for n in ("r", "k", "v", "w_log", "u", "s0")
             if d[n] is not None]

    def ref_obj(*xs):
        kw = {**_jax(d), **dict(zip(names, xs))}
        o, sf = ref_la.chunked(**kw, chunk=chunk)
        return jnp.sum(o * go) + jnp.sum(sf * gs)
    want = jax.grad(ref_obj, argnums=tuple(range(len(names))))(
        *(jnp.asarray(d[n]) for n in names))

    t = {n: (torch.from_numpy(d[n]).requires_grad_() if d[n] is not None
             else None) for n in d}
    o, sf = la.WKV.apply(t["r"], t["k"], t["v"], t["w_log"], t["u"],
                         t["s0"], chunk)
    ((o * torch.from_numpy(go)).sum() + (sf * torch.from_numpy(gs)).sum()) \
        .backward()
    for n, w in zip(names, want):
        np.testing.assert_allclose(t[n].grad.numpy(), np.asarray(w),
                                   err_msg=n, **GRAD_TOL)


def test_wkv_function_grads_are_finite_under_strong_decay():
    """Decays near the model's clip (w_log = -exp(6)) make the masked
    upper-triangle differences huge; the gradient stays finite."""
    d = _torch(_inputs(1, 16, 1, 4, 4, seed=5))
    w = torch.full((1, 16, 1, 4), -float(np.exp(6.0)), requires_grad=True)
    r = d["r"].requires_grad_()
    o, _ = la.linear_attention(r, d["k"], d["v"], w, u=d["u"], chunk=8)
    o.sum().backward()
    assert torch.isfinite(r.grad).all() and torch.isfinite(w.grad).all()


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), 1e-5)
    want = ref_layers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    decl = layers.layernorm_decl(64)
    assert set(decl) == {"scale", "bias"}
    assert decl["scale"].init == "ones" and decl["bias"].init == "zeros"
