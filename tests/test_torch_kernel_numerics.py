"""The arithmetic of the port's tensor-core kernels, checked on the CPU.

``csrc/wkv6.cu`` and the bf16 entry of ``csrc/flash_attn_fwd.cu`` compute
their functions in another arithmetic than the plain versions: the WKV
kernel factors the decay at sub-block reference points and splits every
f32 operand of a TF32 product into hi + lo; the flash kernel rounds P to
bf16 before P @ V.  ``wkv6.ref.chunked_tc`` and
``flash_attn.ref.attention_tc_ref`` follow those kernels step by step in
plain PyTorch; here they are held against the JAX package (its exact
recurrence, its chunked form and its Pallas kernels in interpret mode) on
inputs made from a numpy seed.  The kernels themselves are held against
these functions' plain counterparts on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.flash_attn import flash_fwd_pallas
from repro.kernels.wkv6.ops import wkv as ref_wkv
from repro.models import linear_attn as ref_la
from repro.models.attention import _flash_impl
from repro_torch.kernels.flash_attn.ref import attention_tc_ref
from repro_torch.kernels.wkv6 import ref as wkv_ref_mod
from repro_torch.kernels.wkv6.ref import chunked_tc
from test_torch_common import assert_within_bf16_ulp

# The kernel's own tolerance on the card (tests/test_torch_cuda.py): f32
# sums in another order, and TF32 products of split operands (~2^-21
# relative each).  chunked_tc lands near 1e-6 of max |o| here.
WKV_REL = 1e-4


def _wkv_inputs(B, T, H, dk, dv, seed, scalar, use_u, s0, w_scale=0.5,
                w_shift=-1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    d = {"r": f(B, T, H, dk) * 0.5, "k": f(B, T, H, dk) * 0.5,
         "v": f(B, T, H, dv),
         "w_log": -np.exp(f(B, T, H, 1 if scalar else dk) * w_scale
                          + w_shift).astype(np.float32),
         "u": f(H, dk) * 0.3 if use_u else None,
         "s0": f(B, H, dk, dv) * 0.2 if s0 else None}
    return d


def _torch(d):
    return {k: None if x is None else torch.from_numpy(x)
            for k, x in d.items()}


def _jax(d):
    return {k: None if x is None else jnp.asarray(x) for k, x in d.items()}


def _close_rel(got, want, rel=WKV_REL):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max())


WKV_CASES = [  # B, T, H, dk, dv, chunk, use_u, per-head decay
    (1, 128, 2, 16, 16, 64, True, False),    # RWKV6 form: 4 sub-blocks
    (1, 128, 2, 16, 16, 64, False, True),    # SSD form with a per-head decay
    (2, 96, 2, 8, 8, 32, True, True),        # u with a per-head decay
    (1, 64, 2, 64, 64, 64, True, False),     # RWKV6-7B's head widths
    (1, 48, 1, 4, 8, 48, False, False),      # SSD, per-channel, 3 sub-blocks
]


@pytest.mark.parametrize("B,T,H,dk,dv,chunk,use_u,scalar", WKV_CASES)
def test_wkv_kernel_algorithm_matches_jax(B, T, H, dk, dv, chunk, use_u,
                                          scalar):
    d = _wkv_inputs(B, T, H, dk, dv, T * 7 + dk, scalar, use_u, False)
    got = chunked_tc(**_torch(d), chunk=chunk)
    j = _jax(d)
    _close_rel(got, ref_la.recurrent(**j))
    _close_rel(got, ref_la.chunked(**j, chunk=chunk))
    _close_rel(got, ref_wkv(**j, chunk=chunk, force="pallas"))


@pytest.mark.parametrize("use_u,scalar", [(True, False), (False, True)])
def test_wkv_kernel_algorithm_ragged_t_with_s0(use_u, scalar):
    """T = 100 with chunks of 32: the last chunk is padded (k = 0, w = 0)
    and a given s0 enters the first chunk.  The reference's Pallas kernel
    takes only T % chunk == 0, so it is held against the recurrence and
    the chunked form."""
    d = _wkv_inputs(2, 100, 2, 16, 8, 5, scalar, use_u, True)
    got = chunked_tc(**_torch(d), chunk=32)
    j = _jax(d)
    _close_rel(got, ref_la.recurrent(**j))
    _close_rel(got, ref_la.chunked(**j, chunk=32))


@pytest.mark.parametrize("use_u,scalar", [(True, False), (False, True)])
def test_wkv_kernel_algorithm_strong_decay(use_u, scalar):
    """w about -5 a step: exp(-cum) alone overflows f32 within one chunk
    (so would r exp(base) @ (k exp(-cum))^T), but every factor the kernel
    forms has an exponent <= 0, so the outputs are finite and agree."""
    d = _wkv_inputs(1, 128, 2, 16, 16, 11, scalar, use_u, False,
                    w_scale=0.02, w_shift=float(np.log(5.0)))
    w = np.broadcast_to(d["w_log"], d["r"].shape)[:, :64]
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(-np.cumsum(w, axis=1))).any()
    got = chunked_tc(**_torch(d), chunk=64)
    assert all(torch.isfinite(t).all() for t in got)
    j = _jax(d)
    _close_rel(got, ref_la.recurrent(**j))
    _close_rel(got, ref_wkv(**j, chunk=64, force="pallas"))


@pytest.mark.parametrize("scalar", [False, True])
def test_wkv_split_products_are_what_meets_the_tolerance(monkeypatch,
                                                         scalar):
    """At RWKV6-7B's head widths a single TF32 product of the decayed
    operands misses 1e-4 * max|o| (about 4e-4 here); the hi/lo split
    meets it with two orders of magnitude to spare."""
    d = _wkv_inputs(1, 256, 2, 64, 64, 3, scalar, True, False, w_shift=-1.5)
    want = ref_la.recurrent(**_jax(d))[0]
    err = lambda o: float(np.abs(o.numpy() - np.asarray(want)).max()
                          / np.abs(np.asarray(want)).max())
    split_err = err(chunked_tc(**_torch(d), chunk=64)[0])
    monkeypatch.setattr(wkv_ref_mod, "split_mm",
                        lambda a, b: wkv_ref_mod.tf32(a) @ wkv_ref_mod.tf32(b))
    tf32_err = err(chunked_tc(**_torch(d), chunk=64)[0])
    assert split_err < WKV_REL / 20 and tf32_err > WKV_REL, \
        (split_err, tf32_err)


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0e-39, float("inf")])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 3.0e-39, float("inf")])
    got = wkv_ref_mod.tf32(x)
    assert torch.equal(got[:4], want[:4]) and torch.isinf(got[5])
    assert abs(float(got[4]) - 3.0e-39) <= 2.0 ** -136   # subnormal: 10 bits


# --------------------------------------------------------------------------
# flash forward, bf16 P
# --------------------------------------------------------------------------

FLASH_CASES = [  # B, S, H, Kv, hd, window, q_offset
    (1, 128, 4, 2, 64, None, 0),
    (1, 128, 2, 1, 128, None, 0),
    (1, 96, 4, 2, 64, 40, 0),
    (1, 64, 2, 2, 128, 48, 64),
]


def _bf16_qkv(B, Sq, Sk, H, Kv, hd, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).bfloat16()
    return mk(B, Sq, H, hd), mk(B, Sk, Kv, hd), mk(B, Sk, Kv, hd)


def _pallas_o(q, k, v, window, q_offset):
    """flash_fwd_pallas in interpret mode on (B*H, S, hd), kv heads
    broadcast to q heads.  It has no q offset: q is preceded by q_offset
    zero rows, whose outputs are dropped."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    qj = jnp.pad(to_j(q), ((0, 0), (q_offset, 0), (0, 0), (0, 0)))
    kj, vj = (jnp.repeat(to_j(t), G, axis=2) for t in (k, v))
    bh = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], hd)
    o = flash_fwd_pallas(bh(qj), bh(kj), bh(vj), causal=True, window=window,
                         interpret=True)
    o = o.reshape(B, H, q_offset + Sq, hd).transpose(0, 2, 1, 3)
    return np.asarray(o[:, q_offset:].astype(jnp.float32))


@pytest.mark.parametrize("B,S,H,Kv,hd,window,q_offset", FLASH_CASES)
def test_flash_bf16_p_matches_pallas_and_reference(B, S, H, Kv, hd, window,
                                                   q_offset):
    """bf16 inputs.  Against the Pallas kernel, which keeps P in f32: the
    kernel's o tolerance on the card, 2e-2 (P rounded to bf16 moves o by
    about 2^-9 |o|, and o is rounded to bf16).  Against the reference's
    own flash (_flash_impl) with the kernel's 64-key tiles, which also
    rounds P (relative to the running max, so the tiles must agree) to
    bf16 before P @ V: one bf16 ulp of o, and the row lse within 2e-5 (f32
    scores of exact bf16 products, summed in another order)."""
    Sk = q_offset + S
    q, k, v = _bf16_qkv(B, S, Sk, H, Kv, hd, seed=S + hd)
    o, lse = attention_tc_ref(q, k, v, True, window, q_offset)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               _pallas_o(q, k, v, window, q_offset),
                               rtol=0, atol=2e-2)
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    o_j, lse_j = _flash_impl(to_j(q), to_j(k), to_j(v), True, window, 32, 64,
                             q_offset, 0)
    assert_within_bf16_ulp(o.float().numpy(),
                           np.asarray(o_j.astype(jnp.float32)), 1)
    lse_j = np.asarray(lse_j)
    _, nq, K, G, Cq = lse_j.shape
    lse_j = lse_j.transpose(0, 2, 3, 1, 4).reshape(B, H, nq * Cq)[:, :, :S]
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0, atol=2e-5)
