"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; that version is
held against the Pallas kernel in interpret mode and against the
reference's own plain functions.  The CUDA kernels themselves are held
against their plain versions on a card by tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedavg.ops import fedavg as ref_fedavg
from repro.kernels.fedavg.ref import fedavg_ref as jax_fedavg_ref
from repro.kernels.fedavg.ref import fedavg_tree_ref as jax_fedavg_tree_ref
from repro.kernels.flash_attn.ops import flash as ref_flash
from repro.models.attention import _flash_impl
from repro.models.attention import flash_attention as ref_flash_attention
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.ref import fedavg_ref, fedavg_tree_ref
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models.attention import flash_attention
from test_torch_common import assert_within_bf16_ulp

F32_TOL = dict(rtol=1e-6, atol=1e-6)   # f32 rounding of a K-term sum

FEDAVG_CASES = [
    (4, 512, "float32"), (16, 1000, "float32"), (8, 4096, "bfloat16"),
    (2, 63, "float32"), (5, 70000, "bfloat16"),
    (3, 12345, "bfloat16"),             # ragged: not a multiple of 8
]


def _fedavg_inputs(K, N, dtype, seed=0):
    rng = np.random.default_rng(K * 100003 + N + seed)
    x = rng.standard_normal((K, N)).astype(np.float32)
    w = (rng.uniform(size=K) + 0.1).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    x_np = np.array(xj.astype(jnp.float32))        # exact bf16 values
    xt = torch.from_numpy(x_np).to(getattr(torch, dtype))
    return xj, jnp.asarray(w), xt, torch.from_numpy(w)


def _assert_fedavg_close(got_t, want, dtype):
    got = got_t.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        assert_within_bf16_ulp(got, want, 1)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("K,N,dtype", FEDAVG_CASES)
def test_fedavg_matches_pallas_interpret(K, N, dtype):
    xj, wj, xt, wt = _fedavg_inputs(K, N, dtype)
    got = fedavg_ops.fedavg(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (N,)
    _assert_fedavg_close(got, ref_fedavg(xj, wj, force="pallas"), dtype)


@pytest.mark.parametrize("K,N,dtype", FEDAVG_CASES)
def test_fedavg_matches_reference_oracles(K, N, dtype):
    xj, wj, xt, wt = _fedavg_inputs(K, N, dtype)
    _assert_fedavg_close(fedavg_ref(xt, wt), jax_fedavg_ref(xj, wj), dtype)
    groups = [tuple(range(0, K, 2)), tuple(range(1, K, 2))] if K > 1 \
        else [(0,)]
    _assert_fedavg_close(fedavg_tree_ref(xt, wt, groups),
                         jax_fedavg_tree_ref(xj, wj, groups), dtype)


def test_fedavg_pytree_and_zero_weight_row():
    rng = np.random.default_rng(3)
    bank = {"a": torch.from_numpy(rng.standard_normal((4, 3, 5)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.standard_normal((4, 7)).astype(np.float32))}}
    w = torch.tensor([1.0, 2.0, 3.0, 0.0])
    out = fedavg_ops.fedavg_pytree(bank, w)
    assert out["a"].shape == (3, 5) and out["b"]["c"].shape == (7,)
    bank["a"][3] += 100.0                 # a dead row changes nothing
    again = fedavg_ops.fedavg_pytree(bank, w)
    assert torch.equal(out["a"], again["a"])


def test_kernel_wrappers_raise_off_cpu_without_a_card(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: a
    meta tensor (the dry run's) gets the kernel's outputs and launches
    nothing, and any other must lie on a CUDA card, which the kernel path
    checks first (``_build.check_device``)."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(fedavg_ops, "fedavg_ref", plain)
    monkeypatch.setattr(flash_ops, "attention_ref", plain)
    before = (fedavg_ops.launches, flash_ops.launches)
    x = torch.zeros((2, 8), device="meta")
    out = fedavg_ops.fedavg(x, torch.ones(2, device="meta"))
    assert out.shape == (8,) and out.device.type == "meta"
    q = torch.zeros((1, 8, 2, 4), device="meta")
    o, lse = flash_ops.flash_fwd(q, q, q)
    assert o.shape == q.shape and o.device.type == "meta"
    assert lse.shape == (1, 2, 8) and lse.dtype == torch.float32
    assert (fedavg_ops.launches, flash_ops.launches) == before
    with pytest.raises(RuntimeError, match="not on a CUDA card"):
        _build.check_device(x, "fedavg")


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

FLASH_TOL = dict(rtol=1e-5, atol=1e-5)

FLASH_CASES = [  # (H, Kv, causal, window)
    (4, 4, True, None), (4, 4, True, 32), (4, 2, True, None),
    (4, 2, False, None), (4, 2, True, 48),
]


def _qkv(B, Sq, Sk, H, Kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Kv, hd)).astype(np.float32)
    return q, k, v


def _ref_lse(lse, B, H, Sq):
    """Reference _flash_impl lse (B,nq,K,G,Cq) -> (B,H,Sq)."""
    lse = np.asarray(lse)
    _, nq, K, G, Cq = lse.shape
    return lse.transpose(0, 2, 3, 1, 4).reshape(B, H, nq * Cq)[:, :, :Sq]


@pytest.mark.parametrize("H,Kv,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret_and_lse(H, Kv, causal, window):
    B, S, hd = 2, 128, 16
    q, k, v = _qkv(B, S, S, H, Kv, hd, seed=H + Kv)
    o, lse = flash_ops.flash_fwd(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window)
    want_o = ref_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                       window=window, force="pallas")
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **FLASH_TOL)
    want_o2, want_lse = _flash_impl(*map(jnp.asarray, (q, k, v)), causal,
                                    window, 32, 32, 0, 0)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o2), **FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(want_lse, B, H, S),
                               **FLASH_TOL)


@pytest.mark.parametrize("q_offset,window", [(64, None), (96, 40)])
def test_flash_q_offset_matches_reference(q_offset, window):
    B, Sq, Sk, H, Kv, hd = 1, 64, 160, 4, 2, 16
    q, k, v = _qkv(B, Sq, Sk, H, Kv, hd, seed=q_offset)
    o, lse = attention_ref(*map(torch.from_numpy, (q, k, v)), True, window,
                           q_offset=q_offset)
    want = ref_flash_attention(*map(jnp.asarray, (q, k, v)), True, window,
                               16, 32, q_offset, 0)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **FLASH_TOL)
    _, want_lse = _flash_impl(*map(jnp.asarray, (q, k, v)), True, window,
                              16, 32, q_offset, 0)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(want_lse, B, H, Sq),
                               **FLASH_TOL)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_gradients_match_reference_custom_vjp(window):
    """The port's autograd.Function (plain forward here, recomputing
    backward) against jax.grad through the reference custom_vjp."""
    B, S, H, Kv, hd = 1, 96, 4, 2, 16
    q, k, v = _qkv(B, S, S, H, Kv, hd, seed=7)
    rng = np.random.default_rng(8)
    cot = rng.standard_normal((B, S, H, hd)).astype(np.float32)

    def ref_loss(q, k, v):
        o = ref_flash_attention(q, k, v, True, window, 16, 32)
        return jnp.sum(o * cot)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(qt, kt, vt, True, window, chunk_k=32)
    (o * torch.from_numpy(cot)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
