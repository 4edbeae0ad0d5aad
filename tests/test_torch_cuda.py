"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

Needs a CUDA card (Hopper, sm_90a) and nvcc; every test skips without a
card.  The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.ref import fedavg_ref
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models.attention import flash_attention, full_attention

pytestmark = pytest.mark.cuda

FEDAVG_CASES = [
    (4, 512, torch.float32), (16, 1000, torch.float32),
    (8, 4096, torch.bfloat16), (2, 63, torch.float32),
    (5, 70000, torch.bfloat16), (3, 12345, torch.bfloat16),
    (64, 4099, torch.float32),
]
FLASH_CASES = [  # (H, Kv, causal, window)
    (4, 4, True, None), (4, 4, True, 32), (4, 2, True, None),
    (4, 2, False, None), (4, 2, True, 48),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): kernel vs plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev, dtype)


@pytest.mark.parametrize("K,N,dtype", FEDAVG_CASES)
def test_fedavg_kernel_is_bit_exact_with_plain(card, K, N, dtype):
    rng = np.random.default_rng(K * 7 + N)
    x = _normal(rng, (K, N), dtype, card)
    w = torch.from_numpy((rng.uniform(size=K) + 0.1).astype(np.float32)) \
        .to(card)
    before = fedavg_ops.launches
    got = fedavg_ops.fedavg(x, w)
    assert fedavg_ops.launches == before + 1
    # same summation order, no FMA contraction: bit-exact
    assert torch.equal(got, fedavg_ref(x, w))


def test_fedavg_kernel_rejects_what_it_does_not_take(card):
    w = torch.ones(2, device=card)
    with pytest.raises(TypeError):
        fedavg_ops.fedavg(torch.zeros((2, 8), device=card,
                                      dtype=torch.float16), w)
    with pytest.raises(ValueError):
        fedavg_ops.fedavg(torch.zeros((8, 2), device=card).t(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Kv,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(card, dtype, H, Kv, causal, window):
    rng = np.random.default_rng(H * 10 + Kv)
    B, S, hd = 2, 200, 64
    q = _normal(rng, (B, S, H, hd), dtype, card)
    k = _normal(rng, (B, S, Kv, hd), dtype, card)
    v = _normal(rng, (B, S, Kv, hd), dtype, card)
    before = flash_ops.launches
    o, lse = flash_ops.flash_fwd(q, k, v, causal, window)
    assert flash_ops.launches == before + 1
    o_ref, lse_ref = attention_ref(q, k, v, causal, window)
    # f32: summation order only; bf16 o: one bf16 ulp below 2
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("q_offset,window", [(128, None), (100, 40)])
def test_flash_kernel_offsets_match_plain(card, q_offset, window):
    rng = np.random.default_rng(q_offset)
    q = _normal(rng, (1, 64, 4, 128), torch.float32, card)
    k = _normal(rng, (1, 192, 2, 128), torch.float32, card)
    v = _normal(rng, (1, 192, 2, 128), torch.float32, card)
    o, lse = flash_ops.flash_fwd(q, k, v, True, window, q_offset)
    o_ref, lse_ref = attention_ref(q, k, v, True, window, q_offset)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=2e-5)


def test_flash_gradient_matches_full_attention(card):
    rng = np.random.default_rng(2)
    B, S, H, Kv, hd = 1, 256, 4, 2, 64
    q = _normal(rng, (B, S, H, hd), torch.float32, card).requires_grad_()
    k = _normal(rng, (B, S, Kv, hd), torch.float32, card).requires_grad_()
    v = _normal(rng, (B, S, Kv, hd), torch.float32, card).requires_grad_()
    cot = _normal(rng, (B, S, H, hd), torch.float32, card)
    pos = torch.arange(S, device=card)
    grads = []
    for fn in (lambda: flash_attention(q, k, v, True, None, 64),
               lambda: full_attention(q, k, v, pos, pos, causal=True)):
        q.grad = k.grad = v.grad = None
        (fn() * cot).sum().backward()
        grads.append([t.grad.clone() for t in (q, k, v)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
