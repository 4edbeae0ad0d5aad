"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

Needs a CUDA card (Hopper, sm_90a) and nvcc; every test skips without a
card.  The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.api.strategies import get_strategy, list_strategies
from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import aggregation
from repro_torch.core.topology import AggSchedule
from repro_torch.dist.sharding import materialize
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.ref import fedavg_ref, qagg_ref
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.kernels.quant8 import ops as quant8_ops
from repro_torch.kernels.quant8.ref import dequantize_ref, quantize_ref
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import chunked as wkv_chunked
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models.attention import flash_attention, full_attention
from repro_torch.models import moe
from repro_torch.models.linear_attn import linear_attention

pytestmark = pytest.mark.cuda

FEDAVG_CASES = [
    (4, 512, torch.float32), (16, 1000, torch.float32),
    (8, 4096, torch.bfloat16), (2, 63, torch.float32),
    (5, 70000, torch.bfloat16), (3, 12345, torch.bfloat16),
    (64, 4099, torch.float32),
]
QAGG_CASES = [  # (K, R, G): vector path (G % 16 == 0) and scalar path
    (4, 64, 256), (3, 33, 7), (8, 1, 1024), (1, 5, 5), (2, 128, 128),
    (4, 1, 1), (4, 37, 18944), (5, 1000, 3584), (4, 300, 48),
]
QUANT8_CASES = [65536, 1000, 70001, 3 * 65536 + 17]
WKV_CASES = [  # (B, T, H, dk, dv, chunk, use_u, scalar decay, s0)
    (1, 256, 4, 64, 64, 128, True, False, False),   # rwkv6 widths
    (1, 256, 3, 16, 64, 128, False, True, False),   # hymba SSD widths
    (2, 200, 3, 4, 8, 64, True, False, True),       # ragged T, s0
    (2, 200, 3, 4, 8, 64, False, True, True),
    (1, 77, 2, 16, 128, 32, True, False, True),     # two value tiles
    (2, 5, 1, 8, 4, 64, False, False, False),       # T < chunk
    (1, 96, 2, 33, 17, 16, True, True, False),      # odd widths
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


@pytest.mark.parametrize("K,R,G", QAGG_CASES)
def test_qagg_kernel_is_bit_exact_with_plain(card, K, R, G):
    rng = np.random.default_rng(K * 31 + R * 7 + G)
    q = torch.from_numpy(rng.integers(-127, 128, (K, R, G)).astype(np.int8)) \
        .to(card)
    s = torch.from_numpy(rng.uniform(0.5, 2.0, (K, R, 1)).astype(np.float32)
                         / 127).to(card)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, K).astype(np.float32)).to(card)
    before = fedavg_ops.qagg_launches
    got = fedavg_ops.qagg(q, s, w)
    assert fedavg_ops.qagg_launches == before + 1
    # same summation order, no FMA contraction: bit-exact
    assert torch.equal(got, qagg_ref(q, s, w))


def test_qagg_kernel_takes_leaf_shapes(card):
    rng = np.random.default_rng(0)
    for shape in [(4,), (4, 9), (4, 2, 3, 32)]:
        q = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)) \
            .to(card)
        s = torch.rand(shape[:-1] + (1,) if len(shape) > 1 else (4, 1),
                       device=card)
        w = torch.ones(4, device=card)
        got = fedavg_ops.qagg(q, s, w)
        assert tuple(got.shape) == shape[1:]
        G = shape[-1] if len(shape) > 1 else 1
        want = qagg_ref(q.reshape(4, -1, G), s.reshape(4, -1, 1), w)
        assert torch.equal(got.reshape(-1, G), want)
    with pytest.raises(TypeError):
        fedavg_ops.qagg(q.float(), s, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", QUANT8_CASES)
def test_quant8_kernels_are_bit_exact_with_plain(card, n, dtype):
    rng = np.random.default_rng(n)
    x = (_normal(rng, (n,), torch.float32, card)
         * torch.from_numpy(rng.uniform(0.01, 10, n).astype(np.float32))
         .to(card)).to(dtype)
    x[:256] = 0                          # an all-zero block
    qb, db = quant8_ops.quantize_launches, quant8_ops.dequantize_launches
    q, s, got_n = quant8_ops.quantize(x)
    assert quant8_ops.quantize_launches == qb + 1 and got_n == n
    rows = quant8_ops._to_rows(x.reshape(-1))
    want_q, want_s = quantize_ref(rows.reshape(-1))
    assert torch.equal(q.reshape(-1), want_q)
    assert torch.equal(s, want_s)
    out = quant8_ops.dequantize(q, s, n)
    assert quant8_ops.dequantize_launches == db + 1
    assert torch.equal(out, dequantize_ref(q.reshape(-1), s)[:n])


def test_quant8_kernel_nan_and_inf_blocks_match_plain(card):
    x = torch.randn(1024, device=card)
    x[3], x[260], x[600] = float("nan"), float("inf"), -float("inf")
    q, s, _ = quant8_ops.quantize(x)
    want_q, want_s = quantize_ref(quant8_ops._to_rows(x).reshape(-1))
    assert torch.equal(q.reshape(-1), want_q)
    assert torch.isnan(s[0]) and torch.isinf(s[1]) and torch.isinf(s[2])
    assert torch.equal(s[1:], want_s[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compressed_schedule_on_card_matches_cpu(card, dtype):
    """The card's compressed aggregation (plain quantize + qagg kernel)
    equals the CPU's (plain quantize + plain qagg) bit for bit."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 12, 3584), "b": (4, 7), "c": (4,), "d": (4, 3, 5, 48)}
    bank = {k: torch.from_numpy(rng.standard_normal(v).astype(np.float32))
            .to(dtype) for k, v in shapes.items()}
    w = torch.tensor([0.7, 0.1, 0.3, 0.0])
    on_card = {k: v.to(card) for k, v in bank.items()}
    before = (fedavg_ops.qagg_launches, fedavg_ops.launches)
    aggregation.aggregate_params(on_card, w.to(card),
                                 AggSchedule("compressed", 4))
    assert fedavg_ops.qagg_launches == before[0] + len(shapes)
    assert fedavg_ops.launches == before[1]
    aggregation.aggregate_params(bank, w, AggSchedule("compressed", 4))
    for k in shapes:
        assert torch.equal(on_card[k].cpu(), bank[k]), k


def _wkv_inputs(rng, B, T, H, dk, dv, use_u, scalar, s0, dtype, dev):
    w = -torch.exp(_normal(rng, (B, T, H, 1 if scalar else dk),
                           torch.float32, dev) * 0.5 - 1.0)
    return dict(
        r=_normal(rng, (B, T, H, dk), dtype, dev) * 0.5,
        k=_normal(rng, (B, T, H, dk), dtype, dev) * 0.5,
        v=_normal(rng, (B, T, H, dv), dtype, dev), w_log=w,
        u=_normal(rng, (H, dk), torch.float32, dev) * 0.3 if use_u else None,
        s0=_normal(rng, (B, H, dk, dv), torch.float32, dev) * 0.2
        if s0 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,dk,dv,chunk,use_u,scalar,s0", WKV_CASES)
def test_wkv_kernel_matches_plain(card, dtype, B, T, H, dk, dv, chunk,
                                  use_u, scalar, s0):
    rng = np.random.default_rng(T * 3 + dk)
    x = _wkv_inputs(rng, B, T, H, dk, dv, use_u, scalar, s0, dtype, card)
    counter = "launches_u" if use_u else "launches_ssd"
    before = (wkv_ops.launches_u, wkv_ops.launches_ssd)
    o, sf = wkv_ops.wkv_f32(**x, chunk=chunk)
    after = (wkv_ops.launches_u, wkv_ops.launches_ssd)
    assert [a - b for a, b in zip(after, before)] == \
        ([1, 0] if use_u else [0, 1]), counter
    o_ref, sf_ref = wkv_chunked(**x, chunk=chunk)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and o.shape == (B, T, H, dv)
    # both upcast the same inputs to f32 and sum in other orders
    torch.testing.assert_close(o, o_ref, rtol=0,
                               atol=1e-4 * float(o_ref.abs().max()))
    torch.testing.assert_close(sf, sf_ref, rtol=0,
                               atol=1e-4 * float(sf_ref.abs().max()))
    o_v, _ = wkv_ops.wkv(**x, chunk=chunk)
    assert o_v.dtype == dtype


def test_ssm_scan_on_card_launches_the_ssd_kernel(card):
    rng = np.random.default_rng(5)
    x = _wkv_inputs(rng, 1, 128, 5, 16, 64, False, True, False,
                    torch.bfloat16, card)
    before = wkv_ops.launches_ssd
    y, h = ssm_scan(x["r"], x["k"], x["v"], x["w_log"], chunk=64)
    assert wkv_ops.launches_ssd == before + 1
    y_ref, h_ref = wkv_chunked(x["r"], x["k"], x["v"], x["w_log"], chunk=64)
    torch.testing.assert_close(y.float(), y_ref.to(torch.bfloat16).float(),
                               rtol=0, atol=1e-2 * float(y_ref.abs().max()))
    torch.testing.assert_close(h, h_ref, rtol=0,
                               atol=1e-4 * float(h_ref.abs().max()))


@pytest.mark.parametrize("use_u", [True, False])
def test_wkv_gradient_on_card_matches_autograd_through_plain(card, use_u):
    rng = np.random.default_rng(11)
    x = _wkv_inputs(rng, 2, 100, 2, 16, 32, use_u, not use_u, True,
                    torch.float32, card)
    x = {k: None if v is None else v.requires_grad_() for k, v in x.items()}
    cot = _normal(rng, (2, 100, 2, 32), torch.float32, card)
    grads = []
    for fn in (linear_attention, wkv_chunked):
        for t in x.values():
            if t is not None:
                t.grad = None
        o, sf = fn(**x, chunk=32)
        ((o * cot).sum() + sf.sum()).backward()
        grads.append([t.grad.clone() for t in x.values() if t is not None])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def test_wkv_kernel_rejects_what_it_does_not_take(card):
    rng = np.random.default_rng(0)
    x = _wkv_inputs(rng, 1, 16, 1, 4, 4, True, False, False, torch.float16,
                    card)
    with pytest.raises(TypeError):
        wkv_ops.wkv(**x)
    x = _wkv_inputs(rng, 1, 16, 1, 72, 4, True, False, False, torch.float32,
                    card)
    with pytest.raises(ValueError):
        wkv_ops.wkv(**x)


# bf16 flash on the tensor cores: head dims that run unpadded (128), padded
# in shared memory (80 -> 128) and loaded without cp.async (20, not a
# multiple of 8); ragged Sq/Sk against the 64-key tile and the q tile;
# 128-row q tiles (a grid of at least one wave) and 64-row ones
FLASH_TC_CASES = [  # (B, Sq, Sk, H, Kv, hd, causal, window, q_offset)
    (1, 300, 300, 4, 2, 128, True, None, 0),
    (1, 300, 300, 4, 2, 80, True, None, 0),
    (2, 130, 130, 2, 2, 20, True, 40, 0),
    (1, 100, 237, 3, 1, 64, True, 50, 137),
    (1, 77, 77, 4, 1, 16, False, None, 0),
    (2, 1100, 1100, 8, 2, 64, True, 300, 0),
]


@pytest.mark.parametrize("B,Sq,Sk,H,Kv,hd,causal,window,q_offset",
                         FLASH_TC_CASES)
def test_flash_bf16_kernel_tiles_match_plain(card, B, Sq, Sk, H, Kv, hd,
                                             causal, window, q_offset):
    rng = np.random.default_rng(Sq * 7 + hd)
    q = _normal(rng, (B, Sq, H, hd), torch.bfloat16, card)
    k = _normal(rng, (B, Sk, Kv, hd), torch.bfloat16, card)
    v = _normal(rng, (B, Sk, Kv, hd), torch.bfloat16, card)
    o, lse = flash_ops.flash_fwd(q, k, v, causal, window, q_offset)
    o_ref, lse_ref = attention_ref(q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    # bf16 o: one bf16 ulp below 2; lse: f32 scores of exact bf16 products
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_offset_window_single_kv_head(card, dtype):
    rng = np.random.default_rng(3)
    q = _normal(rng, (2, 70, 4, 64), dtype, card)
    k = _normal(rng, (2, 203, 1, 64), dtype, card)
    v = _normal(rng, (2, 203, 1, 64), dtype, card)
    o, lse = flash_ops.flash_fwd(q, k, v, True, 45, 133)
    o_ref, lse_ref = attention_ref(q, k, v, True, 45, 133)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_u,scalar", [(True, False), (False, True),
                                          (True, True), (False, False)])
def test_wkv_kernel_strong_decay_is_finite_and_matches_plain(
        card, dtype, use_u, scalar):
    """w about -5 a step: exp(-cum) alone would overflow within a chunk;
    the kernel's sub-block reference points keep every exponent <= 0."""
    rng = np.random.default_rng(17)
    B, T, H, dk, dv = 1, 256, 2, 64, 64
    x = _wkv_inputs(rng, B, T, H, dk, dv, use_u, scalar, True, dtype, card)
    x["w_log"] = -5.0 + 0.1 * _normal(rng, tuple(x["w_log"].shape),
                                      torch.float32, card)
    o, sf = wkv_ops.wkv_f32(**x, chunk=128)
    o_ref, sf_ref = wkv_chunked(**x, chunk=128)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    torch.testing.assert_close(o, o_ref, rtol=0,
                               atol=1e-4 * float(o_ref.abs().max()))
    torch.testing.assert_close(sf, sf_ref, rtol=0,
                               atol=1e-4 * float(sf_ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_u", [True, False])
def test_wkv_kernel_ragged_t_full_widths_with_s0(card, dtype, use_u):
    rng = np.random.default_rng(23)
    B, T, H, dk, dv = 2, 200, 3, 64, 64
    x = _wkv_inputs(rng, B, T, H, dk, dv, use_u, not use_u, True, dtype,
                    card)
    o, sf = wkv_ops.wkv_f32(**x, chunk=64)
    o_ref, sf_ref = wkv_chunked(**x, chunk=64)
    torch.cuda.synchronize()
    assert o.shape == (B, T, H, dv)
    torch.testing.assert_close(o, o_ref, rtol=0,
                               atol=1e-4 * float(o_ref.abs().max()))
    torch.testing.assert_close(sf, sf_ref, rtol=0,
                               atol=1e-4 * float(sf_ref.abs().max()))


def test_each_op_call_adds_one_launch(card):
    """An op call counts once (the WKV op also clears its chunks' flags
    with a memset before its kernel)."""
    rng = np.random.default_rng(29)
    q = _normal(rng, (1, 128, 4, 64), torch.bfloat16, card)
    kv = _normal(rng, (1, 128, 2, 64), torch.bfloat16, card)
    before = flash_ops.launches
    flash_ops.flash_fwd(q, kv, kv, True)
    assert flash_ops.launches == before + 1
    for use_u in (True, False):
        x = _wkv_inputs(rng, 1, 256, 2, 16, 32, use_u, not use_u, False,
                        torch.bfloat16, card)
        before = (wkv_ops.launches_u, wkv_ops.launches_ssd)
        wkv_ops.wkv(**x, chunk=128)
        after = (wkv_ops.launches_u, wkv_ops.launches_ssd)
        assert [a - b for a, b in zip(after, before)] == \
            ([1, 0] if use_u else [0, 1])
    before = wkv_ops.launches_ssd
    ssm_scan(x["r"], x["k"], x["v"], x["w_log"], chunk=128)
    assert wkv_ops.launches_ssd == before + 1


COMPILED = sorted(n for n in list_strategies() if get_strategy(n).compiled)
NORM_CLIPPED = {"norm_clip", "clipped_weighted_trimmed_mean"}


@pytest.mark.parametrize("name", COMPILED)
def test_strategy_on_card_matches_cpu(card, name, monkeypatch):
    """Every compiled strategy, K = 4 with a dead row, leaves that cross
    chunks of 1000 elements: the card equals the CPU bit for bit (krum's
    rows are well separated, so the Gram's summation order does not move
    the selection); the norm clip's per-client sums of squares reduce in
    another order on the card: 4 f32 ulps of the leaf's largest magnitude,
    or one bf16 ulp of the value."""
    monkeypatch.setattr(aggregation, "CHUNK", 1000)
    rng = np.random.default_rng(31)
    K = 4
    spread = (1.0 + np.arange(K)).reshape(K, 1, 1)
    bank, ref = {}, {}
    for k, (shape, dtype) in {"a": ((K, 7, 301), torch.bfloat16),
                              "b": ((K, 3, 64), torch.float32)}.items():
        x = rng.standard_normal(shape[1:]) \
            + 0.3 * spread * rng.standard_normal(shape)
        g = x + 0.2 * spread * rng.standard_normal(shape)
        bank[k] = torch.from_numpy(x.astype(np.float32)).to(dtype)
        ref[k] = torch.from_numpy(g.astype(np.float32)).to(dtype)
    w = torch.tensor([1.0, 2.0, 0.0, 3.0])
    on_card = {k: v.to(card) for k, v in bank.items()}
    before = fedavg_ops.launches
    aggregation.aggregate_params(on_card, w.to(card), AggSchedule("tree", K),
                                 name, ref={k: v.to(card)
                                            for k, v in ref.items()})
    strat = get_strategy(name)
    want_launches = (0 if strat.reduction == "stack" else
                     3 + 1 if strat.needs_ref else 2)   # chunks, or leaves
    assert fedavg_ops.launches == before + want_launches
    aggregation.aggregate_params(bank, w, AggSchedule("tree", K), name,
                                 ref=ref)
    for k, t in bank.items():
        got = on_card[k].cpu()
        if name not in NORM_CLIPPED:
            assert torch.equal(got, t), k
            continue
        err = (got.float() - t.float()).abs()
        tol = torch.full_like(err, 4 * 2.0 ** -23 * float(t.abs().max()))
        if t.dtype == torch.bfloat16:
            tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(
                t.float().abs().clamp_min(2.0 ** -126))) - 7))
        assert bool((err <= tol).all()), (k, float(err.max()))


def test_premapped_sum_from_a_pinned_host_ref_matches_a_card_ref(card):
    """Round 0's ref is a pinned host copy, streamed in a chunk at a time."""
    rng = np.random.default_rng(37)
    bank = _normal(rng, (4, 5000), torch.bfloat16, card)
    ref = _normal(rng, (4, 5000), torch.bfloat16, card)
    w = torch.tensor([1.0, 2.0, 0.5, 3.0], device=card)
    host = torch.empty(ref.shape, dtype=ref.dtype, pin_memory=True)
    host.copy_(ref)
    a, b = {"x": bank.clone()}, {"x": bank.clone()}
    aggregation.aggregate_params(a, w, AggSchedule("tree", 4), "fedprox",
                                 ref={"x": ref})
    aggregation.aggregate_params(b, w, AggSchedule("tree", 4), "fedprox",
                                 ref={"x": host})
    assert torch.equal(a["x"], b["x"])


def test_fedavg_f32_entry_at_a_path_chunk(card):
    """fedprox's premapped contributions: an f32 (4, 2^26) chunk."""
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((4, aggregation.CHUNK), generator=gen, device=card)
    w = torch.tensor([3.0, 1.0, 0.0, 4.0], device=card)
    assert torch.equal(fedavg_ops.fedavg(x, w), fedavg_ref(x, w))


def test_resume_round_trip_on_card(card, tmp_path):
    """A checkpoint of a state on the card restores into another state on
    the card bit for bit, and a trainer resumes from it."""
    cfg = smoke_config(get_arch("qwen2-7b"))
    tr = SDFLMQTrainer(cfg, 4, 2, 2, 32, ckpt_dir=str(tmp_path),
                       strategy="fedprox", device=card)
    tr.run()
    other = SDFLMQTrainer(cfg, 4, 2, 2, 32, device=card, seed=1)
    restore_checkpoint(save_checkpoint(str(tmp_path / "copy"), tr.state),
                       other.state)
    for a, b in zip(T.leaves(tr.state), T.leaves(other.state)):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)
    again = SDFLMQTrainer(cfg, 4, 2, 2, 32, ckpt_dir=str(tmp_path),
                          device=card)
    assert again.start_round == 2
    for a, b in zip(T.leaves(tr.state), T.leaves(again.state)):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)
        if torch.is_tensor(b):
            assert b.device.type == "cuda"


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_moe_layer_on_card_matches_cpu(card, arch):
    """The MoE layer at the smoke config in f32 on the card against the
    port on the CPU: identical routing ids and dropped assignments (a
    capacity factor of 0.5 drops half), the output, the auxiliary loss and
    the gradients (f32 products in another order)."""
    cfg = smoke_config(get_arch(arch))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    p0 = materialize(moe.moe_decl(cfg), 0, "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 96, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    out = []
    for dev in ("cpu", card):
        p = T.tree_map(lambda t: t.to(dev, torch.float32).clone()
                       .requires_grad_(True), p0)
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        _, ids, _ = moe.route(p["router"], xt.reshape(-1, cfg.d_model),
                              cfg.moe.top_k)
        moe.reset_stats()
        y, aux = moe.moe_apply_dense(cfg, p, xt)
        stats = moe.read_stats()
        ((y * torch.from_numpy(cot).to(dev)).sum() + aux).backward()
        out.append((ids.cpu(), stats, y.detach().cpu(), aux.item(),
                    [t.grad.cpu() for t in T.leaves(p)] + [xt.grad.cpu()]))
    (ids0, st0, y0, a0, g0), (ids1, st1, y1, a1, g1) = out
    assert torch.equal(ids0, ids1)
    assert st0["dropped"] == st1["dropped"] > 0
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    assert abs(a1 - a0) <= 1e-6 * abs(a0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_adafactor_update_on_card_matches_cpu(card):
    """Two Adafactor updates of 1-D to 4-D f32 leaves on the card against
    the CPU: factors and parameters (means, rsqrt and the RMS in another
    order: rtol 1e-5)."""
    from repro_torch.optim import api as optim
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 64, 96), "d": (2, 3, 40, 8)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(2)]
    out = []
    for dev in ("cpu", card):
        opt = optim.adafactor(optim.warmup_cosine(1e-2, 1, 10))
        p = {k: torch.from_numpy(v.copy()).to(dev) for k, v in p0.items()}
        s = opt.init(p)
        for step, g in enumerate(gs):
            upd, s = opt.update({k: torch.from_numpy(v).to(dev)
                                 for k, v in g.items()}, s, p, step)
            optim.apply_updates(p, upd)
        out.append([t.cpu() for t in T.leaves(p) + T.leaves(s)])
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_flash_at_mixtral_shape_matches_plain(card):
    """The flash kernel at mixtral-8x22b's path shape: q (1, 2048, 48,
    128), 8 kv heads (6 q heads a kv head), window 4096 > seq."""
    rng = np.random.default_rng(6)
    q = _normal(rng, (1, 2048, 48, 128), torch.bfloat16, card)
    k = _normal(rng, (1, 2048, 8, 128), torch.bfloat16, card)
    v = _normal(rng, (1, 2048, 8, 128), torch.bfloat16, card)
    before = flash_ops.launches
    o, lse = flash_ops.flash_fwd(q, k, v, True, 4096)
    assert flash_ops.launches == before + 1
    o_ref, lse_ref = attention_ref(q, k, v, True, 4096)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=2e-5)


# --------------------------------------------------------------------------
# Serving: the kernel cases it adds, and the engine on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,dk,dv,use_u,scalar", [
    (64, 64, 64, True, False),      # rwkv6-7b's decode step
    (25, 16, 64, False, True),      # hymba-1.5b's SSM branch at decode
    (16, 64, 64, True, False),      # rwkv6-7b's on a rank of a model axis of 4
])
def test_wkv_kernel_at_t1_with_state_matches_plain(card, dtype, H, dk, dv,
                                                   use_u, scalar):
    """A decode step: T = 1, chunk 1, B = 4 and a given s0, one launch."""
    rng = np.random.default_rng(H + dk)
    x = _wkv_inputs(rng, 4, 1, H, dk, dv, use_u, scalar, True, dtype, card)
    before = wkv_ops.launches_u + wkv_ops.launches_ssd
    o, sf = wkv_ops.wkv_f32(**x, chunk=1)
    assert wkv_ops.launches_u + wkv_ops.launches_ssd == before + 1
    o_ref, sf_ref = wkv_chunked(**x, chunk=1)
    torch.cuda.synchronize()
    assert o.shape == (4, 1, H, dv) and sf.shape == (4, H, dk, dv)
    torch.testing.assert_close(o, o_ref, rtol=0,
                               atol=1e-4 * float(o_ref.abs().max()))
    torch.testing.assert_close(sf, sf_ref, rtol=0,
                               atol=1e-4 * float(sf_ref.abs().max()))


@pytest.mark.parametrize("H,Kv,hd,window", [
    (28, 4, 128, None), (25, 5, 64, 1024), (48, 8, 128, 4096),
    (7, 1, 128, None), (12, 2, 128, 4096)])
def test_flash_kernel_at_batch_4_matches_plain(card, H, Kv, hd, window):
    """Prefill's shapes: B = 4, Sq = Sk = 2048, bf16, in qwen2-7b's,
    hymba-1.5b's and mixtral-8x22b's head layouts, and a rank's heads of
    qwen2-7b and mixtral-8x22b on a model axis of 4."""
    rng = np.random.default_rng(H)
    q = _normal(rng, (4, 2048, H, hd), torch.bfloat16, card)
    k = _normal(rng, (4, 2048, Kv, hd), torch.bfloat16, card)
    v = _normal(rng, (4, 2048, Kv, hd), torch.bfloat16, card)
    o, lse = flash_ops.flash_fwd(q, k, v, True, window)
    o_ref, lse_ref = attention_ref(q, k, v, True, window)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


class _Recording:
    """A model module whose prefill/decode logits are kept (on the CPU)."""

    def __init__(self, mod):
        self.mod, self.logits = mod, []

    def __getattr__(self, name):        # cache_decl and the rest
        return getattr(self.mod, name)

    def prefill(self, *a, **kw):
        out = self.mod.prefill(*a, **kw)
        self.logits.append(out[0].float().cpu())
        return out

    def decode_step(self, *a, **kw):
        out = self.mod.decode_step(*a, **kw)
        self.logits.append(out[0].float().cpu())
        return out


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x22b", "rwkv6-7b",
                                  "hymba-1.5b", "whisper-small",
                                  "internvl2-2b"])
def test_serve_engine_on_card_matches_cpu(card, arch):
    """Five requests (prompts 40-80 tokens: the flash path above the smoke
    threshold, hymba's window ring) at the smoke config in f32 through
    ``ServeEngine`` (whisper-small and internvl2-2b with the engine's
    zero frames or patches) on the card and on the CPU: the same tokens (f32
    products in another order; a near-tie under 1e-3 would be allowed to
    flip, and ends the comparison), logits within 1e-4, equal stats
    counts, and the card's path through the kernels."""
    from repro_torch.models import model_api
    from repro_torch.serve.engine import ServeEngine
    cfg = smoke_config(get_arch(arch))
    p0 = T.tree_map(lambda t: t.float(), model_api.init_params(cfg, 0, "cpu"))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in
               rng.integers(40, 81, 5)]
    runs = []
    for dev in ("cpu", card):
        eng = ServeEngine(cfg, T.tree_map(lambda t: t.to(dev), p0),
                          device=dev)
        eng.model = _Recording(eng.model)
        for p in prompts:
            eng.submit(p, 4)
        before = (flash_ops.launches, wkv_ops.launches_u,
                  wkv_ops.launches_ssd)
        done = eng.run()
        after = (flash_ops.launches, wkv_ops.launches_u,
                 wkv_ops.launches_ssd)
        runs.append((done, eng.stats, eng.model.logits,
                     [a - b for a, b in zip(after, before)]))
    (want, st0, lg0, _), (got, st1, lg1, launched) = runs
    # a flash launch a layer for each batch whose longest prompt is over
    # the threshold; a WKV launch a layer at prefill and at each of the
    # 4 decode steps of both batches
    L = cfg.n_layers
    flash = L * sum(max(len(p) for p in prompts[b:b + 4])
                    > cfg.attn_chunk_threshold for b in (0, 4))
    wkv = L * 5 * 2
    # (whisper's 8 smoke frames and its decode steps stay quadratic: only
    # its decoder's self-attention at prefill is over the threshold)
    want_launch = {"dense": [flash, 0, 0], "moe": [flash, 0, 0],
                   "vlm": [flash, 0, 0], "encdec": [flash, 0, 0],
                   "rwkv": [0, wkv, 0],
                   "hybrid": [flash, 0, wkv]}[cfg.family]
    assert launched == want_launch
    for key in ("prefill_tokens", "decode_steps", "requests"):
        assert st1[key] == st0[key]
    same = True
    for i, (w, g) in enumerate(zip(want, got)):
        for j, (a, b) in enumerate(zip(w.out, g.out)):
            if a != b:
                top2 = lg0[(i // 4) * 5 + j][i % 4].topk(2).values
                assert float(top2[0] - top2[1]) < 1e-3, (i, j)
                same = False
                break
    if same:
        for a, b in zip(lg1, lg0):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# the encoder-decoder and VLM families' shapes: whisper-small's encoder
# (non-causal, 1500 keys: ragged against the 64-key tile), cross-attention
# over the 1500 frames from 448 decoder tokens and from one (a decode
# step), and internvl2-2b's causal GQA 16/8 at hd 128 over 2048 tokens
FRONTEND_FLASH_CASES = [  # (B, Sq, Sk, H, Kv, hd, causal)
    (4, 1500, 1500, 12, 12, 64, False),
    (4, 448, 1500, 12, 12, 64, False),
    (4, 1, 1500, 12, 12, 64, False),
    (1, 2048, 2048, 16, 8, 128, True),
    (4, 2048, 2048, 16, 8, 128, True),
]


@pytest.mark.parametrize("B,Sq,Sk,H,Kv,hd,causal", FRONTEND_FLASH_CASES)
def test_flash_kernel_at_encdec_and_vlm_shapes_matches_plain(
        card, B, Sq, Sk, H, Kv, hd, causal):
    rng = np.random.default_rng(Sq + Sk + H)
    q = _normal(rng, (B, Sq, H, hd), torch.bfloat16, card)
    k = _normal(rng, (B, Sk, Kv, hd), torch.bfloat16, card)
    v = _normal(rng, (B, Sk, Kv, hd), torch.bfloat16, card)
    before = flash_ops.launches
    o, lse = flash_ops.flash_fwd(q, k, v, causal, None)
    assert flash_ops.launches == before + 1
    o_ref, lse_ref = attention_ref(q, k, v, causal, None)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


def test_flash_noncausal_gradient_over_1500_keys_matches_full_attention(card):
    """Cross-attention's gradient at whisper's key length: the kernel's
    forward and the plain backward in kv chunks of 1024 + 476, against
    autograd through the quadratic path, f32."""
    rng = np.random.default_rng(4)
    B, Sq, Sk, H, hd = 1, 96, 1500, 4, 64
    q = _normal(rng, (B, Sq, H, hd), torch.float32, card).requires_grad_()
    k = _normal(rng, (B, Sk, H, hd), torch.float32, card).requires_grad_()
    v = _normal(rng, (B, Sk, H, hd), torch.float32, card).requires_grad_()
    cot = _normal(rng, (B, Sq, H, hd), torch.float32, card)
    qp, kp = torch.arange(Sq, device=card), torch.arange(Sk, device=card)
    grads = []
    for fn in (lambda: flash_attention(q, k, v, False, None, 1024),
               lambda: full_attention(q, k, v, qp, kp, causal=False)):
        q.grad = k.grad = v.grad = None
        (fn() * cot).sum().backward()
        grads.append([t.grad.clone() for t in (q, k, v)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-2b"])
def test_frontend_round_on_card_matches_cpu(card, arch):
    """One tree round of the smoke config in f32, with the attention
    threshold under the 8 frames and 12 tokens (every attention through
    the flash kernel on the card), from the same state and batch
    (``inputs.make_batch``) on the card and on the CPU: the same loss and
    parameters (f32 sums in another order; Adam moves a weight by O(lr)
    where its gradient is at rounding level, so atol is lr / 3), a fedavg
    launch a leaf, and flash launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.fl_step import (build_fl_round_step,
                                          init_opt_state, init_state)
    from repro_torch.models import inputs
    from repro_torch.optim.api import make_optimizer
    cfg = smoke_config(get_arch(arch)).replace(attn_chunk_threshold=6,
                                               attn_chunk=5)
    K = 4
    p0 = T.tree_map(lambda t: t.float(),
                    init_state(cfg, K, seed=0, device="cpu")["params"])
    batch = inputs.make_batch(cfg, ShapeConfig("t", 12, 2 * K, "train"), 1,
                              clients=K, device="cpu")
    sched = AggSchedule("tree", K, (((0, 1), (2, 3)), ((0, 1, 2, 3),)),
                        ((1, 0, 1, 0),))
    w = np.array([3.0, 1.0, 2.0, 4.0], np.float32)
    out = []
    for dev in ("cpu", card):
        params = T.tree_map(lambda t: t.clone().to(dev), p0)
        state = {"params": params, "opt": init_opt_state(
            make_optimizer(cfg, total_steps=2), params, K), "step": 0}
        step = build_fl_round_step(cfg, K, sched, dev, total_steps=2)
        before = (fedavg_ops.launches, flash_ops.launches)
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()}, w)
        out.append((float(m["loss"]), state["params"],
                    fedavg_ops.launches - before[0],
                    flash_ops.launches - before[1]))
    (l0, p_cpu, _, _), (l1, p_card, fed, flash) = out
    assert fed == len(T.leaves(p_card)) and flash > 0
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for a, b in zip(T.leaves(p_card), T.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the rank path: one client a card, NCCL
# ---------------------------------------------------------------------------

def _rank_rounds(mesh, cases, rounds):
    """Each (schedule, strategy) case through the trainer on this rank
    (qwen2-7b's smoke config, one client a card) -> {case: (losses, this
    rank's slot on the host)}."""
    cfg = smoke_config(get_arch("qwen2-7b"))
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for kind, strat in cases:
        tr = SDFLMQTrainer(cfg, mesh.world, rounds, 2, 32, seed=0, mesh=mesh,
                           schedule_kind=kind, strategy=strat)
        ms = tr.run()
        slot = (lambda t: t[0]) if mesh.world > 1 else (lambda t: t)
        out[(kind, strat)] = ([m["loss"] for m in ms], T.tree_map(
            lambda t: slot(t).cpu(), tr.state["params"]))
    return out


def _single_rounds(card, K, kind, strat, rounds):
    cfg = smoke_config(get_arch("qwen2-7b"))
    tr = SDFLMQTrainer(cfg, K, rounds, 2, 32, seed=0, device=card,
                       schedule_kind=kind, strategy=strat)
    ms = tr.run()
    slot = (lambda t: t[0]) if K > 1 else (lambda t: t)
    return [m["loss"] for m in ms], T.tree_map(lambda t: slot(t).cpu(),
                                               tr.state["params"])


def test_rank_path_at_world_1_equals_single_device(card):
    """One NCCL rank (K = 1): two rounds equal the single-card K = 1
    trainer's, losses and parameters, bit for bit."""
    from repro_torch.launch import mesh as mesh_lib
    cases = [("tree", "fedavg"), ("compressed", "fedavg")]
    got = mesh_lib.spawn(_rank_rounds, 1, (cases, 2), device="cuda",
                         timeout_s=600)[0]
    for kind, strat in cases:
        losses, params = _single_rounds(card, 1, kind, strat, 2)
        assert got[(kind, strat)][0] == losses
        for a, b in zip(T.leaves(got[(kind, strat)][1]), T.leaves(params)):
            assert torch.equal(a, b)


def test_rank_path_over_every_card_matches_one_card(card):
    """K = the host's cards, one a rank: one round against the single-card
    K-client round on card 0 -- bit for bit under ``compressed`` and
    ``trimmed_mean``, within one bf16 ulp under ``flat`` and ``tree``; the
    loss within 1e-6 relative."""
    from repro_torch.launch import mesh as mesh_lib
    K = torch.cuda.device_count()
    if K < 2:
        pytest.skip(f"needs two or more cards, this host has {K}")
    cases = [("flat", "fedavg"), ("tree", "fedavg"),
             ("compressed", "fedavg"), ("flat", "trimmed_mean")]
    ranks = mesh_lib.spawn(_rank_rounds, K, (cases, 1), device="cuda",
                           timeout_s=600)
    for kind, strat in cases:
        losses, want = _single_rounds(card, K, kind, strat, 1)
        for got in ranks:
            g_losses, g_params = got[(kind, strat)]
            assert abs(g_losses[0] - losses[0]) <= 1e-6 * abs(losses[0])
            for a, b in zip(T.leaves(g_params), T.leaves(want)):
                if kind == "compressed" or strat == "trimmed_mean":
                    assert torch.equal(a, b)
                else:
                    b32 = b.float()
                    ulp = torch.exp2(torch.floor(torch.log2(
                        b32.abs().clamp_min(2.0 ** -126))) - 7)
                    assert ((a.float() - b32).abs() <= ulp).all()


# ---------------------------------------------------------------------------
# the model axis: a client split over cards (tensor parallelism)
# ---------------------------------------------------------------------------

# qwen2-7b's local heads on a model axis of 4 (7 q heads, 1 kv head) and
# of 2 (14 and 2), causal over 2048 tokens
TP_FLASH_CASES = [(7, 1), (14, 2)]


@pytest.mark.parametrize("H,Kv", TP_FLASH_CASES)
def test_flash_kernel_at_local_head_shapes_matches_plain(card, H, Kv):
    rng = np.random.default_rng(H * 31 + Kv)
    q = _normal(rng, (1, 2048, H, 128), torch.bfloat16, card)
    k = _normal(rng, (1, 2048, Kv, 128), torch.bfloat16, card)
    v = _normal(rng, (1, 2048, Kv, 128), torch.bfloat16, card)
    before = flash_ops.launches
    o, lse = flash_ops.flash_fwd(q, k, v, True, None)
    assert flash_ops.launches == before + 1
    o_ref, lse_ref = attention_ref(q, k, v, True, None)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


# a rank's heads on a model axis of 4 for the MoE and Adafactor configs:
# mixtral-8x22b (12 q, 2 kv, window 4096), internlm2-20b (12, 2), kimi-k2
# (16, 2, head dim 112)
MOE_FLASH_CASES = [(12, 2, 128, 4096), (12, 2, 128, None), (16, 2, 112, None)]


@pytest.mark.parametrize("H,Kv,hd,window", MOE_FLASH_CASES)
def test_flash_kernel_at_moe_local_head_shapes_matches_plain(card, H, Kv, hd,
                                                             window):
    rng = np.random.default_rng(H * 37 + hd)
    q = _normal(rng, (1, 2048, H, hd), torch.bfloat16, card)
    k = _normal(rng, (1, 2048, Kv, hd), torch.bfloat16, card)
    v = _normal(rng, (1, 2048, Kv, hd), torch.bfloat16, card)
    before = flash_ops.launches
    o, lse = flash_ops.flash_fwd(q, k, v, True, window)
    assert flash_ops.launches == before + 1
    o_ref, lse_ref = attention_ref(q, k, v, True, window)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


def _mesh_shape_rounds(mesh, cases, rounds):
    return mesh.shape, _rank_rounds(mesh, cases, rounds)


def test_one_by_one_mesh_equals_single_device(card):
    """A (1, 1) mesh (``spawn(..., model=1)``, no model axis: the plain
    model code) runs two rounds equal to the single-card K = 1 trainer's,
    losses and parameters, bit for bit."""
    from repro_torch.launch import mesh as mesh_lib
    cases = [("flat", "fedavg")]
    shape, got = mesh_lib.spawn(_mesh_shape_rounds, 1, (cases, 2), model=1,
                                device="cuda", timeout_s=600)[0]
    assert shape == {"data": 1, "model": 1}
    losses, params = _single_rounds(card, 1, "flat", "fedavg", 2)
    assert got[("flat", "fedavg")][0] == losses
    for a, b in zip(T.leaves(got[("flat", "fedavg")][1]), T.leaves(params)):
        assert torch.equal(a, b)


def _tp_grads(mesh, rp):
    """One qwen2-7b smoke client split over this host's cards, f32: the
    loss and the gradient of this rank's block of every leaf."""
    from repro_torch.core import fl_step
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tpar
    from repro_torch.models import model_api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(get_arch("qwen2-7b")).replace(remat=True)
    specs = fl_step.param_specs(cfg, mesh)
    live = T.tree_map(lambda t, s: shd.local_block(t, s, mesh).to(
        mesh.device).clone().requires_grad_(), rp, specs)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 97))).to(
        mesh.device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _ = model_api.loss_fn(cfg, live, batch, tpar.axis_for(cfg, mesh))
    grads = torch.autograd.grad(loss, T.leaves(live))
    return loss.item(), [g.cpu() for g in grads]


def test_client_over_cards_matches_one_card_f32(card):
    """A (1, M) mesh over this host's cards (M = 2 or 4): the loss and
    every gradient block of one client against the single card, f32,
    within rtol 1e-5 / atol 1e-6 (M partial sums in another order)."""
    from repro_torch.core import fl_step
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model_api
    M = torch.cuda.device_count()
    if M not in (2, 4):
        pytest.skip(f"needs 2 or 4 cards, this host has {M}")
    cfg = smoke_config(get_arch("qwen2-7b")).replace(remat=True)
    rp = T.tree_map(lambda t: t.float(), materialize(
        model_api.param_decls(cfg), 0, "cpu"))
    ranks = mesh_lib.spawn(_tp_grads, 1, (rp,), model=M, device="cuda",
                           timeout_s=600)
    live = T.tree_map(lambda t: t.to(card).requires_grad_(), rp)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 97))).to(card)
    loss, _ = model_api.loss_fn(cfg, live, {"tokens": toks[:, :-1],
                                            "labels": toks[:, 1:]})
    grads = torch.autograd.grad(loss, T.leaves(live))
    specs = T.leaves(fl_step.param_specs(cfg, {"data": 1, "model": M}))
    grid = type("Grid", (), {"shape": {"data": 1, "model": M}})()
    for r, (g_loss, g_grads) in enumerate(ranks):
        assert abs(g_loss - loss.item()) <= 1e-6 * abs(loss.item())
        for a, b, s in zip(g_grads, grads, specs):
            torch.testing.assert_close(
                a, shd.local_block(b.cpu(), s, grid, r), rtol=1e-5,
                atol=1e-6)
