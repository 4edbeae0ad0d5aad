#!/usr/bin/env python3
"""The PyTorch port's main paths on one CUDA card (an H100), end to end.

    python3 chip_smoke.py                # as a check runs it
    python3 chip_smoke.py --profile      # also trace each training round

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
sm_90a, holds each kernel against its plain PyTorch version on the card,
times both (and the one PyTorch call that computes the same function, where
there is one), and holds every compiled aggregation strategy on the card
against the same call on the CPU.  Then it runs two federated rounds of each
train cell through ``SDFLMQTrainer`` at published widths (random weights
from a seed), each after the previous trainer is freed: qwen2-7b (one
layer) with the ``tree`` schedule (fedavg kernel) and with the
``compressed`` schedule (int8 quantize + qagg kernel); rwkv6-7b (two
layers, the WKV kernel with u); hymba-1.5b (all 32 layers, the WKV kernel
in SSD form and the flash kernel with a 1024 window); and qwen2-7b under
``fedprox`` (premapped chunks through the fedavg kernel's f32 entry),
``trimmed_mean`` and ``multi_krum`` (plain PyTorch combines; c3 dies in
round 1); mixtral-8x22b (one layer: the MoE layer, flash with 6 q heads
a kv head and a 4096 window) and internlm2-20b (two layers), both under
Adafactor, their config's optimizer; then two rounds of whisper-small
(all layers: the encoder and the cross-attention through the flash kernel
at 1500 frames, non-causal) and of internvl2-2b (16 of 24 layers, patches
filling the front) through the round step itself.  The kernels' launch
counters, set to 0 just before each run and read just after, show that
each run went through its kernels.  Then the ``resume`` phase checkpoints
and resumes qwen2-7b's smoke config on the card, ``resume_full`` saves
and restores a hymba-1.5b state at published widths (depth cut to 2
layers), and six serving cells (qwen2-7b, rwkv6-7b, hymba-1.5b,
mixtral-8x22b at 4 layers, whisper-small, internvl2-2b) each serve 8
requests through ``ServeEngine``.
Each phase prints JSON lines; then one line lists every kernel, one line
gives the card's name and power limit as nvidia-smi reports them, and the
last line is ``{"ok": true, "device": ...}``.  Any failure raises and
exits non-zero; nothing runs on the CPU but the strategies' references.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12     # H100 SXM dense bf16 tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# each kernel's launch counter: name -> (its ops module, the attribute)
COUNTERS = {"fedavg": ("fedavg", "launches"),
            "qagg": ("fedavg", "qagg_launches"),
            "flash_fwd": ("flash_attn", "launches"),
            "quantize": ("quant8", "quantize_launches"),
            "dequantize": ("quant8", "dequantize_launches"),
            "wkv6": ("wkv6", "launches_u"),
            "ssm_scan": ("wkv6", "launches_ssd")}


def _counter(name):
    import importlib
    mod, attr = COUNTERS[name]
    return importlib.import_module(f"repro_torch.kernels.{mod}.ops"), attr


def reset_launches():
    for name in COUNTERS:
        setattr(*_counter(name), 0)


def read_launches(names=tuple(COUNTERS)):
    return {name: getattr(*_counter(name)) for name in names}


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(torch, dev, smi):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(_build.build_log)
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(dev),
          "capability": list(torch.cuda.get_device_capability(dev)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "ptxas": ptxas})


def phase_fedavg(torch, dev):
    from repro_torch.kernels.fedavg import ops
    from repro_torch.kernels.fedavg.ref import fedavg_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.tensor([3.0, 1.0, 2.0, 4.0], device=dev)
    cases = [("path_largest_leaf", 4, 152064 * 3584, torch.bfloat16),
             ("path_f32_chunk", 4, 1 << 26, torch.float32),   # fedprox's
             ("mixtral_expert_leaf", 4, 8 * 6144 * 16384, torch.bfloat16),
             ("norm_leaf", 4, 3584, torch.float32),
             ("ragged", 4, 1_000_003, torch.float32)]
    rows = []
    for name, K, N, dtype in cases:
        x = torch.randn((K, N), generator=gen, device=dev, dtype=dtype)
        got = ops.fedavg(x, w)
        want = fedavg_ref(x, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:     # at most one bf16 ulp
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(2.0 ** -126))) - 7)
            ok = bool((err <= ulp).all())
        else:
            ok = bool((err <= 1e-6 + 1e-6 * want.float().abs()).all())
        esize = x.element_size()
        nbytes = (K * N + N) * esize
        ms = time_ms(torch, lambda: ops.fedavg(x, w), 10 if N > 1e8 else 50)
        plain_ms = time_ms(torch, lambda: fedavg_ref(x, w),
                           3 if N > 1e8 else 20)
        row = {"case": name, "K": K, "N": N, "dtype": str(dtype),
               "max_abs_err": float(err.max()),
               "bit_exact": bool(torch.equal(got, want)),
               "kernel_ms": ms, "plain_ms": plain_ms,
               "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
               "gb_s": nbytes / (ms * 1e-3) / 1e9}
        if name == "path_largest_leaf":
            # the one PyTorch call for the same weighted mean: the (1, K)
            # normalized weight row times the (K, N) view (it rounds
            # otherwise, so it is timed, not compared)
            row_w = (w / w.sum()).to(dtype)[None, :]
            row["library_ms"] = time_ms(
                torch, lambda: torch.matmul(row_w, x), 10)
        emit({"phase": "fedavg", **row})
        if not ok:
            raise AssertionError(f"fedavg kernel disagrees: {row}")
        rows.append(row)
        del x, got, want, err
        torch.cuda.empty_cache()
    return rows[0]


def _flash_flops(B, Sq, Sk, H, hd, causal, window, q_offset=0, kv_offset=0):
    """4*hd flops per unmasked (q, k) pair (QK^T and PV)."""
    import numpy as np
    qp = q_offset + np.arange(Sq)[:, None]
    kp = kv_offset + np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    return 4.0 * B * H * hd * float(ok.sum())


def phase_flash(torch, dev):
    """The flash kernel against its plain version (``attention_ref``) at
    the paths' shapes (qwen2: causal; hymba: window 1024; mixtral: 48 q and
    8 kv heads, window 4096) and at odd ones, then the gradient through
    it.  The path shapes are timed beside the plain version and
    ``scaled_dot_product_attention``; ``bound_share`` is the bound over the
    kernel's time."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.models.attention import flash_attention, full_attention
    gen = torch.Generator(device=dev).manual_seed(1)

    def qkv(B, Sq, Sk, H, Kv, hd, dtype):
        mk = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=dtype)
        return mk(B, Sq, H, hd), mk(B, Sk, Kv, hd), mk(B, Sk, Kv, hd)

    cases = [  # name, B, Sq, Sk, H, Kv, hd, dtype, causal, window, q_offset
        ("path", 1, 2048, 2048, 28, 4, 128, torch.bfloat16, True, None, 0),
        ("window", 2, 300, 300, 4, 2, 64, torch.float32, True, 64, 0),
        ("q_offset", 1, 64, 192, 4, 2, 64, torch.float32, True, None, 128),
        ("hymba_window", 1, 2048, 2048, 25, 5, 64, torch.bfloat16, True,
         1024, 0),
        ("mixtral_window", 1, 2048, 2048, 48, 8, 128, torch.bfloat16, True,
         4096, 0),
    ]
    path_row = None
    for name, B, Sq, Sk, H, Kv, hd, dtype, causal, window, qo in cases:
        q, k, v = qkv(B, Sq, Sk, H, Kv, hd, dtype)
        o, lse = ops.flash_fwd(q, k, v, causal, window, qo)
        o_ref, lse_ref = attention_ref(q, k, v, causal, window, qo)
        torch.cuda.synchronize()
        o_err = float((o.float() - o_ref.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        # bf16 o: one bf16 ulp of values below 2; f32: summation order
        o_tol, lse_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 \
            else (2e-5, 2e-5)
        row = {"case": name, "shape_q": [B, Sq, H, hd],
               "shape_kv": [B, Sk, Kv, hd], "dtype": str(dtype),
               "causal": causal, "window": window, "q_offset": qo,
               "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
               "o_tol": o_tol, "lse_tol": lse_tol}
        if name in ("path", "hymba_window", "mixtral_window"):
            flops = _flash_flops(B, Sq, Sk, H, hd, causal, window)
            nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) \
                * q.element_size() + lse.numel() * 4
            ms = time_ms(torch, lambda: ops.flash_fwd(q, k, v, causal,
                                                      window), 10)
            plain_ms = time_ms(
                torch, lambda: attention_ref(q, k, v, causal, window), 3)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            else:
                pos = torch.arange(Sq, device=dev)
                keep = (pos[:, None] >= pos[None, :]) \
                    & (pos[:, None] - pos[None, :] < window)
                lib = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep, enable_gqa=True)
            lib_ms = time_ms(torch, lib, 10)
            bound_ms = max(flops / PEAK_BF16_FLOP_S,
                           nbytes / PEAK_BYTES_S) * 1e3
            row.update({
                "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
                "bound_by": "operations" if flops / PEAK_BF16_FLOP_S
                > nbytes / PEAK_BYTES_S else "bytes",
                "bound_share": bound_ms / ms,
                "tflop_s": flops / (ms * 1e-3) / 1e12})
        if name == "path":
            path_row = row
        emit({"phase": "flash_fwd", **row})
        if o_err > o_tol or lse_err > lse_tol:
            raise AssertionError(f"flash kernel disagrees: {row}")
        del q, k, v, o, lse, o_ref, lse_ref

    # gradient: kernel forward + plain backward vs the fully plain path
    q, k, v = (t.requires_grad_() for t in qkv(1, 256, 256, 4, 2, 64,
                                               torch.float32))
    pos = torch.arange(256, device=dev)
    cot = torch.randn((1, 256, 4, 64), generator=gen, device=dev)
    grads = []
    for fn in (lambda: flash_attention(q, k, v, True, None, 64),
               lambda: full_attention(q, k, v, pos, pos, causal=True)):
        q.grad = k.grad = v.grad = None
        (fn() * cot).sum().backward()
        grads.append([t.grad.clone() for t in (q, k, v)])
    g_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    emit({"phase": "flash_grad", "shape_q": [1, 256, 4, 64],
          "max_abs_err": g_err, "tol": 1e-4})
    if g_err > 1e-4:
        raise AssertionError(f"flash gradient disagrees: {g_err}")
    return path_row


def phase_qagg(torch, dev):
    """qagg at the embed table's payload (the path's largest launch), a
    large-G leaf (w_gate/w_up) and odd shapes: bit-exact with the plain
    version, with kernel and plain times and the byte bound."""
    from repro_torch.kernels.fedavg import ops
    from repro_torch.kernels.fedavg.ref import qagg_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.tensor([0.7, 1.3, 2.0, 0.5], device=dev)
    cases = [("path_embed", 4, 152064, 3584), ("large_G", 4, 3584, 18944),
             ("G1", 4, 1000, 1), ("G7", 4, 999, 7), ("R1", 4, 1, 3584),
             ("scalar", 4, 1, 1)]
    path_row = None
    for name, K, R, G in cases:
        q = torch.randint(-127, 128, (K, R, G), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((K, R, 1), generator=gen, device=dev) * (2.0 / 127)
        got = ops.qagg(q, s, w)
        want = qagg_ref(q, s, w)
        torch.cuda.synchronize()
        nbytes = K * R * G + 4 * K * R + 4 * R * G
        row = {"case": name, "K": K, "R": R, "G": G,
               "bit_exact": bool(torch.equal(got, want)),
               "max_abs_err": float((got - want).abs().max()),
               "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_S * 1e3}
        if name in ("path_embed", "large_G"):
            ms = time_ms(torch, lambda: ops.qagg(q, s, w), 10)
            row.update({"kernel_ms": ms,
                        "plain_ms": time_ms(torch,
                                            lambda: qagg_ref(q, s, w), 3),
                        "gb_s": nbytes / (ms * 1e-3) / 1e9})
        emit({"phase": "qagg", **row})
        if not row["bit_exact"]:
            raise AssertionError(f"qagg kernel disagrees: {row}")
        if name == "path_embed":
            path_row = row
        del q, s, got, want
        torch.cuda.empty_cache()
    return path_row


def phase_quant8(torch, dev):
    """quant8 quantize/dequantize of a 545 M-element vector (the embed
    table's size) in bf16 and f32 and of ragged sizes that pad: bit-exact
    with the plain versions, padding rows included."""
    from repro_torch.kernels.quant8 import ops
    from repro_torch.kernels.quant8.ref import dequantize_ref, quantize_ref
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [("path_bf16", 152064 * 3584, torch.bfloat16),
             ("f32", 152064 * 3584, torch.float32),
             ("ragged_f32", 3 * 65536 + 17, torch.float32),
             ("ragged_bf16", 1_000_003, torch.bfloat16)]
    rows = {}
    for name, n, dtype in cases:
        x = torch.randn((n,), generator=gen, device=dev).to(dtype)
        x[:256] = 0                                   # an all-zero block
        q, s, got_n = ops.quantize(x)
        flat = ops._to_rows(x).reshape(-1)
        want_q, want_s = quantize_ref(flat)
        out = ops.dequantize(q, s, n)
        want_out = dequantize_ref(q.reshape(-1), s)[:n]
        torch.cuda.synchronize()
        exact = (got_n == n and torch.equal(q.reshape(-1), want_q)
                 and torch.equal(s, want_s) and torch.equal(out, want_out))
        err = max(float((q.reshape(-1).float() - want_q.float()).abs().max()),
                  float((s - want_s).abs().max()),
                  float((out - want_out).abs().max()))
        q_bytes = n * x.element_size() + n + 4 * n / 256
        d_bytes = n + 4 * n / 256 + 4 * n
        row = {"case": name, "n": n, "dtype": str(dtype),
               "padded_rows": q.shape[0] - -(-n // 256),
               "bit_exact": bool(exact), "max_abs_err": err,
               "quantize_bound_ms": q_bytes / PEAK_BYTES_S * 1e3,
               "dequantize_bound_ms": d_bytes / PEAK_BYTES_S * 1e3}
        if n > 1e8:
            qms = time_ms(torch, lambda: ops.quantize(x), 10)
            dms = time_ms(torch, lambda: ops.dequantize(q, s, n), 10)
            row.update({
                "quantize_ms": qms, "dequantize_ms": dms,
                "quantize_plain_ms": time_ms(
                    torch, lambda: quantize_ref(flat), 3),
                "dequantize_plain_ms": time_ms(
                    torch, lambda: dequantize_ref(q.reshape(-1), s)[:n], 3),
                "quantize_gb_s": q_bytes / (qms * 1e-3) / 1e9,
                "dequantize_gb_s": d_bytes / (dms * 1e-3) / 1e9})
        emit({"phase": "quant8", **row})
        if not exact:
            raise AssertionError(f"quant8 kernels disagree: {row}")
        rows[name] = row
        del x, q, s, flat, want_q, want_s, out, want_out
        torch.cuda.empty_cache()
    return rows["path_bf16"]


def _wkv_work(B, T, H, dk, dv, C, use_u):
    """(FLOPs, exps) of one chunked WKV call in the plain chunked form: per
    chunk and head the pairwise scores (3 per channel of each pair s < t, 2
    per channel on the diagonal, one exp per channel of each pair s < t),
    r*exp(base) @ S, A @ v over s <= t and the state update.  The kernel
    factors most of the pairwise exps away; the bound is its bytes."""
    n = -(-T // C)
    pairs = C * (C - 1) // 2
    per_chunk = (3 * pairs * dk + (3 if use_u else 2) * C * dk
                 + 2 * C * dk * dv + C * (C + 1) * dv + 2 * C * dk * dv)
    return float(B * H * n * per_chunk), float(B * H * n * pairs * dk)


WKV_CASES = [  # name, B, T, H, dk, dv, chunk, use_u, per-head w, s0, dtype
    ("path_rwkv6", 1, 2048, 64, 64, 64, 128, True, False, False,
     "bfloat16"),
    ("path_hymba", 1, 2048, 25, 16, 64, 128, False, True, False, "bfloat16"),
    ("odd_u", 2, 200, 3, 4, 8, 64, True, False, True, "float32"),
    ("odd_ssd", 2, 200, 3, 4, 8, 64, False, True, True, "float32"),
]


def phase_wkv(torch, dev, cases=WKV_CASES, phase="wkv", seed=4):
    """The chunked WKV kernel against its plain version (``ref.chunked``)
    at the two paths' shapes (rwkv6: per-channel decay with u; hymba's SSM
    branch: per-head decay, SSD form) and at odd shapes (B = 2, a ragged
    T = 200 with chunk 64, dk 4 / dv 8, a given s0).  Tolerance: 1e-4 of
    max |o| (and of max |s_final|), f32 sums in another order.
    ``bound_share`` is the bound over the kernel's time."""
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.ref import chunked
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    for name, B, T, H, dk, dv, C, use_u, scalar, with_s0, dtype in cases:
        dtype = getattr(torch, dtype)
        mk = lambda *s: torch.randn(s, generator=gen, device=dev)
        r = (mk(B, T, H, dk) * 0.5).to(dtype)
        k = (mk(B, T, H, dk) * 0.5).to(dtype)
        v = mk(B, T, H, dv).to(dtype)
        # decays like the models' (rwkv6 w0 = -2 gives ~-0.14 a step)
        w = -torch.exp(mk(B, T, H, 1 if scalar else dk) * 0.5 - 1.5)
        u = mk(H, dk) * 0.3 if use_u else None
        s0 = mk(B, H, dk, dv) * 0.2 if with_s0 else None
        o, sf = ops.wkv_f32(r, k, v, w, u=u, s0=s0, chunk=C)
        o_ref, sf_ref = chunked(r, k, v, w, u=u, s0=s0, chunk=C)
        torch.cuda.synchronize()
        o_err = float((o - o_ref).abs().max())
        s_err = float((sf - sf_ref).abs().max())
        o_tol = 1e-4 * float(o_ref.abs().max())
        s_tol = 1e-4 * float(sf_ref.abs().max())
        flops, exps = _wkv_work(B, T, H, dk, dv, min(C, T), use_u)
        nbytes = (3 * r.numel() * r.element_size() + w.numel() * 4
                  + (u.numel() * 4 if use_u else 0)
                  + (2 * sf.numel() * 4 if with_s0 else sf.numel() * 4)
                  + o.numel() * 4)
        row = {"case": name, "shape_rk": [B, T, H, dk],
               "shape_v": [B, T, H, dv], "w_last_dim": w.shape[-1],
               "chunk": C, "use_u": use_u, "s0": with_s0,
               "dtype": str(dtype), "o_max_abs_err": o_err,
               "s_final_max_abs_err": s_err, "o_tol": o_tol, "s_tol": s_tol,
               "bytes": nbytes, "flops": flops, "exps": exps,
               "bound_ms": max(nbytes / PEAK_BYTES_S,
                               flops / PEAK_BF16_FLOP_S) * 1e3,
               "bound_by": "operations" if flops / PEAK_BF16_FLOP_S
               > nbytes / PEAK_BYTES_S else "bytes"}
        ms = time_ms(torch, lambda: ops.wkv_f32(r, k, v, w, u=u, s0=s0,
                                                chunk=C), 10)
        row.update({
            "kernel_ms": ms,
            "plain_ms": time_ms(
                torch, lambda: chunked(r, k, v, w, u=u, s0=s0, chunk=C), 2),
            "bound_share": row["bound_ms"] / ms,
            "gb_s": nbytes / (ms * 1e-3) / 1e9,
            "gexp_s": exps / (ms * 1e-3) / 1e9})
        if name == "path_hymba":       # the ssm_scan wrapper: same kernel
            before = ops.launches_ssd
            y, h = ssm_scan(r, k, v, w, chunk=C)
            torch.cuda.synchronize()
            row["ssm_scan_launches"] = ops.launches_ssd - before
            row["ssm_scan_s_final_equal"] = bool(torch.equal(h, sf))
            if row["ssm_scan_launches"] != 1 or y.dtype != dtype \
                    or not row["ssm_scan_s_final_equal"]:
                raise AssertionError(f"ssm_scan wrapper: {row}")
        emit({"phase": phase, **row})
        if not (o_err <= o_tol and s_err <= s_tol):
            raise AssertionError(f"wkv kernel disagrees: {row}")
        rows[name] = row
        del r, k, v, w, o, sf, o_ref, sf_ref
        torch.cuda.empty_cache()
    return rows


STRATEGIES = ["fedavg", "fedprox", "fedprox_poly", "norm_clip",
              "trimmed_mean", "coordinate_median", "weighted_trimmed_mean",
              "weighted_median", "krum", "multi_krum",
              "clipped_weighted_trimmed_mean"]
NORM_CLIPPED = {"norm_clip", "clipped_weighted_trimmed_mean"}


def phase_strategies(torch, dev):
    """Each compiled strategy's ``aggregate_params`` on the card against the
    same call on the CPU: K = 4 with one dead row, a bf16 leaf of
    CHUNK + 1 elements a client (two chunks) and an f32 leaf, each client's
    pre-round ref a noisy copy of its row.  Client k's rows spread with k,
    so krum's distances are well separated and its selection does not hang
    on the Gram's rounding (the card's matmul sums in another order).
    Tolerance 0, except for the norm clip, whose per-client sums of squares
    the card reduces in another order: 4 f32 ulps of the leaf's largest
    magnitude, or one bf16 ulp of the value.  ``ms`` is one call on the card.
    Also times the stable sort the stack combines use (a compare-exchange
    network over the K rows) against ``torch.sort`` on one chunk."""
    from repro_torch.core import aggregation
    from repro_torch.core.topology import AggSchedule
    from repro_torch.core.xp_torch import TorchXP
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    gen = torch.Generator(device=dev).manual_seed(5)
    K = 4
    shapes = {"big": ((K, aggregation.CHUNK + 1), torch.bfloat16),
              "norm": ((K, 3584), torch.float32)}
    bank, ref = {}, {}
    for name, (shape, dtype) in shapes.items():
        spread = torch.arange(1, K + 1, device=dev, dtype=torch.float32)
        spread = spread.view((K,) + (1,) * (len(shape) - 1))
        mk = lambda: torch.randn(shape, generator=gen, device=dev)
        x = torch.randn(shape[1:], generator=gen, device=dev) \
            + 0.3 * spread * mk()
        bank[name] = x.to(dtype)
        ref[name] = (x + 0.2 * spread * mk()).to(dtype)
        del x
    w = torch.tensor([1.0, 2.0, 0.0, 3.0])
    sched = AggSchedule("tree", K)
    chunks = sum(len(aggregation._chunks(t[0].numel()))
                 for t in bank.values())
    cpu_bank = {k: v.cpu() for k, v in bank.items()}
    cpu_ref = {k: v.cpu() for k, v in ref.items()}
    rows = {}
    for name in STRATEGIES:
        want = {k: v.clone() for k, v in cpu_bank.items()}
        t0 = time.perf_counter()
        aggregation.aggregate_params(want, w, sched, name, ref=cpu_ref)
        cpu_s = time.perf_counter() - t0
        warm = {k: v.clone() for k, v in bank.items()}
        aggregation.aggregate_params(warm, w.to(dev), sched, name, ref=ref)
        del warm
        got = {k: v.clone() for k, v in bank.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = fedavg_ops.launches
        torch.cuda.synchronize()
        start.record()
        aggregation.aggregate_params(got, w.to(dev), sched, name, ref=ref)
        end.record()
        end.synchronize()
        launches = fedavg_ops.launches - before
        errs, ok = {}, True
        for k, (_, dtype) in shapes.items():
            g, t = got[k].float().cpu(), want[k].float()
            err = (g - t).abs()
            errs[k] = float(err.max())
            if name in NORM_CLIPPED:
                tol = torch.full_like(t, 4 * 2.0 ** -23 * float(t.abs().max()))
                if dtype == torch.bfloat16:
                    tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(
                        t.abs().clamp_min(2.0 ** -126))) - 7))
                ok &= bool((err <= tol).all())
            else:
                ok &= bool(torch.equal(got[k].cpu(), want[k]))
        strat = aggregation.check_strategy(name)
        want_launches = (0 if strat.reduction == "stack" else
                         chunks if strat.needs_ref else len(shapes))
        row = {"strategy": name, "reduction": strat.reduction,
               "needs_ref": strat.needs_ref, "K": K,
               "elements_per_client": {k: int(v[0].numel())
                                       for k, v in bank.items()},
               "max_abs_err": max(errs.values()), "max_abs_err_by_leaf": errs,
               "tolerance": ("4 f32 ulps of max|x| or 1 bf16 ulp"
                             if name in NORM_CLIPPED else 0),
               "ms": start.elapsed_time(end), "cpu_s": cpu_s,
               "fedavg_launches": launches}
        emit({"phase": "strategies", **row})
        if not ok or launches != want_launches:
            raise AssertionError(f"strategy {name} on the card: {row}; "
                                 f"want {want_launches} fedavg launches")
        rows[name] = row
        del want, got
    xp = TorchXP(dev)
    x = bank["big"][:, :aggregation.CHUNK].float()
    net = xp.sort(x, axis=0)
    lib = torch.sort(x, dim=0, stable=True).values
    row = {"phase": "strategies_sort", "shape": list(x.shape),
           "equal": bool(torch.equal(net, lib)),
           "network_ms": time_ms(torch, lambda: xp.sort(x, axis=0), 5),
           "torch_sort_ms": time_ms(
               torch, lambda: torch.sort(x, dim=0, stable=True), 5)}
    emit(row)
    if not row["equal"]:
        raise AssertionError(f"sorting network != torch.sort: {row}")
    del bank, ref, cpu_bank, cpu_ref, x, net, lib
    torch.cuda.empty_cache()
    return rows


def _dev_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def summarize_profile(torch, prof, r: int, tag: str) -> dict:
    """Device busy time and the top kernels / host ops of one profiled
    round; the full tables go to chiprun_out/profile_round<r>.txt."""
    from torch.autograd import DeviceType
    ka = prof.key_averages()
    spans_of = ("fl/", "train/")      # record_function ranges, not kernels
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and not e.key.startswith(spans_of)]
    busy_us = sum(_dev_us(e) for e in kernels)
    top_dev = sorted(kernels, key=_dev_us, reverse=True)[:12]
    top_cpu = sorted((e for e in ka if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    OUT.mkdir(exist_ok=True)
    with open(OUT / f"profile_{tag}_round{r}.txt", "w") as f:
        for key in ("self_device_time_total", "self_cpu_time_total"):
            try:
                f.write(ka.table(sort_by=key, row_limit=60) + "\n\n")
            except (KeyError, AttributeError, ValueError):
                f.write(ka.table(sort_by="self_cuda_time_total",
                                 row_limit=60) + "\n\n")
    spans = {e.key: [e.cpu_time_total / 1e3,
                     float(getattr(e, "device_time_total", 0.0)) / 1e3,
                     e.count]
             for e in ka if e.key.startswith(spans_of)}
    return {
        "device_busy_s": busy_us / 1e6,
        "spans_host_ms_device_ms_count": spans,
        "top_kernels_ms": [[e.key[:90], _dev_us(e) / 1e3, e.count]
                           for e in top_dev],
        "top_host_ops_ms": [[e.key[:90], e.self_cpu_time_total / 1e3, e.count]
                            for e in top_cpu]}


# phase, arch, depth, schedule, strategy, failures (round -> clients):
# published widths, depth cut to fit one card (K = 4 client banks in bf16
# plus the optimizer's state: f32 AdamW moments, or Adafactor's factors
# for mixtral-8x22b and internlm2-20b)
TRAIN_CELLS = [
    ("train", "qwen2-7b", 1, "tree", "fedavg", {}),
    ("train_compressed", "qwen2-7b", 1, "compressed", "fedavg", {}),
    ("train_rwkv6", "rwkv6-7b", 2, "tree", "fedavg", {}),
    ("train_hymba", "hymba-1.5b", 32, "tree", "fedavg", {}),
    ("train_fedprox", "qwen2-7b", 1, "tree", "fedprox", {}),
    ("train_trimmed_mean", "qwen2-7b", 1, "tree", "trimmed_mean",
     {1: ["c3"]}),
    ("train_multi_krum", "qwen2-7b", 1, "tree", "multi_krum", {1: ["c3"]}),
    ("train_mixtral", "mixtral-8x22b", 1, "tree", "fedavg", {}),
    ("train_internlm2", "internlm2-20b", 2, "tree", "fedavg", {}),
]
K_CLIENTS, ROUNDS, BATCH_PER_CLIENT, SEQ = 4, 2, 1, 2048
CARD_BYTES = 80e9


def phase_train(torch, dev, phase, arch, n_layers, schedule="tree",
                strategy="fedavg", fail_at=None, profile=False):
    """Two rounds of one train cell; the launch counters are set to 0 just
    before the rounds and read just after.  Each round's aggregation (and
    the pre-round copy a ``needs_ref`` strategy takes) is its device time
    between two CUDA events, which the round step records."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.core import aggregation
    from repro_torch.ft.failures import FailurePlan
    from repro_torch.launch.train import SDFLMQTrainer
    from repro_torch.models import moe

    cfg = get_arch(arch).replace(n_layers=n_layers)   # published widths
    K, rounds, bpc, seq = K_CLIENTS, ROUNDS, BATCH_PER_CLIENT, SEQ
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = SDFLMQTrainer(cfg, K, rounds, bpc, seq, seed=0, device=dev,
                       schedule_kind=schedule, strategy=strategy,
                       failure_plan=FailurePlan(fail_at=dict(fail_at or {})))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_leaves = len(T.leaves(tr.state["params"]))
    n_params = sum(t[0].numel() for t in T.leaves(tr.state["params"]))
    identical = []

    def check_slots(r, state):
        same = all(torch.equal(t[k], t[0]) for t in T.leaves(state["params"])
                   for k in range(1, K))
        identical.append(same)

    profiles = []
    if profile:
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        live = [torch.profiler.profile(activities=acts)]

        def on_round_end(r, state):
            torch.cuda.synchronize()
            live[0].stop()
            profiles.append(summarize_profile(torch, live[0], r, phase))
            check_slots(r, state)
            if r + 1 < rounds:
                live[0] = torch.profiler.profile(activities=acts)
                live[0].start()
        tr.on_round_end = on_round_end
        live[0].start()
    else:
        tr.on_round_end = check_slots
    reset_launches()
    moe.reset_stats()
    metrics = tr.run()
    torch.cuda.synchronize()
    routing = moe.read_stats()
    launches = read_launches()
    for m in metrics:
        emit({"phase": f"{phase}_round", "round": m["round"], "loss": m["loss"],
              "time_s": m["time_s"], "tokens_per_s": m["tokens_per_s"],
              "aggregate_ms": m.get("aggregate_ms"),
              "pre_round_ref_ms": m.get("ref_ms"),
              "n_clients": m["n_clients"],
              "max_memory_allocated": m["max_memory_allocated"],
              "schedule": m["schedule"]})
    row = {"phase": phase, "schedule": schedule, "strategy": strategy,
           "fail_at": {str(r): c for r, c in (fail_at or {}).items()},
           "arch": cfg.name,
           "family": cfg.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "window": cfg.window,
           "rwkv_head_dim": cfg.rwkv_head_dim, "rwkv_chunk": cfg.rwkv_chunk,
           "ssm_state": cfg.ssm_state, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "moe": None,
           "clients": K, "batch_per_client": bpc, "seq": seq,
           "rounds": rounds, "params_per_client": n_params,
           "leaves": n_leaves, "init_s": init_s, "launches": launches,
           "slots_identical_each_round": identical,
           "peak_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    if cfg.moe is not None:
        tokens = bpc * seq
        row["moe"] = {
            "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "d_ff_expert": cfg.moe.d_ff_expert,
            "capacity": moe.capacity(tokens, cfg.moe),
            "assignments_per_call": tokens * cfg.moe.top_k, **routing,
            "dropped_per_call": routing["dropped"] / routing["calls"]}
    emit(row)
    for prof, m in zip(profiles, metrics):
        emit({"phase": f"{phase}_profile", "round": m["round"],
              "round_s_profiled": m["time_s"],
              "device_busy_share": prof["device_busy_s"] / m["time_s"],
              **prof})
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    strat = aggregation.check_strategy(strategy)
    spans = [[k for k in ("aggregate_ms", "ref_ms") if k in m]
             for m in metrics]
    want_spans = ["aggregate_ms"] + ["ref_ms"] * strat.needs_ref
    if len(metrics) != rounds or spans != [want_spans] * rounds:
        raise AssertionError(f"{len(metrics)} rounds, spans timed {spans}")
    # the failure plan took effect: each round counts the clients still
    # alive, and a dead client's row carries weight 0 (the dead-row path)
    dead = set()
    for m in metrics:
        dead.update((fail_at or {}).get(m["round"], []))
        if m["n_clients"] != K - len(dead):
            raise AssertionError(f"round {m['round']}: {m['n_clients']} "
                                 f"clients with {sorted(dead)} dead")
    if any(tr.weights[int(c[1:])] != 0 for c in dead):
        raise AssertionError(f"a dead client has weight: {tr.weights}")
    if identical != [True] * rounds:
        raise AssertionError(f"client slots differ after a round: {identical}")
    if row["peak_memory_allocated"] >= CARD_BYTES:
        raise AssertionError(f"peak {row['peak_memory_allocated']} B")
    chunks = sum(len(aggregation._chunks(t[0].numel()))
                 for t in T.leaves(tr.state["params"]))
    want_agg = {"fedavg": 0, "qagg": 0}
    if schedule == "compressed":
        want_agg["qagg"] = n_leaves * rounds
    elif strat.reduction == "sum":
        want_agg["fedavg"] = (chunks if strat.needs_ref else n_leaves) * rounds
    got_agg = {k: launches[k] for k in want_agg}
    if got_agg != want_agg:
        raise AssertionError(f"{schedule}/{strategy}: launches {launches}; "
                             f"want {want_agg} ({n_leaves} leaves, {chunks} "
                             f"chunks, {rounds} rounds)")
    if cfg.moe is not None:       # a call an MoE layer and client (the
        # recompute under remat does not count)
        calls = (cfg.n_layers - cfg.moe.first_k_dense) * K * rounds
        if routing["calls"] != calls or not math.isfinite(
                routing["aux_mean"]):
            raise AssertionError(f"MoE calls {routing}, want {calls}")
    elif routing["calls"]:
        raise AssertionError(f"MoE layer ran on a {cfg.family} path")
    floor = cfg.n_layers * K * rounds         # one launch a layer and client
    want = {"flash_fwd": cfg.family in ("dense", "hybrid", "moe"),
            "wkv6": cfg.family == "rwkv", "ssm_scan": cfg.family == "hybrid"}
    for name, on_path in want.items():
        if on_path and launches[name] < floor:
            raise AssertionError(f"{name} launches {launches[name]} < "
                                 f"layers x clients x rounds = {floor}")
        if not on_path and launches[name]:
            raise AssertionError(f"{name} launched on a {cfg.family} path, "
                                 f"which has none: {launches}")
    if launches["quantize"] or launches["dequantize"]:
        raise AssertionError(f"quant8 launched in the round, which no path "
                             f"of the round should do: {launches}")
    del tr
    return launches


# phase, arch, depth (None: all layers), batch a client, seq: the
# encoder-decoder and VLM rounds at published widths.  whisper-small at
# full depth (0.279 B a client; 448 decoder tokens, Whisper's text context,
# and 1500 frames from the seed); internvl2-2b cut to 16 of 24 layers
# (1.39 B a client; the K = 4 bank and its AdamW moments come to about
# 42 B a parameter, so 24 layers, 1.89 B, do not fit 80 GB)
FRONTEND_TRAIN_CELLS = [
    ("train_whisper", "whisper-small", None, 4, 448),
    ("train_internvl2", "internvl2-2b", 16, 1, 2048),
]
# a two-level cluster tree over the K = 4 clients (level groups, heads)
FRONTEND_TREE = ((((0, 1), (2, 3)), ((0, 1, 2, 3),)), ((1, 0, 1, 0),))


def phase_train_frontend(torch, dev, phase, arch, n_layers, bpc, seq,
                         profile=False):
    """Two ``tree`` + fedavg rounds of an encoder-decoder or VLM cell
    (adamw, K = 4, client weights 1..4) through ``fl_step.init_state`` and
    ``build_fl_round_step``, each round's batch from ``inputs.make_batch``
    (tokens, and frames or patches, from the seed), as the reference's
    ``scripts/smoke_flstep.py`` drives its round step: the trainer feeds
    tokens only.  A round is timed on the host clock from its batch to
    ``float(loss)``, its aggregation between the round step's CUDA events;
    with ``profile`` each round runs under ``torch.profiler``.  The launch
    counters are set to 0 just before the rounds and read just after."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.fl_step import build_fl_round_step, init_state
    from repro_torch.core.topology import AggSchedule
    from repro_torch.models import inputs

    cfg = get_arch(arch)
    reduced = []
    if n_layers is not None:
        reduced = [f"depth {n_layers} of {cfg.n_layers}"]
        cfg = cfg.replace(n_layers=n_layers)
    K, rounds = K_CLIENTS, ROUNDS
    shape = ShapeConfig(phase, seq, K * bpc, "train")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_state(cfg, K, seed=0, device=dev, total_steps=rounds)
    step = build_fl_round_step(cfg, K, AggSchedule("tree", K, *FRONTEND_TREE),
                               dev, total_steps=rounds)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = np.arange(1.0, K + 1.0, dtype=np.float32)
    n_leaves = len(T.leaves(state["params"]))
    n_params = sum(t[0].numel() for t in T.leaves(state["params"]))
    reset_launches()
    metrics, identical, profiles = [], [], []
    for r in range(rounds):
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profile else None
        if prof is not None:
            prof.start()
        t = time.perf_counter()
        batch = inputs.make_batch(cfg, shape, r, clients=K, device=dev)
        state, m = step(state, batch, weights)
        loss = float(m["loss"])              # waits for the device
        dt = time.perf_counter() - t
        if prof is not None:
            prof.stop()
            profiles.append(summarize_profile(torch, prof, r, phase))
        metrics.append({
            "round": r, "loss": loss, "time_s": dt,
            "tokens_per_s": K * bpc * seq * cfg.fl.local_steps / dt,
            **{f"{k}_ms": a.elapsed_time(b)
               for k, (a, b) in m["spans"].items()},
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
        identical.append(all(torch.equal(t_[k], t_[0])
                             for t_ in T.leaves(state["params"])
                             for k in range(1, K)))
        del batch
    torch.cuda.synchronize()
    launches = read_launches()
    for m in metrics:
        emit({"phase": f"{phase}_round", **m})
    fe = cfg.frontend
    attn_layers = cfg.n_layers + cfg.n_enc_layers * (cfg.family == "encdec")
    row = {"phase": phase, "schedule": "tree", "strategy": "fedavg",
           "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "reduced": reduced,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "frontend": {"kind": fe.kind, "n_tokens": fe.n_tokens,
                        "feat_dim": fe.feat_dim},
           "remat": cfg.remat, "optimizer": cfg.optimizer, "clients": K,
           "batch_per_client": bpc, "seq": seq, "rounds": rounds,
           "params_per_client": n_params, "leaves": n_leaves,
           "init_s": init_s, "launches": launches,
           "slots_identical_each_round": identical,
           "peak_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    emit(row)
    for prof, m in zip(profiles, metrics):
        emit({"phase": f"{phase}_profile", "round": m["round"],
              "round_s_profiled": m["time_s"],
              "device_busy_share": prof["device_busy_s"] / m["time_s"],
              **prof})
    del state, step
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss: {losses}")
    if [sorted(k for k in m if k.endswith("_ms")) for m in metrics] \
            != [["aggregate_ms"]] * rounds:
        raise AssertionError(f"{phase}: spans {metrics}")
    if identical != [True] * rounds:
        raise AssertionError(f"{phase}: client slots differ: {identical}")
    if row["peak_memory_allocated"] >= CARD_BYTES:
        raise AssertionError(f"{phase}: peak {row['peak_memory_allocated']}")
    # a flash launch an attention layer over more than 1024 keys (the
    # encoder and the cross-attention over 1500 frames; internvl2's 2048
    # tokens), client and round, the recompute under remat on top;
    # fedavg a leaf a round; nothing else
    floor = attn_layers * K * rounds
    if launches["flash_fwd"] < floor or launches["fedavg"] != \
            n_leaves * rounds or any(
                n for k, n in launches.items()
                if k not in ("flash_fwd", "fedavg")):
        raise AssertionError(f"{phase}: launches {launches}; want flash >= "
                             f"{floor}, fedavg {n_leaves * rounds}")
    return launches


class _Stop(Exception):
    pass


def phase_resume(torch, dev):
    """Checkpoint and resume on the card at qwen2-7b's smoke config, K = 4,
    under ``torch.use_deterministic_algorithms`` (``main`` sets
    ``CUBLAS_WORKSPACE_CONFIG`` before the first cuBLAS call):

    * 4 rounds with c3 failing at round 2, a checkpoint after each round
      under ``build/``; a second trainer on the same directory starts at
      round 4, and the newest checkpoint read back equals the live state
      bit for bit;
    * fedprox, 2 rounds without a stop against 1 round, a checkpoint, a
      stop, a fresh trainer restoring it and 1 round: bit for bit when two
      uninterrupted runs agree bit for bit, else within 4 times their own
      spread (``held`` says which)."""
    from repro_torch import tree as T
    from repro_torch.ckpt.checkpoint import load_checkpoint, \
        restore_checkpoint
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.ft.failures import FailurePlan
    from repro_torch.launch.train import SDFLMQTrainer

    cfg = smoke_config(get_arch("qwen2-7b"))
    K, bpc, seq = 4, 2, 128
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    snap = lambda st: [t.detach().cpu().clone() if torch.is_tensor(t) else t
                       for t in T.leaves(st)]

    def max_diff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   if torch.is_tensor(x) else abs(x - y)
                   for x, y in zip(a, b))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tr = SDFLMQTrainer(cfg, K, 4, bpc, seq, ckpt_dir=str(root / "fail"),
                           failure_plan=FailurePlan(fail_at={2: ["c3"]}),
                           device=dev)
        save_s, real_save = [], tr.ckpt.save

        def timed_save(*a, **kw):
            t = time.perf_counter()
            out = real_save(*a, **kw)
            save_s.append(time.perf_counter() - t)
            return out
        tr.ckpt.save = timed_save
        ms = tr.run()
        newest = root / "fail" / "step_4"
        nbytes = sum(f.stat().st_size for f in newest.iterdir())
        tr2 = SDFLMQTrainer(cfg, K, 4, bpc, seq, ckpt_dir=str(root / "fail"),
                            device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        restore_checkpoint(str(newest), tr2.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        reloaded, _ = load_checkpoint(str(newest))
        live = snap(tr.state)
        reload_equal = all(
            torch.equal(a, b) if torch.is_tensor(b) else int(a) == b
            for a, b in zip(reloaded, live))
        same_state = max_diff(snap(tr2.state), live) == 0

        make = lambda ckpt=None: SDFLMQTrainer(
            cfg, K, 2, bpc, seq, ckpt_dir=ckpt, strategy="fedprox",
            device=dev)
        runs = []
        for _ in range(2):
            whole = make()
            whole.run()
            runs.append(snap(whole.state))
            del whole
        spread = max_diff(runs[0], runs[1])
        first = make(str(root / "stop"))

        def stop(r, state):
            raise _Stop(r)
        first.on_round_end = stop
        try:
            first.run()
        except _Stop:
            pass
        second = make(str(root / "stop"))
        start_round_stop = second.start_round
        second.run()
        resumed = max_diff(snap(second.state), runs[0])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    held = "bit_exact" if spread == 0 else "tolerance"
    row = {"phase": "resume", "arch": cfg.name, "clients": K,
           "batch_per_client": bpc, "seq": seq,
           "losses": [m["loss"] for m in ms],
           "n_clients_last": ms[-1]["n_clients"],
           "start_round_after_4": tr2.start_round,
           "reload_equals_live": reload_equal,
           "restored_state_equals_live": same_state,
           "bytes_written": nbytes, "save_s": save_s,
           "restore_s": restore_s,
           "uninterrupted_runs_max_abs_diff": spread,
           "start_round_after_stop": start_round_stop,
           "resumed_max_abs_diff": resumed, "held": held}
    emit(row)
    if (len(ms) != 4 or ms[-1]["n_clients"] != 3
            or not all(math.isfinite(m["loss"]) for m in ms)
            or tr2.start_round != 4 or not reload_equal or not same_state
            or start_round_stop != 1
            or resumed > (0.0 if spread == 0 else 4 * spread)):
        raise AssertionError(f"resume on the card: {row}")
    return row


# published widths, depth cut to 2 of 32 layers: every leaf of the K = 4
# state stays within the checkpoint format's 4 GiB (qwen2-7b's client-stacked
# embedding moments do not)
RESUME_FULL = ("hymba-1.5b", 2)


def phase_resume_full(torch, dev):
    """What a checkpoint costs at published widths: one round of
    hymba-1.5b (depth cut) with K = 4 at the train cells' batch and
    sequence, saved by the trainer under ``build/``; the checkpoint then
    restored into the state of a trainer drawn from another seed, which
    must equal the live state bit for bit."""
    from repro_torch import tree as T
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import SDFLMQTrainer

    arch, n_layers = RESUME_FULL
    cfg = get_arch(arch).replace(n_layers=n_layers)
    K, bpc, seq = K_CLIENTS, BATCH_PER_CLIENT, SEQ
    root = ROOT / "build" / "chip_smoke_ckpt_full"
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    same = lambda a, b: all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(T.leaves(a), T.leaves(b)))
    try:
        tr = SDFLMQTrainer(cfg, K, 1, bpc, seq, ckpt_dir=str(root),
                           device=dev)
        save_s, real_save = [], tr.ckpt.save

        def timed_save(*a, **kw):
            t = time.perf_counter()
            out = real_save(*a, **kw)
            save_s.append(time.perf_counter() - t)
            return out
        tr.ckpt.save = timed_save
        ms = tr.run()
        newest = root / "step_1"
        files = sorted(newest.iterdir())
        nbytes = sum(f.stat().st_size for f in files)
        tensors = [t for t in T.leaves(tr.state) if torch.is_tensor(t)]
        state_bytes = sum(t.numel() * t.element_size() for t in tensors)
        size = lambda t: t.numel() * t.element_size()
        largest = max(size(t) for t in tensors)
        # the codec alone, one thread, on 64 MiB of the largest weight
        # (random bf16) and of the largest moment (f32, many zeros)
        codec_MBps = {}
        for name, tree in (("params", tr.state["params"]),
                           ("moment", tr.state["opt"])):
            big = max(T.leaves(tree), key=size)
            _, raw = CK._raw(big.reshape(-1)[:(64 << 20) // big.element_size()])
            t = time.perf_counter()
            CK._comp(raw)
            codec_MBps[name] = len(raw) / (time.perf_counter() - t) / 1e6
        other = SDFLMQTrainer(cfg, K, 1, bpc, seq, seed=1, device=dev)
        differed = not same(other.state, tr.state)
        torch.cuda.synchronize()
        t = time.perf_counter()
        CK.restore_checkpoint(str(newest), other.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        equal = same(other.state, tr.state)
        params = sum(t[0].numel() for t in T.leaves(tr.state["params"]))
        del tr, other
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "resume_full", "arch": cfg.name, "n_layers": n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "clients": K,
           "batch_per_client": bpc, "seq": seq, "loss": ms[0]["loss"],
           "round_s": ms[0]["time_s"], "params_per_client": params,
           "state_bytes": state_bytes, "largest_leaf_bytes": largest,
           "bytes_written": nbytes, "files": len(files),
           "codec": CK.CODEC, "codec_MBps_one_thread": codec_MBps,
           "workers": CK.WORKERS, "save_s": save_s,
           "save_GBps": state_bytes / save_s[0] / 1e9 if save_s else None,
           "restore_s": restore_s,
           "restore_GBps": state_bytes / restore_s / 1e9,
           "other_seed_differed": differed, "restored_equals_live": equal,
           "peak_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    emit(row)
    if (len(save_s) != 1 or not differed or not equal
            or not math.isfinite(row["loss"])):
        raise AssertionError(f"resume at published widths: {row}")
    return row


# the kernel cases serving adds: the flash forward at batch 4 in each
# model's head layout (whisper-small's encoder, cross-attention over its
# 1500 frames in training and prefill, and at one query in a decode step:
# non-causal, a key length ragged against the 64-key tile; internvl2-2b at
# batch 1 and 4), the WKV with u and the SSD at T = 1 (chunk 1) with a
# cached state (a decode step), and both at batch 4 over a prompt
SERVE_FLASH_CASES = [  # name, B, Sq, Sk, H, Kv, hd, causal, window
    ("qwen2", 4, 2048, 2048, 28, 4, 128, True, None),
    ("hymba", 4, 2048, 2048, 25, 5, 64, True, 1024),
    ("mixtral", 4, 2048, 2048, 48, 8, 128, True, 4096),
    ("whisper_encoder", 4, 1500, 1500, 12, 12, 64, False, None),
    ("whisper_cross", 4, 448, 1500, 12, 12, 64, False, None),
    ("whisper_decode_cross", 4, 1, 1500, 12, 12, 64, False, None),
    ("internvl2_b1", 1, 2048, 2048, 16, 8, 128, True, None),
    ("internvl2", 4, 2048, 2048, 16, 8, 128, True, None),
]
SERVE_WKV_CASES = [
    ("decode_rwkv6", 4, 1, 64, 64, 64, 1, True, False, True, "bfloat16"),
    ("decode_hymba", 4, 1, 25, 16, 64, 1, False, True, True, "bfloat16"),
    ("prefill_rwkv6", 4, 2048, 64, 64, 64, 128, True, False, False,
     "bfloat16"),
    ("prefill_hymba", 4, 2048, 25, 16, 64, 128, False, True, False,
     "bfloat16"),
]


def phase_serve_kernels(torch, dev):
    """The kernel cases that serving and the encoder-decoder and VLM
    families add, each against its plain version on the card and timed
    beside it, its bound and, for flash, ``scaled_dot_product_attention``:
    flash at ``SERVE_FLASH_CASES`` (bf16 tolerance as ``phase_flash``), and
    the WKV kernel at serving's shapes (``phase_wkv``'s tolerance)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.kernels.flash_attn.ref import attention_ref
    gen = torch.Generator(device=dev).manual_seed(7)
    flash = {}
    for name, B, Sq, Sk, H, Kv, hd, causal, window in SERVE_FLASH_CASES:
        mk = lambda *s: torch.randn(s, generator=gen, device=dev,
                                    dtype=torch.bfloat16)
        q, k, v = mk(B, Sq, H, hd), mk(B, Sk, Kv, hd), mk(B, Sk, Kv, hd)
        o, lse = ops.flash_fwd(q, k, v, causal, window)
        o_ref, lse_ref = attention_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        o_err = float((o.float() - o_ref.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        flops = _flash_flops(B, Sq, Sk, H, hd, causal, window)
        nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * 2 \
            + lse.numel() * 4
        bound_ms = max(flops / PEAK_BF16_FLOP_S, nbytes / PEAK_BYTES_S) * 1e3
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        keep = None
        if causal:
            qp, kp = torch.arange(Sq, device=dev), torch.arange(Sk, device=dev)
            keep = (qp[:, None] >= kp[None, :]) & (
                (qp[:, None] - kp[None, :] < window) if window
                else torch.ones((), dtype=torch.bool, device=dev))
        ms = time_ms(torch, lambda: ops.flash_fwd(q, k, v, causal, window),
                     10)
        row = {"case": f"flash_{name}", "shape_q": [B, Sq, H, hd],
               "shape_kv": [B, Sk, Kv, hd], "causal": causal,
               "window": window,
               "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
               "o_tol": 2e-2, "lse_tol": 1e-3, "kernel_ms": ms,
               "plain_ms": time_ms(
                   torch, lambda: attention_ref(q, k, v, causal, window), 2),
               "library_ms": time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=keep, enable_gqa=True), 10),
               "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
               "bound_by": "operations" if flops / PEAK_BF16_FLOP_S
               > nbytes / PEAK_BYTES_S else "bytes",
               "bound_share": bound_ms / ms}
        emit({"phase": "serve_flash", **row})
        if o_err > 2e-2 or lse_err > 1e-3:
            raise AssertionError(f"flash kernel disagrees: {row}")
        flash[name] = row
        del q, k, v, o, lse, o_ref, lse_ref, qt, kt, vt
        torch.cuda.empty_cache()
    wkv = phase_wkv(torch, dev, SERVE_WKV_CASES, "serve_wkv", seed=8)
    return flash, wkv


SERVE_REQUESTS, SERVE_BATCH, SERVE_MAX_NEW = 8, 4, 32
SERVE_PROMPT = (1536, 2048)        # prompt lengths, drawn from the seed
# phase, arch, layers, prompt lengths, max_seq: published widths and
# depth, but mixtral-8x22b, cut to 4 of its 56 layers (all 56 hold 281 GB
# of bf16 weights); whisper-small's prompts fit its 448-token text context
SERVE_CELLS = [
    ("serve_qwen2", "qwen2-7b", None, SERVE_PROMPT, None),
    ("serve_rwkv6", "rwkv6-7b", None, SERVE_PROMPT, None),
    ("serve_hymba", "hymba-1.5b", None, SERVE_PROMPT, None),
    ("serve_mixtral", "mixtral-8x22b", 4, SERVE_PROMPT, None),
    ("serve_whisper", "whisper-small", None, (4, 224), 448),
    ("serve_internvl2", "internvl2-2b", None, SERVE_PROMPT, None),
]
SERVE_PROFILE_STEPS = 8
# The bf16 check of the cache path against the parallel path, in relative
# L2 of a logit row, ||a - b|| / ||b||: at 28-32 layers of random weights
# bf16 rounding alone moves a row by a few % (GEMV against GEMM order,
# decode's f32 attention over a bf16 cache against the bf16 flash kernel),
# so the yardstick is measured in the same run: ``forward`` on f32 copies
# of the weights is the exact row, and a decode step may be no farther
# from it than SERVE_NOISE_FACTOR times the bf16 ``forward``'s own
# distance from it
SERVE_NOISE_FACTOR = 2.0


def _logit_err(torch, got, want):
    g, w = got.float().reshape(-1), want.float().reshape(-1)
    return {"rel_l2": float((g - w).norm() / w.norm()),
            "max_abs_err": float((g - w).abs().max()),
            "max_abs": float(w.abs().max()),
            "argmax_equal": bool(g.argmax() == w.argmax())}


def _serve_check(torch, dev, cfg, params, params32, prompt, layouts,
                 fault=None, extra=None):
    """One request through prefill on the card (with the frontend inputs
    in ``extra``, if any), then one decode step from each cache layout in
    ``layouts`` ({name: fn(cache, S) -> cache}, each given its own copy of
    the prefilled cache).  -> {"prefill": prefill's
    logits against bf16 ``forward`` over the same S tokens, "noise": bf16
    ``forward`` over S + 1 tokens against the f32 one at position S,
    "decode": {name: the step against the f32 ``forward``}, "held": every
    layout but ``fault`` within the tolerance}, and the steps' logits."""
    from repro_torch.models import model_api
    mod = model_api.get_model(cfg)
    with torch.inference_mode():
        toks = torch.from_numpy(prompt[None].astype("int32")).to(dev)
        S = toks.shape[1]
        extra = extra or {}
        plog, cache = mod.prefill(cfg, params, {"tokens": toks, **extra})
        flog = mod.forward(cfg, params, {"tokens": toks, **extra})[0][:, -1]
        pre = _logit_err(torch, plog, flog)
        del flog
        tok = plog.argmax(-1).to(torch.int32)[:, None]
        batch = {"token": tok, "pos": torch.full((1,), S, dtype=torch.int32,
                                                 device=dev)}
        decoded = {}
        for name, fn in layouts.items():
            copy = fn({k: v.clone() for k, v in cache.items()}, S)
            decoded[name] = mod.decode_step(cfg, params, copy, batch)[0]
            del copy
        del cache
        ext = {"tokens": torch.cat([toks, tok], dim=1), **extra}
        f16 = mod.forward(cfg, params, ext)[0][:, -1]
        f32 = mod.forward(cfg, params32, ext)[0][:, -1]
    noise = _logit_err(torch, f16, f32)
    dec = {name: _logit_err(torch, d, f32) for name, d in decoded.items()}
    tol = SERVE_NOISE_FACTOR * noise["rel_l2"]
    return {"prefill": pre, "noise": noise, "decode": dec, "tol_rel_l2": tol,
            "held": pre["rel_l2"] <= tol
            and all(d["rel_l2"] <= tol for k, d in dec.items()
                    if k != fault)}, decoded


def _fault_size(torch, dev, cfg, params32, prompt, fixed):
    """A reference fault's size on one decode step, in f32 (no bf16 noise
    to hide it): the step from the cache as the reference leaves it
    against the step from the layout ``fixed`` repairs."""
    from repro_torch.models import model_api
    mod = model_api.get_model(cfg)
    with torch.inference_mode():
        toks = torch.from_numpy(prompt[None].astype("int32")).to(dev)
        S = toks.shape[1]
        plog, cache = mod.prefill(cfg, params32, {"tokens": toks})
        batch = {"token": plog.argmax(-1).to(torch.int32)[:, None],
                 "pos": torch.full((1,), S, dtype=torch.int32, device=dev)}
        steps = [mod.decode_step(cfg, params32, fn(
            {k: v.clone() for k, v in cache.items()}, S), batch)[0]
            for fn in (_as_is, fixed)]
    return _logit_err(torch, *steps)


def _as_is(cache, S):
    return cache


def _padded(cache, S):
    from repro_torch.models import kvcache as kvc
    return kvc.pad_cache(cache, S + 2)


def _ring(cache, S):
    """A windowed prefill cache laid out as decode's ring expects it:
    position p at slot p % W (prefill keeps position S - W + i at slot i,
    R3)."""
    W = cache["k"].shape[2]
    out = dict(cache)
    for key, dim in (("k", 2), ("v", 2), ("kv_pos", 1)):
        out[key] = cache[key].roll(S % W, dims=dim)
    return out


def _profile_decode(torch, dev, engine, prompts):
    """SERVE_PROFILE_STEPS decode steps after a prefill of one batch,
    under ``torch.profiler``: device busy time, the profiled wall time,
    and the top kernels."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch.models import kvcache as kvc
    cfg, mod = engine.cfg, engine.model
    B = len(prompts)
    S = max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    with torch.inference_mode():
        logits, cache = mod.prefill(cfg, engine.params,
                                    {"tokens": torch.from_numpy(toks).to(dev),
                                     **engine._extra_inputs(B, S)})
        if cfg.window is None and cfg.family != "rwkv":
            cache = kvc.pad_cache(cache, S + SERVE_PROFILE_STEPS + 2)
        cur = logits.argmax(-1).to(torch.int32)

        def step(i):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            return mod.decode_step(cfg, engine.params, cache,
                                   {"token": cur[:, None], "pos": pos})[0] \
                .argmax(-1).to(torch.int32)
        cur = step(0)                                   # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, SERVE_PROFILE_STEPS + 1):
                cur = step(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    launches = sum(e.count for e in kernels)
    return {"steps": SERVE_PROFILE_STEPS, "wall_s_profiled": wall,
            "device_busy_s": busy, "idle_share_profiled": 1 - busy / wall,
            "device_ms_per_step": busy / SERVE_PROFILE_STEPS * 1e3,
            "kernels_per_step": launches / SERVE_PROFILE_STEPS,
            "top_kernels_ms": [[e.key[:80], _dev_us(e) / 1e3, e.count]
                               for e in top]}


def phase_serve(torch, dev, phase, arch, n_layers, prompt_lens=SERVE_PROMPT,
                max_seq=None):
    """Eight requests (prompts of ``prompt_lens`` tokens from the seed, 32
    new tokens each) through ``ServeEngine`` at batch 4, two batches, on
    bf16 weights at published widths from a seed; whisper-small and
    internvl2-2b get the engine's stub inputs (zero frames or patches, as
    the reference's engine).  ``max_seq`` (by default the longest prompt
    and its new tokens) keeps a full-attention cache from wrapping.  The launch counters are set to 0 just before the
    engine runs and read just after; then the decode steps are profiled,
    and one request is checked through prefill and one decode step against
    ``forward`` (``_serve_check``; the tolerance is SERVE_NOISE_FACTOR
    times bf16 ``forward``'s own distance from an f32 ``forward`` on the
    same weights).  hymba is checked at a 2048-token prompt, where its
    window ring holds, and at
    the first request whose length the window does not divide, from the
    ring laid out as decode expects it; R3's size there is the decode step
    from prefill's layout against the one from the ring, in bf16 and in
    f32 (``_fault_size``).  mixtral is checked with a capacity factor of
    E / top_k (no assignment dropped, as at decode: forward's drops would
    differ from decode's), padded; R4's size is the step from the
    unpadded cache the engine leaves against the padded one.  whisper and
    internvl2 are checked with random frames or patches from the seed (zero
    ones project to exactly 0 at zero-initialised biases and would leave
    the encoder, the cross-attention and the injection unchecked)."""
    import dataclasses
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model_api, moe
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch(arch)
    reduced = []
    if n_layers is not None:
        reduced = [f"depth {n_layers} of {cfg.n_layers}"]
        cfg = cfg.replace(n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model_api.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = T.leaves(params)
    weight_bytes = sum(t.numel() * t.element_size() for t in weights)
    # what a decode step reads: every weight but the encoder's and the
    # patch projection, and (encoder-decoder) the batch's cross cache
    nbytes = lambda t: t.numel() * t.element_size()
    step_bytes = sum(nbytes(t) for path, t in T.leaves_with_path(params)
                     if path[0] not in ("enc_in", "enc_layers", "enc_norm",
                                        "vis_proj"))
    if cfg.family == "encdec":
        step_bytes += 2 * 2 * cfg.n_layers * SERVE_BATCH \
            * cfg.frontend.n_tokens * cfg.n_kv_heads * cfg.head_dim
    rng = np.random.default_rng(0)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    engine = ServeEngine(cfg, params, batch_size=SERVE_BATCH,
                         max_seq=max_seq or prompt_lens[1] + SERVE_MAX_NEW + 1,
                         device=dev)
    reset_launches()
    moe.reset_stats()
    batches, done = [], []
    for b in range(0, SERVE_REQUESTS, SERVE_BATCH):
        before = dict(engine.stats)
        for p in prompts[b:b + SERVE_BATCH]:
            engine.submit(p, SERVE_MAX_NEW)
        done += engine.run()
        batches.append({k: engine.stats[k] - before[k] for k in
                        ("prefill_tokens", "prefill_s", "decode_steps",
                         "decode_s")})
    torch.cuda.synchronize()
    launches = read_launches(("flash_fwd", "wkv6", "ssm_scan"))
    moe_calls = moe.read_stats()["calls"]
    peak = torch.cuda.max_memory_allocated(dev)
    st = engine.stats
    bound_ms = step_bytes / PEAK_BYTES_S * 1e3
    decode_ms = st["decode_s"] / st["decode_steps"] * 1e3
    profile = _profile_decode(torch, dev, engine, prompts[:SERVE_BATCH])

    # each check holds the layout the engine decodes from (for hymba's R3
    # prompt, the ring as decode expects it); a fault's size is the step
    # from the reference's layout against the one from the fixed layout
    params32 = T.tree_map(lambda t: t.float(), params)
    checks, fault = {}, {}
    if cfg.family == "hybrid":
        hold = rng.integers(0, cfg.vocab, 2 * cfg.window).astype(np.int32)
        checks["window_multiple"], _ = _serve_check(
            torch, dev, cfg, params, params32, hold, {"as_is": _as_is})
        r3 = next(p for p in prompts if len(p) % cfg.window)
        checks["ring"], dec = _serve_check(
            torch, dev, cfg, params, params32, r3,
            {"ring": _ring, "as_is": _as_is}, fault="as_is")
        fault["r3"] = {"prompt_len": len(r3),
                       "bf16": _logit_err(torch, dec["as_is"], dec["ring"]),
                       "f32": _fault_size(torch, dev, cfg, params32, r3,
                                          _ring)}
    elif cfg.moe is not None:
        nodrop = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        checks["padded"], dec = _serve_check(
            torch, dev, nodrop, params, params32, prompts[0],
            {"padded": _padded, "as_is": _as_is}, fault="as_is")
        fault["r4"] = {"prompt_len": len(prompts[0]),
                       "bf16": _logit_err(torch, dec["as_is"], dec["padded"]),
                       "f32": _fault_size(torch, dev, nodrop, params32,
                                          prompts[0], _padded)}
    elif cfg.frontend is not None:
        fe, gen = cfg.frontend, torch.Generator(device=dev).manual_seed(9)
        name, n = (("frames", fe.n_tokens) if cfg.family == "encdec"
                   else ("patches", min(fe.n_tokens, len(prompts[0]))))
        extra = {name: torch.randn((1, n, fe.feat_dim), generator=gen,
                                   device=dev).to(torch.bfloat16)}
        checks["request0"], _ = _serve_check(
            torch, dev, cfg, params, params32, prompts[0],
            {"engine": _padded}, extra=extra)
    else:
        layout = _as_is if cfg.family == "rwkv" else _padded
        checks["request0"], _ = _serve_check(
            torch, dev, cfg, params, params32, prompts[0],
            {"engine": layout})
    del params32
    held = all(c["held"] for c in checks.values())

    L = cfg.n_layers
    steps_per_batch = SERVE_MAX_NEW
    n_batches = len(batches)
    # a flash launch a layer over more than 1024 keys: every prefill
    # layer; whisper's encoder and cross layers (1500 frames) at prefill
    # and its cross layers at each decode step, its decoder's
    # self-attention (at most 257 keys) being quadratic
    flash = {"dense": L, "moe": L, "hybrid": L, "vlm": L,
             "encdec": cfg.n_enc_layers + L * (1 + steps_per_batch)}
    want = {"flash_fwd": flash.get(cfg.family, 0) * n_batches,
            "wkv6": L * (1 + steps_per_batch) * n_batches
            if cfg.family == "rwkv" else 0,
            "ssm_scan": L * (1 + steps_per_batch) * n_batches
            if cfg.family == "hybrid" else 0}
    want_moe = ((L - cfg.moe.first_k_dense) * (1 + steps_per_batch)
                * n_batches if cfg.moe else 0)
    row = {"phase": phase, "arch": cfg.name, "family": cfg.family,
           "n_layers": L, "reduced": reduced, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "window": cfg.window,
           "max_seq": engine.max_seq, "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
           "max_new": SERVE_MAX_NEW, "prompt_lens": [int(n) for n in lens],
           "params": sum(t.numel() for t in weights),
           "weight_bytes": weight_bytes, "init_s": init_s,
           "prefill_tokens_s": st["prefill_tokens"] / st["prefill_s"],
           "ttft_s_per_batch": [b["prefill_s"] for b in batches],
           "decode_ms_per_step": decode_ms,
           "decode_ms_per_step_per_batch": [
               b["decode_s"] / b["decode_steps"] * 1e3 for b in batches],
           "decode_tokens_s": SERVE_BATCH * st["decode_steps"]
           / st["decode_s"],
           "decode_bound_ms": bound_ms, "decode_step_bytes": step_bytes,
           "decode_bound_share": bound_ms / decode_ms,
           "peak_memory_allocated": peak, "launches": launches,
           "moe_calls": moe_calls, "stats": st,
           "tokens_out": sum(len(r.out) for r in done),
           "check_noise_factor": SERVE_NOISE_FACTOR, "checks": checks,
           "checks_held": held, "reference_fault": fault}
    emit(row)
    emit({"phase": f"{phase}_profile", "decode_ms_per_step_unprofiled":
          decode_ms, **profile})
    del engine, params, weights
    if launches != want or moe_calls != want_moe:
        raise AssertionError(f"{phase}: launches {launches}, MoE calls "
                             f"{moe_calls}; want {want}, {want_moe}")
    if (not held or row["tokens_out"] != SERVE_REQUESTS * SERVE_MAX_NEW
            or not all(r.done for r in done)):
        raise AssertionError(f"{phase}: {row}")
    if peak >= CARD_BYTES:
        raise AssertionError(f"{phase}: peak {peak} B")
    return launches


def kernel_rows(fed, flash, qagg, quant8, wkv, launches):
    """The ``kernels`` line: every kernel with its launches summed over the
    train cells (quant8 is on none: its launches there are read, and are
    0), its error against the plain version, and its times beside the
    bound.  wkv6 and ssm_scan are the one WKV kernel in its two forms, each
    at its path's shape."""
    rows = [
        {"name": "fedavg", "route": "cuda",
         "source": "src/repro_torch/csrc/fedavg.cu",
         "replaces": "src/repro/kernels/fedavg/fedavg.py:70",
         "launches": launches["fedavg"],
         "max_abs_err": fed["max_abs_err"], "ms": fed["kernel_ms"],
         "plain_ms": fed["plain_ms"], "bound_ms": fed["bound_ms"],
         "bound_by": "bytes", "library_ms": fed["library_ms"]},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn_fwd.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:60",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(flash["o_max_abs_err"], flash["lse_max_abs_err"]),
         "ms": flash["kernel_ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"]},
        {"name": "qagg", "route": "cuda",
         "source": "src/repro_torch/csrc/qagg.cu",
         "replaces": "src/repro/kernels/fedavg/fedavg.py:43",
         "launches": launches["qagg"],
         "max_abs_err": qagg["max_abs_err"], "ms": qagg["kernel_ms"],
         "plain_ms": qagg["plain_ms"], "bound_ms": qagg["bound_ms"],
         "bound_by": "bytes", "library_ms": None}]
    for op, line in (("quantize", 33), ("dequantize", 50)):
        rows.append({
            "name": op, "route": "cuda",
            "source": "src/repro_torch/csrc/quant8.cu",
            "replaces": f"src/repro/kernels/quant8/quant8.py:{line}",
            "launches": launches[op],
            "max_abs_err": quant8["max_abs_err"],
            "ms": quant8[f"{op}_ms"], "plain_ms": quant8[f"{op}_plain_ms"],
            "bound_ms": quant8[f"{op}_bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    for op, case, ref in (
            ("wkv6", "path_rwkv6", "src/repro/kernels/wkv6/wkv6.py:65"),
            ("ssm_scan", "path_hymba", "src/repro/kernels/ssm_scan/ops.py:15")):
        row = wkv[case]
        rows.append({
            "name": op, "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu", "replaces": ref,
            "launches": launches[op],
            "max_abs_err": max(row["o_max_abs_err"],
                               row["s_final_max_abs_err"]),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace each training round with torch.profiler "
                         "(tables under chiprun_out/; slows the rounds)")
    args = ap.parse_args(argv)

    # before the first cuBLAS call: the resume phase runs with
    # torch.use_deterministic_algorithms, which needs a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_line()
    phase_device(torch, dev, smi)
    fed = phase_fedavg(torch, dev)
    flash = phase_flash(torch, dev)
    qagg = phase_qagg(torch, dev)
    quant8 = phase_quant8(torch, dev)
    wkv = phase_wkv(torch, dev)
    phase_strategies(torch, dev)
    launches = {}
    for phase, arch, n_layers, schedule, strategy, fail_at in TRAIN_CELLS:
        for k, n in phase_train(torch, dev, phase, arch, n_layers, schedule,
                                strategy, fail_at, args.profile).items():
            launches[k] = launches.get(k, 0) + n
    for cell in FRONTEND_TRAIN_CELLS:
        for k, n in phase_train_frontend(torch, dev, *cell,
                                         args.profile).items():
            launches[k] = launches.get(k, 0) + n
    phase_resume(torch, dev)
    phase_resume_full(torch, dev)
    phase_serve_kernels(torch, dev)
    for cell in SERVE_CELLS:
        for k, n in phase_serve(torch, dev, *cell).items():
            launches[k] = launches.get(k, 0) + n
    emit({"kernels": kernel_rows(fed, flash, qagg, quant8, wkv, launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
