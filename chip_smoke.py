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
and restores the tree cell's qwen2-7b state at published widths (1 of 28
layers, K = 2; the tables' moments, each over 4 GiB, written as parts),
and six serving cells (qwen2-7b, rwkv6-7b, hymba-1.5b,
mixtral-8x22b at 4 layers, whisper-small, internvl2-2b) each serve 8
requests through ``ServeEngine``.  Last, the ``dist`` phase runs the rank
path (one client a card, NCCL) over every card of the host: on one card
two qwen2-7b rounds through the process group against the single-card
K = 1 round, bit for bit (a (1, 1) mesh: no model axis); on several,
one round of each schedule and strategy against the single-card round,
and the schedules' time at 12 of 28 layers; on four, also the ``model``
axis (``phase_tp``: a client split over cards): one round of each
schedule and strategy on a (2, 2) mesh against the single-card K = 2
round, and qwen2-7b at all 28 layers on a (1, 4) and a (2, 2) mesh; then
the MoE family and Adafactor on the model axis: mixtral-8x22b at one
layer on a (2, 2) mesh (experts split over a client's cards) under four
schedules and strategies against the single-card K = 2 rounds, and
internlm2-20b at all 48 layers, kimi-k2 (its dense layer and one MoE
layer of 384 experts) and mixtral-8x22b at 12 and 6 layers over four
cards; then the ``shared`` mode (``phase_shared``: one client a pod, its
parameters FSDP-split over the pod's data cards): mixtral-8x22b at one
layer on a (pod 2, data 2, model 1) mesh under four schedules and
strategies, qwen2-7b under AdamW, and mixtral on (1, 2, 2), two rounds
each against the single card; mixtral at the most layers that fit and
qwen2-7b at all 28 layers on (2, 2, 1).  RWKV6 and Hymba run there too:
on the model axis rwkv6-7b (its 64 heads split, the WKV kernel on a rank's
heads) under three schedules and strategies and hymba-1.5b (its 25 heads
whole on every rank) at one layer on (2, 2) against the single-card K = 2
rounds, and both at all 32 layers over four cards; in shared mode both at
one layer on (2, 2, 1) and rwkv6-7b on (1, 2, 2).  On one card the rank
path also runs mixtral-8x22b under Adafactor against the single-card K = 1
trainer, bit for bit.  Last, ``phase_serve_tp`` serves on ranks: on one
card each family's engine at one layer on a (1, 1) mesh against the plain
engine, bit for bit; on four, qwen2-7b (its cache split on its sequence
and on its kv heads), rwkv6-7b, hymba-1.5b and (on (2, 2), shared mode)
mixtral-8x22b at one layer on (1, 4) and (2, 2) against the single card,
teacher-forced, and mixtral-8x22b at 28 of 56 layers, qwen2-7b at 28 (also
at a 32 768-token context) and rwkv6-7b at 32 served on (1, 4).  The
encoder-decoder and VLM families run on ranks too, through the round step
with frames or patches (``_FrontendTrainer``): whisper-small (one encoder
and one decoder layer) and internvl2-2b (one layer) against the single
card on (1, 4) and (2, 2) (``fe_agree``) and in shared mode on (2, 2, 1)
and (1, 2, 2) (``fe_shared_agree``), whisper-small at 12 + 12 layers and
internvl2-2b at 24 of 24 on (1, 4) and (2, 2) (``fe_time``); served, both
join the (1, 1) leg and ``serve_tp_agree`` (whisper's self cache split on
its kv heads or its sequence, its cross cache on its 1500 frames), and
``serve_tp_time`` serves them at full depth on (1, 4).  Last, the
``dryrun`` phase traces the ``tp_time`` and 32k serving cells on the meta
device (``launch/dryrun.py``, in a subprocess that sees no card) and, on
four cards, holds each rank's parameters, state and cache bytes, kernel
launches, op counts and peak against what those legs measured.
The ``adapter`` phase folds a LoRA bank (``fl_step.AdapterSpec``) into
qwen2-7b's 2-D leaves at published width against the same fold in f32 on
the CPU, and holds ``fl_step.build_eval_step`` against torch's
cross-entropy of the model's logits.  On three or more cards
``phase_tp3`` runs the model axis
where dims stay whole on a (1, 3) mesh: internlm2-20b (its q heads
straddling kv groups, its MLP whole), mixtral-8x22b (vocab and experts
whole), rwkv6-7b (every dim whole) and whisper-small (vocab whole) against
the single card (``tp3_agree``), the ``compressed`` aggregation on whole
blocks (``tp3_agg``), internlm2-20b under Adafactor at 22 of 48 layers
(``tp3_time``), and internlm2-20b served at 2 layers against the single
card and at all 48 (``serve_tp_agree``, ``serve_tp3_time``).  In every
agree and time leg of a model axis, each leaf with no dim on ``model``
must be equal bit for bit on the model ranks of its block.  On more than one card the strategies and ``resume_full`` phases
do not run (``ONE_CARD_ONLY``: the one-card run holds them).
Each phase prints JSON lines, and a ``walls`` line gives each phase's
wall time in seconds (and rank 0's of each leg a rank spawn ran); then one line lists every kernel, one line
gives the card's name and power limit as nvidia-smi reports them, and the
last line is ``{"ok": true, "device": ...}``.  Any failure raises and
exits non-zero; nothing runs on the CPU but the strategies' references.
The ranks start with the ``spawn`` method and import this file again, so
its work stays under ``if __name__ == "__main__":``.
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def adopt_orphans() -> None:
    """Makes this process the reaper of its descendants (Linux
    ``PR_SET_CHILD_SUBREAPER``): a process that a child leaves behind
    becomes this one's child, so ``stop_children`` finds it."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _children() -> list[tuple[int, str]]:
    """This process's children that have not ended, as (pid, name)."""
    me, found = str(os.getpid()), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
        except OSError:
            continue
        name = stat[stat.find("(") + 1:stat.rfind(")")]
        state, ppid = stat[stat.rfind(")") + 2:].split()[:2]
        if ppid == me and state != "Z":
            found.append((int(pid), name))
    return found


def _reap_until(deadline: float) -> None:
    """Reaps the children that end until none is left or ``deadline``."""
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] != 0:
                continue
        except ChildProcessError:
            return
        if time.monotonic() >= deadline:
            return
        time.sleep(0.05)


def stop_children(grace_s: float = 5.0) -> None:
    """Stops every process this run started that still runs, and reaps it:
    the ``spawn`` method's resource tracker (which ignores SIGTERM and
    would outlive the script until it reads its pipe's end), then any other
    child, with SIGTERM and after ``grace_s`` SIGKILL.  Each one stopped
    is named on stderr."""
    import signal
    from multiprocessing import resource_tracker
    gc.collect()        # the semaphores that are garbage unregister first
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None and \
            hasattr(tracker, "_stop"):
        print(f"chip_smoke: stopping the resource tracker (pid "
              f"{tracker._pid})", file=sys.stderr, flush=True)
        tracker._stop()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        _reap_until(time.monotonic())
        for pid, name in _children():
            print(f"chip_smoke: stopping leftover process {pid} ({name}) "
                  f"with {sig.name}", file=sys.stderr, flush=True)
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        _reap_until(time.monotonic() + grace_s)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(cost) -> tuple[float, str]:
    """(ms, what bounds it) of a kernel call whose ``ops.cost()`` is
    ``cost`` = (FLOPs, bytes): the larger of its FLOPs over the card's dense
    bf16 peak and its bytes over its HBM rate (``launch/mesh.py``), and
    ``"operations"`` or ``"bytes"``, whichever that is."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    t_ops, t_bytes = cost[0] / PEAK_FLOPS_BF16, cost[1] / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


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
        cost = ops.cost(K, N, dtype)
        bound_ms, bound_by = bound(cost)
        ms = time_ms(torch, lambda: ops.fedavg(x, w), 10 if N > 1e8 else 50)
        plain_ms = time_ms(torch, lambda: fedavg_ref(x, w),
                           3 if N > 1e8 else 20)
        row = {"case": name, "K": K, "N": N, "dtype": str(dtype),
               "max_abs_err": float(err.max()),
               "bit_exact": bool(torch.equal(got, want)),
               "kernel_ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gb_s": cost[1] / (ms * 1e-3) / 1e9}
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


def phase_flash(torch, dev):
    """The flash kernel against its plain version (``attention_ref``) at
    the paths' shapes (qwen2: causal; hymba: window 1024; mixtral: 48 q and
    8 kv heads, window 4096) and at odd ones, then the gradient through
    it.  The path shapes, and qwen2-7b's local heads on a model axis of 4
    and of 2 (7 q heads and 1 kv head, 14 and 2), are timed beside the
    plain version and ``scaled_dot_product_attention``, and so are a
    rank's heads on a model axis of 4 for mixtral-8x22b (12 q / 2 kv,
    window 4096), internlm2-20b (12 / 2) and kimi-k2 (16 / 2, head dim
    112); ``bound_share`` is the bound over the kernel's time."""
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
        # qwen2-7b's local heads on a model axis of 4 and of 2
        ("tp_local_heads_m4", 1, 2048, 2048, 7, 1, 128, torch.bfloat16, True,
         None, 0),
        ("tp_local_heads_m2", 1, 2048, 2048, 14, 2, 128, torch.bfloat16,
         True, None, 0),
        # a rank's heads on a model axis of 4: mixtral-8x22b (window 4096),
        # internlm2-20b, and kimi-k2 (head dim 112, padded to 128)
        ("moe_local_heads_mixtral", 1, 2048, 2048, 12, 2, 128,
         torch.bfloat16, True, 4096, 0),
        ("local_heads_internlm2", 1, 2048, 2048, 12, 2, 128, torch.bfloat16,
         True, None, 0),
        ("moe_local_heads_kimi", 1, 2048, 2048, 16, 2, 112, torch.bfloat16,
         True, None, 0),
        # the shared mode on (1, 2, 2): a data rank's row of its client's
        # batch, mixtral-8x22b's heads on a model axis of 2 (on (2, 2, 1)
        # it runs ``mixtral_window``'s shape)
        ("shared_local_heads_mixtral_m2", 1, 2048, 2048, 24, 4, 128,
         torch.bfloat16, True, 4096, 0),
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
        if name in ("path", "hymba_window", "mixtral_window",
                    "tp_local_heads_m4", "tp_local_heads_m2",
                    "moe_local_heads_mixtral", "local_heads_internlm2",
                    "moe_local_heads_kimi",
                    "shared_local_heads_mixtral_m2"):
            flops, nbytes = ops.cost(B, Sq, Sk, H, Kv, hd, dtype, causal,
                                     window, qo)
            bound_ms, bound_by = bound((flops, nbytes))
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
            row.update({
                "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
                "bound_by": bound_by,
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
    large-G leaf (w_gate/w_up), the shared mode's largest launch (two
    pods' data block of one mixtral-8x22b layer's ``w_gate``: 8 experts x
    3072 of the 6144 embed rows, 16384 wide) and odd shapes: bit-exact
    with the plain version, with kernel and plain times and the byte
    bound."""
    from repro_torch.kernels.fedavg import ops
    from repro_torch.kernels.fedavg.ref import qagg_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.tensor([0.7, 1.3, 2.0, 0.5], device=dev)
    cases = [("path_embed", 4, 152064, 3584), ("large_G", 4, 3584, 18944),
             ("shared_block", 2, 8 * 3072, 16384),
             ("G1", 4, 1000, 1), ("G7", 4, 999, 7), ("R1", 4, 1, 3584),
             ("scalar", 4, 1, 1)]
    path_row = None
    for name, K, R, G in cases:
        q = torch.randint(-127, 128, (K, R, G), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((K, R, 1), generator=gen, device=dev) * (2.0 / 127)
        wk = w[:K]
        got = ops.qagg(q, s, wk)
        want = qagg_ref(q, s, wk)
        torch.cuda.synchronize()
        cost = ops.qagg_cost(K, R, G)
        nbytes = cost[1]
        bound_ms, bound_by = bound(cost)
        row = {"case": name, "K": K, "R": R, "G": G,
               "bit_exact": bool(torch.equal(got, want)),
               "max_abs_err": float((got - want).abs().max()),
               "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
        if name in ("path_embed", "large_G", "shared_block"):
            ms = time_ms(torch, lambda: ops.qagg(q, s, wk), 10)
            row.update({"kernel_ms": ms,
                        "plain_ms": time_ms(torch,
                                            lambda: qagg_ref(q, s, wk), 3),
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
        q_bytes = ops.quantize_cost(n, dtype)[1]
        d_bytes = ops.dequantize_cost(n)[1]
        row = {"case": name, "n": n, "dtype": str(dtype),
               "padded_rows": q.shape[0] - -(-n // 256),
               "bit_exact": bool(exact), "max_abs_err": err,
               "quantize_bound_ms": bound(ops.quantize_cost(n, dtype))[0],
               "dequantize_bound_ms": bound(ops.dequantize_cost(n))[0]}
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


WKV_CASES = [  # name, B, T, H, dk, dv, chunk, use_u, per-head w, s0, dtype
    ("path_rwkv6", 1, 2048, 64, 64, 64, 128, True, False, False,
     "bfloat16"),
    ("path_hymba", 1, 2048, 25, 16, 64, 128, False, True, False, "bfloat16"),
    # rwkv6-7b's heads on a model rank at M = 2 and 4 (``lin_time``)
    ("tp2_rwkv6", 1, 2048, 32, 64, 64, 128, True, False, False, "bfloat16"),
    ("tp4_rwkv6", 1, 2048, 16, 64, 64, 128, True, False, False, "bfloat16"),
    ("odd_u", 2, 200, 3, 4, 8, 64, True, False, True, "float32"),
    ("odd_ssd", 2, 200, 3, 4, 8, 64, False, True, True, "float32"),
]


def phase_wkv(torch, dev, cases=WKV_CASES, phase="wkv", seed=4):
    """The chunked WKV kernel against its plain version (``ref.chunked``)
    at the two paths' shapes (rwkv6: per-channel decay with u; hymba's SSM
    branch: per-head decay, SSD form), at rwkv6's heads on a rank of a
    model axis of 2 and 4, and at odd shapes (B = 2, a ragged
    T = 200 with chunk 64, dk 4 / dv 8, a given s0).  Tolerance: 1e-4 of
    max |o| (and of max |s_final|), f32 sums in another order.
    ``bound_share`` is the bound over the kernel's time.  At rwkv6's path
    shape the kernel must refuse a scratch one float short of
    ``ops.scratch_floats``."""
    from repro_torch.kernels import _build
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
        flops, nbytes = ops.cost(B, T, H, dk, dv, C, w.shape[-1], use_u,
                                 with_s0, dtype)
        exps = ops.work(B, T, H, dk, dv, min(C, T), use_u)[1]
        bound_ms, bound_by = bound((flops, nbytes))
        row = {"case": name, "shape_rk": [B, T, H, dk],
               "shape_v": [B, T, H, dv], "w_last_dim": w.shape[-1],
               "chunk": C, "use_u": use_u, "s0": with_s0,
               "dtype": str(dtype), "o_max_abs_err": o_err,
               "s_final_max_abs_err": s_err, "o_tol": o_tol, "s_tol": s_tol,
               "bytes": nbytes, "flops": flops, "exps": exps,
               "bound_ms": bound_ms, "bound_by": bound_by}
        ms = time_ms(torch, lambda: ops.wkv_f32(r, k, v, w, u=u, s0=s0,
                                                chunk=C), 10)
        row.update({
            "kernel_ms": ms,
            "plain_ms": time_ms(
                torch, lambda: chunked(r, k, v, w, u=u, s0=s0, chunk=C), 2),
            "bound_share": row["bound_ms"] / ms,
            "gb_s": nbytes / (ms * 1e-3) / 1e9,
            "gexp_s": exps / (ms * 1e-3) / 1e9})
        if name == "path_rwkv6":
            # chunks of 64 rows here, so ``scratch_floats`` is exact: the
            # kernel must refuse one float less (cudaErrorInvalidValue)
            n = ops.scratch_floats(B, T, H, dk, dv, C)
            scratch = torch.empty(n, dtype=torch.float32, device=dev)
            row["short_scratch_status"] = getattr(_build.load(),
                                                  ops._FN[dtype])(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None, o.data_ptr(), sf.data_ptr(),
                scratch.data_ptr(), n - 1, B, T, H, dk, dv, dk, C,
                _build.stream_ptr(r))
            del scratch
            if row["short_scratch_status"] != 1:
                raise AssertionError(f"wkv kernel took too small a "
                                     f"scratch: {row}")
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


ADAPTER_ARCH = "qwen2-7b"
# eval_step's cross-entropy against torch's on the same logits: f32, the
# log-sum-exp over 152 064 columns and the mean summed in another order
EVAL_RTOL = 1e-5


def phase_adapter(torch, dev) -> dict:
    """``fl_step.AdapterSpec`` and ``fl_step.build_eval_step`` on one card.
    A rank-8 adapter bank (``adapter_decls``; ``lora_B`` drawn from the
    seed, so the fold is not the identity) folded by ``apply`` into
    qwen2-7b's 2-D leaves at published width (its two (152064, 3584)
    tables and its norms' scales stacked over layers, (L, 3584); the
    stacked weight matrices, 3-D, take none; depth cut to one layer) on
    the card, against the same fold computed in f32 on the CPU and cast
    to the leaf's dtype (compared on the card): within one bf16 ulp (the
    rank-8 dot products may sum in another order; TF32 is off).  Then
    ``eval_step`` on a batch of DIST_SEQ tokens from the seed, its flash
    launches counted, against ``F.cross_entropy`` of the model's own
    logits in f32 (computed apart from ``loss_fn``), within EVAL_RTOL.
    Returns those launches."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.core import fl_step
    from repro_torch.dist import sharding as shd
    from repro_torch.models import model_api

    cfg = get_arch(ADAPTER_ARCH).replace(n_layers=1)
    spec = fl_step.AdapterSpec(rank=8)
    gc.collect()
    torch.cuda.empty_cache()
    params = model_api.init_params(cfg, 0, dev)
    decls = spec.adapter_decls(model_api.param_decls(cfg))
    bank = shd.materialize(decls, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, t in bank.items():
        if name.endswith("lora_B"):
            t.normal_(generator=gen)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    folded = spec.apply(params, bank)
    torch.cuda.synchronize(dev)
    apply_s = time.perf_counter() - t0
    scale = spec.alpha / spec.rank
    named = lambda tree: {"/".join(p): t for p, t in T.leaves_with_path(tree)}
    got_all, base_all = named(folded), named(params)
    rows = []
    for name in sorted({k.rsplit("/", 1)[0] for k in bank}):
        base, got = base_all[name], got_all[name]
        a, b = bank[f"{name}/lora_A"].cpu(), bank[f"{name}/lora_B"].cpu()
        want = (base.cpu().float() + scale * (a @ b)).to(base.dtype).to(dev)
        d = (got.float() - want.float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(2.0 ** -126))) - 7)
        rows.append({"leaf": name, "shape": list(got.shape),
                     "dtype": str(got.dtype),
                     "elements_differing": int((d > 0).sum()),
                     "beyond_1_bf16_ulp": int((d > ulp).sum()),
                     "max_abs_err": float(d.max()),
                     "moved": int((got != base).sum())})
        del want, got, d, ulp
    adapted = [r["leaf"] for r in rows]
    stacked = [n for n, t in base_all.items() if t.dim() > 2]
    del folded, bank, got_all
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (1, DIST_SEQ + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
             "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    reset_launches()
    ce = fl_step.build_eval_step(cfg)(params, batch)
    torch.cuda.synchronize(dev)
    launches = read_launches()
    with torch.no_grad():
        logits = model_api.get_model(cfg).forward(cfg, params, batch)[0]
        want_ce = torch.nn.functional.cross_entropy(
            logits.float().flatten(0, 1), batch["labels"].long().flatten())
    del logits
    eval_rel = abs(float(ce) - float(want_ce)) / abs(float(want_ce))
    line = {"phase": "adapter", "arch": ADAPTER_ARCH, "n_layers": 1,
            "rank": spec.rank, "alpha": spec.alpha, "adapted": adapted,
            "stacked_leaves_adapted": [n for n in stacked if n in adapted],
            "apply_s": apply_s, "leaves": rows,
            "eval_ce": float(ce), "plain_ce": float(want_ce),
            "eval_rel_err": eval_rel, "eval_rtol": EVAL_RTOL,
            "eval_launches": launches}
    emit(line)
    if (adapted != sorted(n for n, t in base_all.items() if t.dim() == 2)
            or line["stacked_leaves_adapted"] or eval_rel > EVAL_RTOL
            or not math.isfinite(line["eval_ce"])
            or any(r["beyond_1_bf16_ulp"] or not r["moved"] for r in rows)
            or launches["flash_fwd"] != cfg.n_layers
            or any(n for k, n in launches.items() if k != "flash_fwd")):
        raise AssertionError(f"adapter: {line}")
    del params
    return launches


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


# arch, depth, clients: the tree cell's trainer (TRAIN_CELLS' "train":
# qwen2-7b at published widths, 1 of 28 layers) at K = 2.  qwen2-7b keeps
# separate input and output tables (1.32 B parameters a client), so a K = 4
# state is 52.9 GB and the live and the restored state do not fit one 80 GB
# card together; at K = 2 (26.5 GB) the four AdamW moments of the tables,
# 4.36 GB each, exceed one msgpack bin32 payload and are written as parts
RESUME_FULL = ("qwen2-7b", 1, 2)


def phase_resume_full(torch, dev):
    """What a checkpoint costs at published widths: one round of the tree
    cell's trainer at ``RESUME_FULL``'s K (the fedavg and flash kernels,
    counted), saved by the
    trainer's own ``CheckpointManager`` under ``build/``; the round's
    buffers freed, the checkpoint is restored into the state of a trainer
    drawn from another seed, which must equal the live state bit for bit.
    Fails unless a leaf was split into parts and both kernels launched."""
    from repro_torch import tree as T
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import SDFLMQTrainer

    arch, n_layers, K = RESUME_FULL
    cfg = get_arch(arch).replace(n_layers=n_layers)
    bpc, seq = BATCH_PER_CLIENT, SEQ
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
        reset_launches()
        ms = tr.run()
        torch.cuda.synchronize()
        launches = read_launches()
        round_peak = torch.cuda.max_memory_allocated(dev)
        newest = root / "step_1"
        files = sorted(newest.iterdir())
        nbytes = sum(f.stat().st_size for f in files)
        manifest = json.loads((newest / "manifest.json").read_text())
        names = ["/".join(p) for p, _ in T.leaves_with_path(tr.state)]
        split = {names[s["i"]]: len(s["parts"]) for s in manifest["leaves"]
                 if "parts" in s}
        tensors = [t for t in T.leaves(tr.state) if torch.is_tensor(t)]
        size = lambda t: t.numel() * t.element_size()
        state_bytes = sum(size(t) for t in tensors)
        largest = max(size(t) for t in tensors)
        # the codec alone, one thread, on 64 MiB of the largest weight
        # (random bf16) and of the largest moment (f32)
        codec_MBps = {}
        for name, tree in (("params", tr.state["params"]),
                           ("moment", tr.state["opt"])):
            big = max(T.leaves(tree), key=size)
            raw = CK._raw(big.reshape(-1)[:(64 << 20) // big.element_size()])
            t = time.perf_counter()
            CK._comp(raw)
            codec_MBps[name] = len(raw) / (time.perf_counter() - t) / 1e6
        tr._steps.clear()            # the round's buffers, before a second
        gc.collect()                 # K = 4 state comes onto the card
        torch.cuda.empty_cache()
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
    row = {"phase": "resume_full", "card": smi_line(), "arch": cfg.name,
           "n_layers": n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "clients": K, "batch_per_client": bpc, "seq": seq,
           "loss": ms[0]["loss"], "round_s": ms[0]["time_s"],
           "launches": {k: launches[k] for k in ("fedavg", "flash_fwd")},
           "params_per_client": params, "state_bytes": state_bytes,
           "largest_leaf_bytes": largest,
           "part_limit_bytes": CK.LEAF_BYTES_MAX,
           "split_leaves": split, "parts": sum(split.values()),
           "bytes_written": nbytes, "files": len(files),
           "codec": CK.CODEC, "codec_MBps_one_thread": codec_MBps,
           "workers": CK.WORKERS, "save_s": save_s,
           "save_GBps": state_bytes / save_s[0] / 1e9 if save_s else None,
           "restore_s": restore_s,
           "restore_GBps": state_bytes / restore_s / 1e9,
           "other_seed_differed": differed, "restored_equals_live": equal,
           "round_peak_memory_allocated": round_peak,
           "peak_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    emit(row)
    if (len(save_s) != 1 or not split or not differed or not equal
            or not math.isfinite(row["loss"])
            or not all(row["launches"].values())):
        raise AssertionError(f"resume at published widths: {row}")
    return launches


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
    # a rank's heads when serving on a model axis of 4 (phase_serve_tp)
    ("qwen2_rank4", 4, 2048, 2048, 7, 1, 128, True, None),
    ("mixtral_rank4", 4, 2048, 2048, 12, 2, 128, True, 4096),
    # a rank's heads on a model axis of 4 (whisper-small: 3 of 12; the
    # train cell's 448 tokens over 1500 frames) and of 4 and 2
    # (internvl2-2b: 4 / 2 and 8 / 4 of 16 / 8), training and prefill
    ("whisper_encoder_rank4", 4, 1500, 1500, 3, 3, 64, False, None),
    ("whisper_cross_rank4", 4, 448, 1500, 3, 3, 64, False, None),
    ("internvl2_rank4", 1, 2048, 2048, 4, 2, 128, True, None),
    ("internvl2_rank2", 1, 2048, 2048, 8, 4, 128, True, None),
    # a rank's heads on a model axis of 3 (phase_tp3): internlm2-20b's and
    # mixtral-8x22b's 16 q heads, which straddle kv groups of 6, each with
    # its own expanded kv head, training (B = 1) and internlm2's prefill
    # (B = 4); whisper-small's 4 of 12 heads
    ("internlm2_rank3", 1, 2048, 2048, 16, 16, 128, True, None),
    ("internlm2_rank3_b4", 4, 2048, 2048, 16, 16, 128, True, None),
    ("mixtral_rank3", 1, 2048, 2048, 16, 16, 128, True, 4096),
    ("whisper_encoder_rank3", 4, 1500, 1500, 4, 4, 64, False, None),
    ("whisper_cross_rank3", 4, 448, 1500, 4, 4, 64, False, None),
]
SERVE_WKV_CASES = [
    ("decode_rwkv6", 4, 1, 64, 64, 64, 1, True, False, True, "bfloat16"),
    ("decode_hymba", 4, 1, 25, 16, 64, 1, False, True, True, "bfloat16"),
    ("prefill_rwkv6", 4, 2048, 64, 64, 64, 128, True, False, False,
     "bfloat16"),
    ("prefill_hymba", 4, 2048, 25, 16, 64, 128, False, True, False,
     "bfloat16"),
    # rwkv6-7b's 16 heads a rank on a model axis of 4 (phase_serve_tp)
    ("decode_rwkv6_rank4", 4, 1, 16, 64, 64, 1, True, False, True,
     "bfloat16"),
    ("prefill_rwkv6_rank4", 4, 2048, 16, 64, 64, 128, True, False, False,
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
        flops, nbytes = ops.cost(B, Sq, Sk, H, Kv, hd, q.dtype, causal,
                                 window)
        bound_ms, bound_by = bound((flops, nbytes))
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
               "bound_by": bound_by, "bound_share": bound_ms / ms}
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
    ``layouts`` ({name: fn(prefill, S) -> cache}, where ``prefill(slots)``
    prefills a cache of its own, of ``slots`` slots or by default the
    prefill's own).  -> {"prefill": prefill's
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
        plog = mod.prefill(cfg, params, {"tokens": toks, **extra})[0]
        prefill = _prefiller(mod, cfg, params, {"tokens": toks, **extra})
        flog = mod.forward(cfg, params, {"tokens": toks, **extra})[0][:, -1]
        pre = _logit_err(torch, plog, flog)
        del flog
        tok = plog.argmax(-1).to(torch.int32)[:, None]
        batch = {"token": tok, "pos": torch.full((1,), S, dtype=torch.int32,
                                                 device=dev)}
        decoded = {}
        for name, fn in layouts.items():
            cache = fn(prefill, S)
            decoded[name] = mod.decode_step(cfg, params, cache, batch)[0]
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
        plog = mod.prefill(cfg, params32, {"tokens": toks})[0]
        prefill = _prefiller(mod, cfg, params32, {"tokens": toks})
        batch = {"token": plog.argmax(-1).to(torch.int32)[:, None],
                 "pos": torch.full((1,), S, dtype=torch.int32, device=dev)}
        steps = [mod.decode_step(cfg, params32, fn(prefill, S), batch)[0]
                 for fn in (_as_is, fixed)]
    return _logit_err(torch, *steps)


def _prefiller(mod, cfg, params, batch):
    """-> ``prefill(slots=None)``: a new prefilled cache of ``batch``, of
    ``slots`` slots (the layout ``whole``) or by default the family's own
    length."""
    from repro_torch.models import kvcache as kvc

    def prefill(slots=None):
        lay = None if slots is None else kvc.CacheLayout("whole", slots)
        return mod.prefill(cfg, params, batch, layout=lay)[1]
    return prefill


def _as_is(prefill, S):
    return prefill()


def _padded(prefill, S):
    """Room for the step: a full-attention cache as the engine sizes it."""
    return prefill(S + 2)


def _ring(prefill, S):
    """A windowed prefill cache laid out as decode's ring expects it:
    position p at slot p % W (prefill keeps position S - W + i at slot i,
    R3)."""
    cache = prefill()
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
    B = len(prompts)
    S = max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    with torch.inference_mode():
        logits, cache = engine.prefill(toks, SERVE_PROFILE_STEPS + 1)
        cur = logits.argmax(-1).to(torch.int32)

        def step(i):
            return engine.decode(cache, cur, S + i).argmax(-1).to(
                torch.int32)
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
    from repro_torch.launch.mesh import HBM_BW
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
    bound_ms = step_bytes / HBM_BW * 1e3
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


# --------------------------------------------------------------------------
# the rank path: one client a card, NCCL between the cards
# --------------------------------------------------------------------------

DIST_ARCH, DIST_SEQ = "qwen2-7b", 2048
# leg (a), at one layer and K = the cards: (schedule, strategy, failures),
# each held against the single-card K-client round on card 0
DIST_AGREE = [
    ("tree", "fedavg", {}), ("flat", "fedavg", {}), ("rs_ag", "fedavg", {}),
    ("compressed", "fedavg", {}), ("tree", "fedprox", {}),
    ("tree", "trimmed_mean", {0: ["c3"]}), ("tree", "multi_krum", {0: ["c3"]})]
# leg (b): the schedules' time at 12 of qwen2-7b's 28 layers (3.89 B
# parameters a client).  A rank holds its slot and AdamW moments (10 B a
# parameter) and, during the optimizer, every gradient, the updates made so
# far and three f32 temporaries of the stacked MLP leaf (L x 67.9 M
# elements): about 15.3 + 4.1 L GB, so 12 layers take about 64 GB and 16
# would take about 80.5 GB
DIST_TIME_LAYERS = 12
DIST_TIME_SCHEDULES = ("tree", "flat", "rs_ag", "compressed")
NVLINK4_LINK_BYTES_S = 25e9     # one NVLink 4 link, one direction
DIST_TIMEOUT_S = 900
TP_TIMEOUT_S = 1800     # a model-axis mesh runs every leg of its shape
EXACT_STRATEGIES = {"trimmed_mean", "multi_krum"}


def _slot_compare(torch, got, want) -> dict:
    """Leaf by leaf and chunk by chunk, two slots on one card: elements
    that differ; elements more than one bf16 ulp (of ``want``) apart, the
    largest such difference and the largest ``|want|`` among them; and
    elements beyond the sum's tolerance, the larger of one bf16 ulp and 4
    f32 ulps of the leaf's largest ``|want|`` (four f32 terms summed in
    another order differ by a few roundings of the terms, which a value
    near 0, after cancellation, turns into many of its own ulps)."""
    from repro_torch import tree as T
    diff = beyond = beyond_tol = 0
    err = beyond_err = beyond_at = 0.0
    finite = True
    step = 1 << 26
    for a, b in zip(T.leaves(got), T.leaves(want)):
        a, b = a.reshape(-1), b.reshape(-1)
        top = max(float(b[c0:c0 + step].float().abs().max())
                  for c0 in range(0, b.numel(), step))
        for c0 in range(0, a.numel(), step):
            x = a[c0:c0 + step].float()
            y = b[c0:c0 + step].float()
            finite &= bool(torch.isfinite(x).all() and torch.isfinite(y).all())
            d = (x - y).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                y.abs().clamp_min(2.0 ** -126))) - 7)
            far = d > ulp
            err = max(err, float(d.max()))
            diff += int((d > 0).sum())
            beyond += int(far.sum())
            beyond_tol += int((d > ulp.clamp_min(4 * 2.0 ** -23 * top)).sum())
            if far.any():
                beyond_err = max(beyond_err, float(d[far].max()))
                beyond_at = max(beyond_at, float(y[far].abs().max()))
    return {"exact": diff == 0 and finite, "finite": finite,
            "max_abs_err": err, "elements_differing": diff,
            "beyond_1_bf16_ulp": beyond,
            "beyond_1_bf16_ulp_max_err": beyond_err,
            "beyond_1_bf16_ulp_max_abs_value": beyond_at,
            "beyond_sum_tolerance": beyond_tol}


def _checksum(torch, tree) -> list:
    """Two integer sums of each leaf's bits (plain and position-weighted):
    equal slots give equal checksums."""
    from repro_torch import tree as T
    out = []
    for t in T.leaves(tree):
        bits = t.reshape(-1).view({2: torch.int16, 4: torch.int32}[
            t.element_size()])
        s0 = s1 = 0
        for c0 in range(0, bits.numel(), 1 << 26):
            v = bits[c0:c0 + (1 << 26)].to(torch.int64)
            pos = torch.arange(c0, c0 + v.numel(), device=v.device) % 65521
            s0 += int(v.sum())
            s1 += int((v * (pos + 1)).sum())
        out.append([s0, s1])
    return out


def _dist_world1(torch, mesh) -> dict:
    """One card: two rounds of the rank path (qwen2-7b, one layer, K = 1,
    through the NCCL process group) against two rounds of the single-card
    trainer at K = 1, bit for bit (every parameter and moment); then the
    across-ranks aggregation of the trained slot under each schedule
    against the single-card ``aggregate_params`` at K = 1."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.core import aggregation
    from repro_torch.core.topology import AggSchedule
    from repro_torch.launch.train import SDFLMQTrainer

    from repro_torch.dist import tensor_parallel as tpar

    cfg = get_arch(DIST_ARCH).replace(n_layers=1)
    dev = mesh.device
    # a (1, 1) mesh: no model axis, so the plain model code runs
    shape_ok = mesh.shape == {"data": 1, "model": 1} \
        and tpar.axis_for(cfg, mesh) is None
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    tr = SDFLMQTrainer(cfg, 1, ROUNDS, BATCH_PER_CLIENT, DIST_SEQ, seed=0,
                       mesh=mesh)
    ms = tr.run()
    torch.cuda.synchronize(dev)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    state = tr.state
    del tr
    one = SDFLMQTrainer(cfg, 1, ROUNDS, BATCH_PER_CLIENT, DIST_SEQ, seed=0,
                        device=dev)
    ms1 = one.run()
    equal = state["step"] == one.state["step"] and all(
        torch.equal(a, b) for a, b in zip(
            T.leaves({"o": state["opt"], "p": state["params"]}),
            T.leaves({"o": one.state["opt"], "p": one.state["params"]})))
    del one
    aggregate = {}
    w = torch.full((1,), 3.0, device=dev)        # not a unit weight
    for kind in ("tree", "flat", "rs_ag", "compressed"):
        sched = AggSchedule(kind, 1, (((0,),),) if kind == "tree" else ())
        mine = T.tree_map(lambda t: t.unsqueeze(0).clone(), state["params"])
        bank = T.tree_map(lambda t: t.unsqueeze(0).clone(), state["params"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        aggregation.aggregate_params(mine, w, sched, "fedavg", mesh=mesh)
        end.record()
        aggregation.aggregate_params(bank, w, sched, "fedavg")
        end.synchronize()
        aggregate[kind] = {
            "equal": all(torch.equal(a, b) for a, b in zip(
                T.leaves(mine), T.leaves(bank))),
            "ms": start.elapsed_time(end)}
        del mine, bank
    return {"mesh_shape": mesh.shape, "no_model_axis": shape_ok,
            "losses": [m["loss"] for m in ms],
            "single_device_losses": [m["loss"] for m in ms1],
            "round_s": [m["time_s"] for m in ms], "state_equal": equal,
            "aggregate": aggregate, "launches": launches, "peak": peak,
            "moe": _world1_moe(torch, mesh)}


def _replica(cfg):
    """``cfg`` in ``replica`` mode, the trainer CLI's: the MoE configs
    declare the ``shared`` mode (FSDP, one client a pod), which
    ``phase_shared`` runs; the legs that hold the model axis alone run
    them as replicas, one client a row of the data axis."""
    import dataclasses
    return cfg.replace(fl=dataclasses.replace(cfg.fl, mode="replica"))


def _world1_moe(torch, mesh) -> dict:
    """One card, the MoE family under Adafactor: two rounds of
    mixtral-8x22b (one layer) on the (1, 1) mesh against two rounds of the
    single-card trainer at K = 1, bit for bit (every parameter and
    Adafactor factor), and the same routing statistics."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import SDFLMQTrainer
    from repro_torch.models import moe

    cfg = _replica(get_arch(MOE_ARCH).replace(n_layers=1))
    dev = mesh.device
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    moe.reset_stats()
    tr = SDFLMQTrainer(cfg, 1, ROUNDS, BATCH_PER_CLIENT, DIST_SEQ, seed=0,
                       mesh=mesh)
    ms = tr.run()
    torch.cuda.synchronize(dev)
    launches, stats = read_launches(), moe.read_stats()
    peak = torch.cuda.max_memory_allocated(dev)
    state = tr.state
    del tr
    moe.reset_stats()
    one = SDFLMQTrainer(cfg, 1, ROUNDS, BATCH_PER_CLIENT, DIST_SEQ, seed=0,
                        device=dev)
    ms1 = one.run()
    stats1 = moe.read_stats()
    equal = state["step"] == one.state["step"] and all(
        torch.equal(a, b) for a, b in zip(
            T.leaves({"o": state["opt"], "p": state["params"]}),
            T.leaves({"o": one.state["opt"], "p": one.state["params"]})))
    del one, state
    return {"arch": MOE_ARCH, "n_layers": 1, "optimizer": cfg.optimizer,
            "losses": [m["loss"] for m in ms],
            "single_device_losses": [m["loss"] for m in ms1],
            "round_s": [m["time_s"] for m in ms], "state_equal": equal,
            "routing": stats, "single_device_routing": stats1,
            "launches": launches, "peak": peak}


def _dist_agree(torch, mesh) -> list:
    """Leg (a): one round of each ``DIST_AGREE`` case on the ranks against
    the single-card K-client round that rank 0 runs on its card first, from
    the same seed (bank) and batches."""
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.ft.failures import FailurePlan
    from repro_torch.launch.train import SDFLMQTrainer

    cfg = get_arch(DIST_ARCH).replace(n_layers=1)
    K, dev = mesh.world, mesh.device
    rows = []
    for sched, strat, fail in DIST_AGREE:
        kw = dict(seed=0, schedule_kind=sched, strategy=strat)
        want = None
        if mesh.rank == 0:
            gc.collect()
            torch.cuda.empty_cache()
            one = SDFLMQTrainer(cfg, K, 1, BATCH_PER_CLIENT, DIST_SEQ,
                                device=dev, failure_plan=FailurePlan(
                                    fail_at=dict(fail)), **kw)
            m1 = one.run()[0]
            want = (m1, T.tree_map(lambda t: t[0].clone(),
                                   one.state["params"]))
            del one
        dist.barrier()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        tr = SDFLMQTrainer(cfg, K, 1, BATCH_PER_CLIENT, DIST_SEQ, mesh=mesh,
                           failure_plan=FailurePlan(fail_at=dict(fail)), **kw)
        m = tr.run()[0]
        torch.cuda.synchronize(dev)
        row = {"schedule": sched, "strategy": strat,
               "fail_at": {str(r): c for r, c in fail.items()},
               "loss": m["loss"], "level_groups": m["level_groups"],
               "n_clients": m["n_clients"], "time_s": m["time_s"],
               "aggregate_ms": m.get("aggregate_ms"),
               "rank_ms": m["rank_ms"], "launches": read_launches(),
               "peak": torch.cuda.max_memory_allocated(dev),
               "leaves": len(T.leaves(tr.state["params"])),
               "checksum": _checksum(torch, tr.state["params"])}
        if want is not None:
            row.update(single_loss=want[0]["loss"],
                       single_level_groups=want[0]["level_groups"],
                       **_slot_compare(torch, T.tree_map(
                           lambda t: t[0], tr.state["params"]), want[1]))
        rows.append(row)
        del tr, want
    return rows


def _bytes_sent(kind, level_groups, rank, K, n, n_rows) -> int:
    """Bytes a rank sends in one aggregation of ``n`` f32 contributions
    (``n_rows`` quantization rows), reckoned for ring collectives: an
    all-reduce over g ranks sends 2 (g - 1) / g of the buffer, an
    all-gather (g - 1) times the rank's part."""
    if kind == "compressed":
        return (K - 1) * (n + 4 * n_rows)
    if kind == "tree":
        sizes = [next(len(g) for g in lvl if rank in g)
                 for lvl in level_groups]
    else:
        sizes = [K]
    return int(sum(2 * (g - 1) / g * 4 * n for g in sizes if g > 1))


def _dist_time(torch, mesh) -> list:
    """Leg (b): two rounds of each ``DIST_TIME_SCHEDULES`` schedule at
    ``DIST_TIME_LAYERS`` layers, one trainer a schedule."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import SDFLMQTrainer

    cfg = get_arch(DIST_ARCH).replace(n_layers=DIST_TIME_LAYERS)
    K, dev = mesh.world, mesh.device
    rows = []
    for sched in DIST_TIME_SCHEDULES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tr = SDFLMQTrainer(cfg, K, ROUNDS, BATCH_PER_CLIENT, DIST_SEQ,
                           seed=0, mesh=mesh, schedule_kind=sched)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        reset_launches()
        ms = tr.run()
        torch.cuda.synchronize(dev)
        shapes = [t.shape[1:] for t in T.leaves(tr.state["params"])]
        n = sum(math.prod(sh) for sh in shapes)
        n_rows = sum(math.prod(sh[:-1]) for sh in shapes)
        rows.append({
            "schedule": sched, "level_groups": ms[-1]["level_groups"],
            "params_per_client": n, "init_s": init_s,
            "round_s": [m["time_s"] for m in ms],
            "losses": [m["loss"] for m in ms],
            "aggregate_ms_rank": [m["rank_ms"].get("aggregate_ms")
                                  for m in ms],
            "aggregate_ms_max": [m.get("aggregate_ms") for m in ms],
            "bytes_sent": _bytes_sent(sched, ms[-1]["level_groups"],
                                      mesh.rank, K, n, n_rows),
            "peak": torch.cuda.max_memory_allocated(dev),
            "launches": read_launches(),
            "checksum": _checksum(torch, tr.state["params"])})
        del tr
    return rows

# ---- the model axis (tensor parallelism inside a client) -----------------
# leg (c): at one layer on a (2, 2) mesh, K = 2 clients of 2 ranks each,
# one round of each case against the single-card K = 2 round on card 0
TP_AGREE = [("tree", "fedavg"), ("flat", "fedavg"), ("rs_ag", "fedavg"),
            ("compressed", "fedavg"), ("tree", "trimmed_mean"),
            ("tree", "multi_krum")]
TP_AGREE_WEIGHTS = (3.0, 5.0)      # the aggregation leg's sample counts
# the whole round's loss against the single card: the row-parallel sums
# round once in f32 where one GEMM rounds once; bf16 activations
TP_LOSS_RTOL = 1e-3
# leg (d): qwen2-7b at all 28 layers; (mesh, schedule) runs of 2 rounds
TP_TIME = [((1, 4), "tree"), ((2, 2), "flat"), ((2, 2), "compressed")]
TP_TIME_LAYERS = 28


# the MoE family and Adafactor on the model axis.  Leg (e) ``moe_agree``:
# mixtral-8x22b at one layer on a (2, 2) mesh, K = 2, two rounds of each
# case against the single-card K = 2 rounds on card 0
MOE_ARCH = "mixtral-8x22b"
MOE_AGREE = [("tree", "fedavg"), ("flat", "fedavg"), ("compressed", "fedavg"),
             ("tree", "multi_krum")]
# round 1's globals, after a non-zero learning rate.  An Adafactor step is
# 5-50 bf16 ulps of a weight, and the client's bf16 gradients differ from
# the single card's by their rounding (the row-parallel sums round once in
# f32 where one GEMM does), so a few per cent of a step moves some values
# beyond 2 ulps (1.7-3.6 % of 1.45 B elements on four H100s): every element
# within 2 ulps and 2 steps of the learning rate, at most 10 % beyond 2
# ulps, which a wrong scale of the model group's factor sums would exceed
MOE_ROUND1_ULPS = 2
MOE_LR = 3e-4           # the trainer's peak rate, round 1's at 2 rounds
MOE_ROUND1_SHARE = 0.10
# dropped assignments against the single card: a near-tie of two experts'
# gates, flipped by the attention's f32 row-parallel sums, moves one
MOE_DROP_SHARE = 1e-3
# leg (f) ``moe_time``: (mesh, arch, layers, schedule), two rounds each.
# internlm2-20b at all 48 layers (4.97 B parameters a rank at (1, 4));
# kimi-k2 at 2 of 61 (its dense layer and one MoE layer, 96 of its 384
# experts a rank); mixtral-8x22b at the most layers under about 72 GB a
# rank (0.63 B parameters a layer a rank at (1, 4), about 5.4 GB a layer
# with the gradients, the updates and Adafactor's two f32 temporaries of
# the stacked expert leaf), and at half that on (2, 2)
MOE_TIME = [((1, 4), "internlm2-20b", 48, "tree"),
            ((1, 4), "kimi-k2-1t-a32b", 2, "tree"),
            ((1, 4), MOE_ARCH, 12, "tree"),
            ((2, 2), MOE_ARCH, 6, "flat")]


# RWKV6 and Hymba on the model axis (``replica`` mode, their declared
# one).  Leg ``lin_agree`` on a (2, 2) mesh: at one layer, K = 2, batch 1,
# AdamW, two rounds (round 0 at a learning rate of 0) against the
# single-card K = 2 rounds on card 0, under ``_emit_agree``'s checks:
# rwkv6-7b's 64 heads split (the WKV kernel on a rank's 32), hymba-1.5b's
# 25 / 5 heads whole on every rank (its attention and SSM branch whole,
# its MLP and vocab split)
LIN_AGREE = [("rwkv6-7b", "tree", "fedavg"),
             ("rwkv6-7b", "compressed", "fedavg"),
             ("rwkv6-7b", "tree", "multi_krum"),
             ("hymba-1.5b", "flat", "fedavg")]
# leg ``lin_time``: (mesh, arch, layers, schedule), two rounds each, at
# full depth: rwkv6-7b 1.96 B parameters a rank on (1, 4) and 3.84 B on
# (2, 2) (AdamW's moments, the gradients, the updates and three f32
# temporaries of the stacked ``cm.wk``: 64.19 GB a rank on H100s, so all
# 32 layers fit under about 72 GB), hymba-1.5b 0.72 B a rank on (1, 4)
LIN_TIME = [((1, 4), "rwkv6-7b", 32, "tree"),
            ((1, 4), "hymba-1.5b", 32, "tree"),
            ((2, 2), "rwkv6-7b", 32, "flat")]


def _path_launches(arch, n_layers, seq=DIST_SEQ) -> dict:
    """The flash and WKV launches a rank's two rounds of ``arch`` at
    ``n_layers`` make: each attention or scan twice a layer a round (the
    forward and remat's recompute; the backwards are plain).  The
    encoder-decoder, cut to ``n_layers`` encoder and decoder layers, runs
    flash in its encoder and its cross-attention (over 1500 frames) and in
    its decoder's self-attention where ``seq`` is above the threshold."""
    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    family = cfg.family
    per = 2 * n_layers * ROUNDS
    if family == "encdec":
        per *= 2 + (seq > cfg.attn_chunk_threshold)
    return {"flash_fwd": 0 if family == "rwkv" else per,
            "wkv6": per if family == "rwkv" else 0,
            "ssm_scan": per if family == "hybrid" else 0}


def _steps_beyond(torch, got, want) -> int:
    """Elements of ``got`` more than one bf16 ulp and one int8
    quantization step of their row (2 x the row's largest ``|want|`` /
    127) from ``want``: ``compressed`` quantizes the model block's rows,
    where the single card quantizes whole rows."""
    from repro_torch import tree as T
    n = 0
    for a, b in zip(T.leaves(got), T.leaves(want)):
        G = b.shape[-1] if b.dim() else 1
        a, b = a.reshape(-1, G), b.reshape(-1, G)
        step = max(1, (1 << 26) // G)
        for r0 in range(0, b.shape[0], step):
            x, y = a[r0:r0 + step].float(), b[r0:r0 + step].float()
            ulp = torch.exp2(torch.floor(torch.log2(
                y.abs().clamp_min(2.0 ** -126))) - 7)
            q = 2 * y.abs().amax(dim=1, keepdim=True) / 127
            n += int(((x - y).abs() > ulp + q).sum())
    return n


def _row_steps(torch, bank) -> list:
    """Per leaf of a client-stacked bank, the clients' largest ``|value|``
    in each row (the last dim) over 127: the bound on how far two int8
    quantizations of the weighted contributions, one of whole rows and one
    of a model block's rows, can move the weighted mean (each within half a
    step of each contribution's row scale)."""
    from repro_torch import tree as T
    out = []
    for t in T.leaves(bank):
        G = t.shape[-1] if t.dim() > 1 else 1
        rows = t.reshape(t.shape[0], -1, G)
        step = max(1, (1 << 26) // G)
        parts = [rows[:, r0:r0 + step].float().abs().amax(dim=(0, 2))
                 for r0 in range(0, rows.shape[1], step)]
        out.append(torch.cat(parts).div_(127).reshape(
            t.shape[1:-1] + (1,) if t.dim() > 1 else (1,)))
    return out


def _beyond(torch, got, want, ulps, steps=None, floor=0.0) -> int:
    """Elements of ``got`` more than ``ulps`` bf16 ulps (of ``want``), plus
    ``steps`` (per leaf, broadcast over a row) where given, plus ``floor``,
    from ``want``."""
    from repro_torch import tree as T
    n = 0
    for i, (a, b) in enumerate(zip(T.leaves(got), T.leaves(want))):
        G = b.shape[-1] if b.dim() else 1
        a, b = a.reshape(-1, G), b.reshape(-1, G)
        q = steps[i].reshape(-1, 1) if steps is not None else None
        step = max(1, (1 << 26) // G)
        for r0 in range(0, b.shape[0], step):
            x, y = a[r0:r0 + step].float(), b[r0:r0 + step].float()
            tol = ulps * torch.exp2(torch.floor(torch.log2(
                y.abs().clamp_min(2.0 ** -126))) - 7)
            if q is not None:
                tol = tol + q[r0:r0 + step]
            n += int(((x - y).abs() > tol + floor).sum())
    return n


def _tp_agree(torch, mesh) -> list:
    """Leg (c) on a (2, 2) mesh: one round of each ``TP_AGREE`` case
    against the single-card K = 2 round that rank 0 runs on its card
    first (its slot 0 broadcast to every rank, which compares its block);
    then the aggregation alone, on the ranks' blocks of one bank, against
    the single-card ``aggregate_params`` on the gathered block."""
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.core import aggregation, fl_step
    from repro_torch.core.clustering import build_tree
    from repro_torch.core.topology import AggSchedule, compile_tree
    from repro_torch.dist.sharding import local_block
    from repro_torch.launch.train import SDFLMQTrainer

    cfg = get_arch(DIST_ARCH).replace(n_layers=1)
    K, M, dev = mesh.shape["data"], mesh.shape["model"], mesh.device
    specs = T.leaves(fl_step.param_specs(cfg, {"data": 1, "model": M}))
    shapes = [t.shape for t in T.leaves(
        fl_step.abstract_state(cfg, 1)["params"])]
    named = lambda ts: {f"{i:03d}": t for i, t in enumerate(ts)}
    rows = []
    for sched, strat in TP_AGREE:
        kw = dict(seed=0, schedule_kind=sched, strategy=strat)
        want = single = None
        if mesh.rank == 0:
            gc.collect()
            torch.cuda.empty_cache()
            one = SDFLMQTrainer(cfg, K, 1, BATCH_PER_CLIENT, DIST_SEQ,
                                device=dev, **kw)
            single = one.run()[0]
            want = [t[0].clone() for t in T.leaves(one.state["params"])]
            del one
        single = mesh.broadcast(single and {
            k: single[k] for k in ("loss", "level_groups")})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        tr = SDFLMQTrainer(cfg, K, 1, BATCH_PER_CLIENT, DIST_SEQ, mesh=mesh,
                           **kw)
        m = tr.run()[0]
        torch.cuda.synchronize(dev)
        launches = read_launches()
        got = named(t[0] for t in T.leaves(tr.state["params"]))
        blocks = []
        for i, (g, spec) in enumerate(zip(got.values(), specs)):
            w = want[i] if want else torch.empty(shapes[i], dtype=g.dtype,
                                                 device=dev)
            dist.broadcast(w, src=0)
            blocks.append(local_block(w, spec, mesh))
        blocks = named(blocks)
        row = {"schedule": sched, "strategy": strat, "loss": m["loss"],
               "single_loss": single["loss"],
               "level_groups": m["level_groups"],
               "single_level_groups": single["level_groups"],
               "time_s": m["time_s"], "aggregate_ms": m.get("aggregate_ms"),
               "rank_ms": m["rank_ms"], "launches": launches,
               "peak": torch.cuda.max_memory_allocated(dev),
               "leaves": len(got), "checksum": _checksum(torch, got),
               **_slot_compare(torch, got, blocks)}
        if sched == "compressed":
            row["beyond_ulp_and_step"] = _steps_beyond(torch, got, blocks)
        rows.append(row)
        del tr, want, got, blocks
    # the aggregation alone: each rank's block of one bank (two clients
    # drawn apart) against aggregate_params on the column's gathered block
    gc.collect()
    torch.cuda.empty_cache()
    bank = fl_step.init_state(cfg, mesh, seed=1)["params"]
    w = torch.tensor(TP_AGREE_WEIGHTS, device=dev)
    clients = [f"c{i}" for i in range(K)]
    tree = compile_tree(build_tree("s", clients, clients,
                                   aggregator_ratio=0.5, levels=3))
    for row, (sched, strat) in zip(rows, TP_AGREE):
        schedule = tree if sched == "tree" else AggSchedule(sched, K)
        mine = T.tree_map(torch.clone, bank)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        aggregation.aggregate_params(mine, w, schedule, strat, mesh=mesh)
        end.record()
        whole = T.tree_map(lambda t: aggregation._gathered_rows(
            t.reshape(1, -1), K, mesh.group("data")).view((K,) + t.shape[1:]),
            bank)
        aggregation.aggregate_params(whole, w, schedule, strat)
        end.synchronize()
        cmp = _slot_compare(torch, T.tree_map(lambda t: t[0], mine),
                            T.tree_map(lambda t: t[0], whole))
        row["aggregation_alone"] = {
            "ms": start.elapsed_time(end), "exact": cmp["exact"],
            "elements_differing": cmp["elements_differing"],
            "beyond_sum_tolerance": cmp["beyond_sum_tolerance"],
            "checksum": _checksum(torch, mine)}
        del mine, whole
    return rows


def _tp_time(torch, mesh, sched) -> dict:
    """Leg (d): two rounds of qwen2-7b at ``TP_TIME_LAYERS`` layers on
    this mesh under ``sched``."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import SDFLMQTrainer

    cfg = get_arch(DIST_ARCH).replace(n_layers=TP_TIME_LAYERS)
    K, dev = mesh.shape["data"], mesh.device
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = SDFLMQTrainer(cfg, K, ROUNDS, BATCH_PER_CLIENT, DIST_SEQ, seed=0,
                       mesh=mesh, schedule_kind=sched)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    ms = tr.run()
    torch.cuda.synchronize(dev)
    leaves = T.leaves(tr.state["params"])
    out = {"schedule": sched, "mesh": mesh.shape, "init_s": init_s,
           "init_peak": init_peak,
           "params_per_rank": sum(t.numel() for t in leaves),
           "leaves": len(leaves),
           "round_s": [m["time_s"] for m in ms],
           "tokens_per_s": [m["tokens_per_s"] for m in ms],
           "losses": [m["loss"] for m in ms],
           "aggregate_ms_rank": [m["rank_ms"].get("aggregate_ms")
                                 for m in ms],
           "aggregate_ms_max": [m.get("aggregate_ms") for m in ms],
           "model_collectives_ms_rank": [
               m["rank_ms"].get("model_collectives_ms") for m in ms],
           "model_collectives_ms_max": [m.get("model_collectives_ms")
                                        for m in ms],
           "peak": torch.cuda.max_memory_allocated(dev),
           "round1_max_memory_allocated": ms[1]["max_memory_allocated"],
           "state_bytes": sum(t.numel() * t.element_size() for t in T.leaves(
               {k: tr.state[k] for k in ("params", "opt")})),
           "launches": read_launches(),
           "checksum": _checksum(torch, tr.state["params"])}
    if (tuple(mesh.shape.values()), sched) == DRYRUN_OP_ROUND:
        out["op_cost"] = _counted_round(torch, tr)
    del tr
    return out


def _counted_round(torch, tr) -> dict:
    """One more round of the trainer's step under ``OpCounter`` on the
    card (``launch/op_analysis.py``): the counts the dry run's meta trace
    of the same cell must equal.  The batch is on the card before the
    count starts, as the meta trace's is on the meta device."""
    from repro_torch.launch.op_analysis import OpCounter
    step = next(iter(tr._steps.values()))
    batch = {k: torch.from_numpy(v).to(tr.device) for k, v in
             tr.data.client_batch(tr._client(), tr.batch_per_client,
                                  tr.seq, tr.rounds).items()}
    torch.cuda.synchronize(tr.device)
    with OpCounter() as oc:
        tr.state, _ = step(tr.state, batch, tr.weights)
        torch.cuda.synchronize(tr.device)
    return oc.cost.to_dict()


def _whole_leaves(cfg, mesh) -> dict:
    """``cfg``'s parameter leaves with no dim on ``model`` on this mesh,
    index -> path: the one block every model rank of a client holds."""
    from repro_torch import tree as T
    from repro_torch.core import fl_step
    axis = fl_step.client_axis_for(cfg, mesh)
    one = {**mesh.shape, **({axis: 1} if axis else {})}
    on = lambda a: a == "model" or (isinstance(a, tuple) and "model" in a)
    return {i: "/".join(path) for i, (path, spec) in enumerate(
        T.leaves_with_path(fl_step.param_specs(cfg, one)))
        if not any(on(a) for a in spec)}


def _whole_differ(rows, M, sums) -> list:
    """The paths of the leaves with no dim on ``model`` (``row["whole"]``)
    whose checksums (``sums(row)``) differ between the M model ranks of
    one block (consecutive ranks: ``model`` is the innermost axis)."""
    bad = set()
    for g in range(0, len(rows), M):
        group = rows[g:g + M]
        for i, path in group[0]["whole"].items():
            if any(sums(r)[i] != sums(group[0])[i] for r in group[1:]):
                bad.add(path)
    return sorted(bad)


def _per(x, arch):
    """``x``, or where it is a dict of architectures, ``x[arch]``."""
    return x[arch] if isinstance(x, dict) else x


def _agree_rounds(torch, mesh, cases, bpc, trainer=None,
                  seq=DIST_SEQ) -> list:
    """Two rounds of each (config, schedule, strategy) case on this mesh
    (batch ``bpc`` a client, ``seq`` tokens: each a number or a dict by
    architecture) against the single-card trainer of the same K clients
    that rank 0 runs on its card first (``trainer``: ``SDFLMQTrainer`` or
    ``_FrontendTrainer``).  Slot 0 after each round is broadcast from rank
    0, and each rank compares its block (its place on the axes other than
    the client axis); so are the quantization steps of the initial bank's
    rows (``compressed``)."""
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.core import fl_step
    from repro_torch.dist.sharding import local_block
    from repro_torch.launch.train import SDFLMQTrainer
    from repro_torch.models import moe

    dev = mesh.device
    trainer = trainer or SDFLMQTrainer
    rows = []
    for cfg, sched, strat in cases:
        n_bpc, n_seq = _per(bpc, cfg.name), _per(seq, cfg.name)
        K = fl_step.n_clients_for(cfg, mesh)
        axis = fl_step.client_axis_for(cfg, mesh)
        one_client = {**mesh.shape, **({axis: 1} if axis else {})}
        specs = T.leaves(fl_step.param_specs(cfg, one_client))
        shapes = [t.shape for t in T.leaves(
            fl_step.abstract_state(cfg, 1)["params"])]
        named = lambda ts: {f"{i:03d}": t for i, t in enumerate(ts)}

        def run(tr):
            """-> (metrics, slot 0 after each round, routing)."""
            slots = []
            tr.on_round_end = lambda r, state: slots.append(
                [(t[0] if K > 1 else t).clone()
                 for t in T.leaves(state["params"])])
            moe.reset_stats()
            ms = tr.run()
            torch.cuda.synchronize(dev)
            return ms, slots, moe.read_stats()

        def from_rank0(ts, shapes, dtypes, specs=specs):
            """Rank 0's tensors on every rank, each rank's block of each."""
            out = []
            for i, (shp, dt) in enumerate(zip(shapes, dtypes)):
                w = ts[i] if ts is not None else torch.empty(
                    shp, dtype=dt, device=dev)
                dist.broadcast(w, src=0)
                out.append(local_block(w, specs[i], mesh))
            return named(out)

        kw = dict(seed=0, schedule_kind=sched, strategy=strat)
        want = single = steps = None
        if mesh.rank == 0:
            gc.collect()
            torch.cuda.empty_cache()
            one = trainer(cfg, K, ROUNDS, n_bpc, n_seq, device=dev, **kw)
            if sched == "compressed":
                steps = _row_steps(torch, one.state["params"])
            ms1, want, stats1 = run(one)
            single = {"losses": [m["loss"] for m in ms1],
                      "level_groups": [m["level_groups"] for m in ms1],
                      "routing": stats1}
            del one
        single = mesh.broadcast(single)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        tr = trainer(cfg, K, ROUNDS, n_bpc, n_seq, mesh=mesh, **kw)
        ms, slots, stats = run(tr)
        launches = read_launches()
        del tr
        dtypes = [t.dtype for t in slots[0]]
        row = {"arch": cfg.name, "schedule": sched, "strategy": strat,
               "K": K, "optimizer": cfg.optimizer,
               "losses": [m["loss"] for m in ms],
               "single_losses": single["losses"],
               "level_groups": [m["level_groups"] for m in ms],
               "single_level_groups": single["level_groups"],
               "routing": stats, "single_routing": single["routing"],
               "round_s": [m["time_s"] for m in ms],
               "aggregate_ms": [m.get("aggregate_ms") for m in ms],
               "data_collectives_ms": [m.get("data_collectives_ms")
                                       for m in ms],
               "model_collectives_ms": [m.get("model_collectives_ms")
                                        for m in ms],
               "launches": launches,
               "peak": torch.cuda.max_memory_allocated(dev),
               "leaves": len(slots[0]), "whole": _whole_leaves(cfg, mesh)}
        q = None
        if sched == "compressed":         # a step a row: whole rows
            q = list(from_rank0(
                steps, [tuple(s[:-1]) + (1,) for s in shapes],
                [torch.float32] * len(shapes),
                [tuple(sp[:-1]) + (None,) for sp in specs]).values())
        for r in range(ROUNDS):
            got = named(slots[r])
            blocks = from_rank0(want[r] if want else None, shapes, dtypes)
            cmp = _slot_compare(torch, got, blocks)
            if r == 0:
                cmp["beyond_ulp_and_step"] = None if q is None else \
                    _beyond(torch, got, blocks, 1, q)
            else:
                # under compressed the round-0 difference (at most q) carries
                # into round 1, whose own two quantizations differ by at most
                # the step of its contributions' rows: the global's (each
                # |value| at most 127 q) plus one Adafactor step, which adds
                # little over 127; 3 q bounds the two
                q3 = None if q is None else [3 * t for t in q]
                cmp["beyond_2_bf16_ulps"] = _beyond(
                    torch, got, blocks, MOE_ROUND1_ULPS, q3)
                cmp["beyond_round1_tolerance"] = _beyond(
                    torch, got, blocks, MOE_ROUND1_ULPS, q3, 2 * MOE_LR)
                cmp["elements"] = sum(t.numel() for t in got.values())
            cmp["checksum"] = _checksum(torch, got)
            row[f"round{r}"] = cmp
            del got, blocks
        rows.append(row)
        del want, slots, steps, q
    return rows


def _moe_agree(torch, mesh) -> list:
    """Leg (e) on a (2, 2) mesh: two rounds of mixtral-8x22b (one layer,
    Adafactor, ``replica`` mode) under each ``MOE_AGREE`` case against the
    single-card K = 2 trainer."""
    from repro_torch.configs.base import get_arch
    cfg = _replica(get_arch(MOE_ARCH).replace(n_layers=1))
    return _agree_rounds(torch, mesh, [(cfg, sched, strat)
                                       for sched, strat in MOE_AGREE],
                         BATCH_PER_CLIENT)


def _lin_agree(torch, mesh) -> list:
    """Leg ``lin_agree`` on a (2, 2) mesh: two rounds of each
    ``LIN_AGREE`` case (one layer, AdamW, ``replica`` mode) against the
    single-card K = 2 trainer."""
    from repro_torch.configs.base import get_arch
    return _agree_rounds(torch, mesh, [
        (_replica(get_arch(arch).replace(n_layers=1)), sched, strat)
        for arch, sched, strat in LIN_AGREE], BATCH_PER_CLIENT)


def _shared_agree(torch, mesh) -> list:
    """Leg (g) on this mesh: two rounds of each ``SHARED_AGREE`` case in
    ``shared`` mode (one layer, batch ``SHARED_BPC`` a client) against the
    single-card trainer."""
    from repro_torch.configs.base import get_arch
    return _agree_rounds(torch, mesh, [
        (_shared(get_arch(arch).replace(n_layers=1)), sched, strat)
        for arch, sched, strat in SHARED_AGREE[tuple(mesh.shape.values())]],
        SHARED_BPC)


# the encoder-decoder and VLM families on the model axis and in shared
# mode, at their train cells' traffic: whisper-small batch 4 a client of
# 448 tokens and 1500 frames, internvl2-2b batch 1 of 2048 tokens with 256
# patches (2 a client in shared mode, so each of two data ranks takes a
# row).  Leg ``fe_agree`` at one layer (whisper: one encoder and one
# decoder layer), two rounds (round 0 at a learning rate of 0) against the
# single-card rounds on card 0 under ``_emit_agree``'s checks, on (1, 4)
# (K = 1) and (2, 2) (K = 2); ``fe_shared_agree`` the same on (2, 2, 1) and
# (1, 2, 2) in shared mode
FE_SEQ = {"whisper-small": 448, "internvl2-2b": 2048}
FE_BPC = {"whisper-small": 4, "internvl2-2b": 1}
FE_SHARED_BPC = {"whisper-small": 4, "internvl2-2b": 2}
FE_AGREE = {(1, 4): [("whisper-small", "flat", "fedavg"),
                     ("internvl2-2b", "flat", "fedavg")],
            (2, 2): [("whisper-small", "tree", "fedavg"),
                     ("whisper-small", "compressed", "fedavg"),
                     ("internvl2-2b", "tree", "fedavg"),
                     ("internvl2-2b", "tree", "multi_krum")]}
FE_SHARED_AGREE = {(2, 2, 1): [("whisper-small", "tree", "fedavg"),
                               ("internvl2-2b", "tree", "fedavg")],
                   (1, 2, 2): [("whisper-small", "flat", "fedavg"),
                               ("internvl2-2b", "flat", "fedavg")]}
# leg ``fe_time``: (mesh, arch, layers, schedule), two rounds each, at full
# depth: whisper-small's 12 + 12 layers (0.28 B parameters), and
# internvl2-2b's 24 (1.89 B, about 0.95 B a rank on (2, 2) with AdamW's
# f32 moments; the single-card K = 4 cell stops at 16 of 24)
FE_TIME = [((1, 4), "whisper-small", 12, "tree"),
           ((1, 4), "internvl2-2b", 24, "tree"),
           ((2, 2), "internvl2-2b", 24, "flat")]


def _fe_cfg(arch, n_layers, mode=None):
    """``arch`` cut to ``n_layers`` (the encoder-decoder's encoder too), in
    ``mode`` (by default its own)."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    cut = {"n_layers": n_layers}
    if cfg.family == "encdec":
        cut["n_enc_layers"] = n_layers
    cfg = cfg.replace(**cut)
    return cfg if mode is None else cfg.replace(
        fl=dataclasses.replace(cfg.fl, mode=mode))


class _FrontendTrainer:
    """``SDFLMQTrainer`` as the agree and time legs read it, for the
    encoder-decoder and VLM families, whose batches carry frames or
    patches where the trainer feeds tokens only: the rounds go through
    ``fl_step.init_state`` and ``build_fl_round_step`` as
    ``phase_train_frontend``'s do, each round's batch of the K clients from
    ``inputs.make_batch`` (tokens, and frames or patches, from the round's
    seed).  K clients on one card, or this rank's client on ``mesh``;
    client weights ``TP_AGREE_WEIGHTS``; ``tree`` is a two-level cluster
    tree over the clients."""

    def __init__(self, cfg, n, rounds, bpc, seq, seed=0, device=None,
                 mesh=None, schedule_kind="tree", strategy="fedavg"):
        from repro_torch.core import fl_step
        from repro_torch.core.clustering import build_tree
        from repro_torch.core.topology import AggSchedule, compile_tree
        self.cfg, self.n, self.rounds = cfg, n, rounds
        self.bpc, self.seq, self.mesh = bpc, seq, mesh
        self.device = device if mesh is None else mesh.device
        where = n if mesh is None else mesh
        if schedule_kind == "tree" and n > 1:
            clients = [f"c{i}" for i in range(n)]
            self.schedule = compile_tree(build_tree(
                "s", clients, clients, aggregator_ratio=0.5, levels=3))
        else:
            self.schedule = AggSchedule(schedule_kind, n)
        self.state = fl_step.init_state(cfg, where, seed, self.device,
                                        total_steps=rounds)
        self.step = fl_step.build_fl_round_step(
            cfg, where, self.schedule, self.device, total_steps=rounds,
            strategy=strategy)
        self.who = 0 if mesh is None or n == 1 else mesh.coord(
            fl_step.client_axis_for(cfg, mesh))
        self.on_round_end = None

    def run(self) -> list:
        import numpy as np
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.models import inputs
        from repro_torch.obs.spans import span_ms
        K, mesh = self.n, self.mesh
        weights = np.array(TP_AGREE_WEIGHTS[:K], np.float32)
        shape = ShapeConfig("frontend", self.seq, K * self.bpc, "train")
        out = []
        for r in range(self.rounds):
            t0 = time.perf_counter()
            batch = inputs.make_batch(self.cfg, shape, r, clients=K,
                                      device=self.device)
            if mesh is not None or K == 1:     # one client: no client dim
                batch = {k: v[self.who] for k, v in batch.items()}
            self.state, m = self.step(self.state, batch, weights)
            loss = float(m["loss"])            # waits for the device
            dt = time.perf_counter() - t0
            rank_ms = span_ms(m["spans"])
            spans = rank_ms if mesh is None else {
                k: mesh.all_max(v) for k, v in rank_ms.items()}
            out.append({"round": r, "loss": loss, "time_s": dt,
                        "tokens_per_s": K * self.bpc * self.seq
                        * self.cfg.fl.local_steps / dt,
                        "level_groups": self.schedule.level_groups,
                        **spans, "rank_ms": rank_ms})
            del batch
            if self.on_round_end is not None:
                self.on_round_end(r, self.state)
        return out


def _fe_agree(torch, mesh, table, mode, bpc) -> list:
    """Legs ``fe_agree`` and ``fe_shared_agree`` on this mesh: two rounds
    of each case of ``table`` at one layer in ``mode`` against the
    single-card rounds."""
    shape = tuple(mesh.shape.values())
    return _agree_rounds(torch, mesh, [
        (_fe_cfg(arch, 1, mode), sched, strat)
        for arch, sched, strat in table[shape]], bpc,
        trainer=_FrontendTrainer, seq=FE_SEQ)


def _time_leg(torch, mesh, cfg, sched, bpc, trainer=None,
              seq=DIST_SEQ) -> dict:
    """Two rounds of ``cfg`` on this mesh under ``sched`` (the config's
    optimizer), batch ``bpc`` a client of ``seq`` tokens (``trainer``:
    ``SDFLMQTrainer`` or ``_FrontendTrainer``): round times, peaks, the
    spans a rank and their maximum, routing, launches."""
    from repro_torch import tree as T
    from repro_torch.core import fl_step
    from repro_torch.launch.train import SDFLMQTrainer
    from repro_torch.models import moe

    K, dev = fl_step.n_clients_for(cfg, mesh), mesh.device
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = (trainer or SDFLMQTrainer)(cfg, K, ROUNDS, bpc, seq, seed=0,
                                    mesh=mesh, schedule_kind=sched)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    moe.reset_stats()
    ms = tr.run()
    torch.cuda.synchronize(dev)
    leaves = T.leaves(tr.state["params"])
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "schedule": sched,
           "optimizer": cfg.optimizer, "mode": cfg.fl.mode, "K": K,
           "mesh": mesh.shape, "init_s": init_s, "init_peak": init_peak,
           "params_per_rank": sum(t.numel() for t in leaves),
           "leaves": len(leaves), "whole": _whole_leaves(cfg, mesh),
           "round_s": [m["time_s"] for m in ms],
           "tokens_per_s": [m["tokens_per_s"] for m in ms],
           "losses": [m["loss"] for m in ms],
           "routing": moe.read_stats(),
           "peak": torch.cuda.max_memory_allocated(dev),
           "launches": read_launches(),
           "checksum": _checksum(torch, tr.state["params"])}
    for span in ("aggregate", "model_collectives", "data_collectives"):
        out[f"{span}_ms_rank"] = [m["rank_ms"].get(f"{span}_ms") for m in ms]
        out[f"{span}_ms_max"] = [m.get(f"{span}_ms") for m in ms]
    del tr
    return out


# (mesh, leg) -> rank 0's wall seconds of each leg a spawn ran, for the
# ``walls`` line
LEG_WALLS = {}


def _spawned(phase, shape, legs, wall_s, ranks):
    """A spawn's line: its legs, its wall time and rank 0's of each leg."""
    leg_s = ranks[0]["leg_s"]
    LEG_WALLS.update({f"{'x'.join(map(str, shape))}:{k}": v
                      for k, v in leg_s.items()})
    emit({"phase": phase, "mesh": list(shape), "legs": legs,
          "wall_s": wall_s, "leg_s": leg_s})


def _tp_rank(mesh, legs):
    """One rank of the model-axis and shared-mode legs (a spawned process),
    with the matmul settings of ``main``: ``tp_agree``, ``moe_agree``,
    ``lin_agree``, ``shared_agree``, ``fe_agree``, ``fe_shared_agree``,
    ``tp3_agree``, ``tp3_agg``, each ``tp_time:<sched>`` and each
    ``{moe,lin,shared,fe,tp3}_time:<arch>:<layers>:<sched>`` in
    ``legs``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "shape": mesh.shape,
           "device": torch.cuda.get_device_name(mesh.device)}
    from repro_torch.configs.base import get_arch
    leg_s = out["leg_s"] = {}
    for leg in legs:
        t0 = time.perf_counter()
        if leg == "tp_agree":
            out[leg] = _tp_agree(torch, mesh)
        elif leg == "moe_agree":
            out[leg] = _moe_agree(torch, mesh)
        elif leg == "lin_agree":
            out[leg] = _lin_agree(torch, mesh)
        elif leg == "shared_agree":
            out[leg] = _shared_agree(torch, mesh)
        elif leg == "fe_agree":
            out[leg] = _fe_agree(torch, mesh, FE_AGREE, None, FE_BPC)
        elif leg == "fe_shared_agree":
            out[leg] = _fe_agree(torch, mesh, FE_SHARED_AGREE, "shared",
                                 FE_SHARED_BPC)
        elif leg == "tp3_agree":
            out[leg] = _tp3_agree(torch, mesh)
        elif leg == "tp3_agg":
            out[leg] = _tp3_agg(torch, mesh)
        elif leg.startswith("fe_time:"):
            _, arch, n_layers, sched = leg.split(":")
            out[leg] = _time_leg(torch, mesh, _fe_cfg(arch, int(n_layers)),
                                 sched, FE_BPC[arch], _FrontendTrainer,
                                 FE_SEQ[arch])
        elif leg.startswith(("moe_time:", "lin_time:", "shared_time:",
                             "tp3_time:")):
            kind, arch, n_layers, sched = leg.split(":")
            mode, bpc = ((_shared, SHARED_BPC) if kind == "shared_time"
                         else (_replica, BATCH_PER_CLIENT))
            cfg = mode(get_arch(arch).replace(n_layers=int(n_layers)))
            out[leg] = _time_leg(torch, mesh, cfg, sched, bpc)
        else:
            out[leg] = _tp_time(torch, mesh, leg.split(":")[1])
        leg_s[leg] = time.perf_counter() - t0
    return out


def _emit_tp_agree(ranks, add, faults):
    """The ``tp_agree`` lines of a (2, 2) run and their checks."""
    for i, (sched, strat) in enumerate(TP_AGREE):
        rows = [r["tp_agree"][i] for r in ranks]
        for r in rows:
            add(r["launches"])
        lead = rows[0]
        # rank r = 2 d + m: the ranks of a model column hold one block
        same = all(rows[r]["checksum"] == rows[r % 2]["checksum"]
                   for r in range(4))
        agg = [r["aggregation_alone"] for r in rows]
        agg_same = all(agg[r]["checksum"] == agg[r % 2]["checksum"]
                       for r in range(4))
        rel = abs(lead["loss"] - lead["single_loss"]) / abs(
            lead["single_loss"])
        keys = ("exact", "max_abs_err", "elements_differing",
                "beyond_1_bf16_ulp", "beyond_sum_tolerance",
                "beyond_ulp_and_step", "finite")
        emit({"phase": "tp_agree", "mesh": [2, 2], "schedule": sched,
              "strategy": strat, "n_layers": 1,
              "loss": lead["loss"], "single_card_loss": lead["single_loss"],
              "loss_rel_err": rel, "level_groups": lead["level_groups"],
              "rank": [{k: r.get(k) for k in keys} for r in rows],
              "slots_identical_across_column": same,
              "aggregation_alone": [{k: v for k, v in a.items()
                                     if k != "checksum"} for a in agg],
              "aggregation_alone_identical_across_column": agg_same,
              "time_s": lead["time_s"], "aggregate_ms_max": lead[
                  "aggregate_ms"],
              "peak_rank": [r["peak"] for r in rows],
              "launches_rank": [r["launches"] for r in rows]})
        exact = sched != "compressed" and strat != "fedavg"
        for r in rows:
            a = r["aggregation_alone"]
            if (not r["finite"] or rel > TP_LOSS_RTOL
                    or lead["level_groups"] != lead["single_level_groups"]
                    or (exact and not r["exact"])
                    or (sched != "compressed" and r["beyond_sum_tolerance"])
                    or r.get("beyond_ulp_and_step")
                    or ((sched == "compressed" or exact)
                        and not a["exact"])
                    or a["beyond_sum_tolerance"]):
                faults.append(f"tp_agree {sched}/{strat} rank: {r}")
            want_qagg = r["leaves"] if sched == "compressed" else 0
            got = r["launches"]
            if (got["flash_fwd"] != 2 or got["qagg"] != want_qagg
                    or got["fedavg"] or got["quantize"]
                    or got["dequantize"]):
                faults.append(f"tp_agree {sched}/{strat}: launches {got}")
        if not same or not agg_same:
            faults.append(f"tp_agree {sched}/{strat}: column blocks differ")


def _emit_tp_time(shape, sched, rows, add, faults):
    """A ``tp_time`` line and its checks; rank 0's row is kept for
    ``phase_dryrun``."""
    for r in rows:
        add(r["launches"])
    lead = rows[0]
    MEASURED[("tp_time", shape, sched)] = lead
    M = shape[1]
    same = all(rows[r]["checksum"] == rows[r % M]["checksum"]
               for r in range(len(rows)))
    emit({"phase": "tp_time", "mesh": list(shape), "schedule": sched,
          "arch": DIST_ARCH, "n_layers": TP_TIME_LAYERS, "reduced": [],
          "clients": shape[0], "batch_per_client": BATCH_PER_CLIENT,
          "seq": DIST_SEQ, "rounds": ROUNDS,
          "params_per_rank": [r["params_per_rank"] for r in rows],
          "init_s_rank": [r["init_s"] for r in rows],
          "init_peak_rank": [r["init_peak"] for r in rows],
          "round_s": lead["round_s"], "tokens_per_s": lead["tokens_per_s"],
          "losses": lead["losses"],
          "aggregate_ms_rank": [r["aggregate_ms_rank"] for r in rows],
          "aggregate_ms_max": lead["aggregate_ms_max"],
          "model_collectives_ms_rank": [r["model_collectives_ms_rank"]
                                        for r in rows],
          "model_collectives_ms_max": lead["model_collectives_ms_max"],
          "peak_rank": [r["peak"] for r in rows],
          "flash_rank": [r["launches"]["flash_fwd"] for r in rows],
          "qagg_rank": [r["launches"]["qagg"] for r in rows],
          "slots_identical_across_column": same})
    # forward and the remat recompute: 2 flash launches a layer a round
    want_flash = 2 * TP_TIME_LAYERS * ROUNDS
    want_qagg = lead["leaves"] * ROUNDS if sched == "compressed" else 0
    if (not all(math.isfinite(x) for x in lead["losses"]) or not same
            or max(r["peak"] for r in rows) >= CARD_BYTES
            or any(r["launches"]["flash_fwd"] != want_flash
                   or r["launches"]["qagg"] != want_qagg
                   or r["launches"]["fedavg"] for r in rows)):
        faults.append(f"tp_time {shape} {sched}: {rows}")


def _emit_agree(phase, shape, cases, bpc, ranks, add, faults, seq=DIST_SEQ,
                layers=1):
    """The lines of an agree leg (``moe_agree``, ``shared_agree``) on a mesh
    and their checks: losses within ``TP_LOSS_RTOL``; round 0 (a learning
    rate of 0: the aggregation alone) under ``_slot_compare``'s sum rule,
    the stack strategy bit for bit, ``compressed`` within one bf16 ulp and
    one quantization step of the contributions' whole rows; round 1 within
    ``MOE_ROUND1_ULPS`` bf16 ulps and 2 x ``MOE_LR``, at most
    ``MOE_ROUND1_SHARE`` beyond the ulps (and, under ``compressed``, the
    carried and new steps); the clients' dropped assignments within
    ``MOE_DROP_SHARE`` of the assignments of the single card's; equal
    blocks on the ranks that hold the same block of different clients;
    exact flash, WKV (``_path_launches``) and qagg counts; every leaf with
    no dim on ``model`` equal bit for bit on the model ranks of its block
    after each round (each rank computes it alone, and must not drift).
    ``cases``: (arch, schedule, strategy); ``bpc``, ``seq`` and ``layers``
    (the cases' depth): numbers, or dicts by architecture."""
    from repro_torch.configs.base import get_arch
    keys = ("exact", "max_abs_err", "elements_differing",
            "beyond_1_bf16_ulp", "beyond_1_bf16_ulp_max_err",
            "beyond_1_bf16_ulp_max_abs_value", "beyond_sum_tolerance",
            "beyond_ulp_and_step", "beyond_2_bf16_ulps",
            "beyond_round1_tolerance", "elements", "finite")
    for i, (arch, sched, strat) in enumerate(cases):
        rows = [r[phase][i] for r in ranks]
        for r in rows:
            add(r["launches"])
        lead = rows[0]
        K = lead["K"]
        n_bpc, n_seq = _per(bpc, arch), _per(seq, arch)
        period = len(rows) // K      # the client axis is the outermost
        same = all(rows[r][f"round{k}"]["checksum"]
                   == rows[r % period][f"round{k}"]["checksum"]
                   for r in range(len(rows)) for k in range(ROUNDS))
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            lead["losses"], lead["single_losses"]))
        differ = sorted({p for k in range(ROUNDS) for p in _whole_differ(
            rows, shape[-1], lambda r: r[f"round{k}"]["checksum"])})
        heads = [k * period for k in range(K)]     # one rank a client
        dropped = sum(rows[r]["routing"]["dropped"] for r in heads)
        calls = sum(rows[r]["routing"]["calls"] for r in heads)
        single = lead["single_routing"]
        moe = get_arch(arch).moe
        assignments = calls * n_bpc * n_seq * (moe.top_k if moe else 0)
        emit({"phase": phase, "mesh": list(shape), "arch": arch,
              "n_layers": _per(layers, arch), "clients": K,
              "batch_per_client": n_bpc,
              "seq": n_seq, "optimizer": lead["optimizer"],
              "schedule": sched, "strategy": strat, "rounds": ROUNDS,
              "losses": lead["losses"],
              "single_card_losses": lead["single_losses"],
              "loss_rel_err": rel, "level_groups": lead["level_groups"],
              "dropped": dropped, "single_card_dropped": single["dropped"],
              "assignments": assignments, "moe_calls": calls,
              "single_card_moe_calls": single["calls"],
              "aux_mean_rank": [r["routing"]["aux_mean"] for r in rows],
              "single_card_aux_mean": single["aux_mean"],
              **{f"round{k}_rank": [{x: r[f"round{k}"].get(x) for x in keys}
                                    for r in rows] for k in range(ROUNDS)},
              "blocks_identical_across_clients": same,
              "whole_leaves": len(lead["whole"]),
              "whole_leaves_differing_across_model_ranks": differ,
              "round_s": lead["round_s"],
              "aggregate_ms_rank": [r["aggregate_ms"] for r in rows],
              "model_collectives_ms_rank": [r["model_collectives_ms"]
                                            for r in rows],
              "data_collectives_ms_rank": [r["data_collectives_ms"]
                                           for r in rows],
              "peak_rank": [r["peak"] for r in rows],
              "launches_rank": [r["launches"] for r in rows]})
        exact = strat != "fedavg"
        name = f"{phase} {shape} {arch} {sched}/{strat}"
        for r in rows:
            r0, r1 = r["round0"], r["round1"]
            if (not r0["finite"] or not r1["finite"] or rel > TP_LOSS_RTOL
                    or lead["level_groups"] != lead["single_level_groups"]
                    or (exact and not r0["exact"])
                    or (sched != "compressed" and r0["beyond_sum_tolerance"])
                    or r0.get("beyond_ulp_and_step")
                    or r1["beyond_round1_tolerance"]
                    or r1["beyond_2_bf16_ulps"]
                    > MOE_ROUND1_SHARE * r1["elements"]):
                rest = {k: v for k, v in r.items()
                        if k not in ("round0", "round1")}
                faults.append(f"{name} rank: {rest} "
                              f"round0 { {x: r0.get(x) for x in keys} } "
                              f"round1 { {x: r1.get(x) for x in keys} }")
            want_qagg = r["leaves"] * ROUNDS if sched == "compressed" else 0
            got = r["launches"]
            if (any(got[k] != n
                    for k, n in _path_launches(
                        arch, _per(layers, arch), n_seq).items())
                    or got["qagg"] != want_qagg or got["fedavg"]
                    or got["quantize"] or got["dequantize"]):
                faults.append(f"{name}: launches {got}")
        if not same:
            faults.append(f"{name}: blocks differ across clients")
        if differ:
            faults.append(f"{name}: whole leaves differ across the model "
                          f"ranks: {differ}")
        if moe and (abs(dropped - single["dropped"])
                    > MOE_DROP_SHARE * assignments
                    or calls != single["calls"]):
            faults.append(f"{name}: dropped {dropped} of {calls} calls, the "
                          f"single card {single}")


def _emit_time(phase, shape, arch, n_layers, sched, bpc, rows, add,
               faults, seq=DIST_SEQ):
    """A time leg's line (``moe_time``, ``lin_time``, ``shared_time``) and
    its checks: finite losses, equal blocks across the clients, the
    config's optimizer, every peak under the card, flash and WKV exactly 2
    a layer a round a rank (remat's recompute, ``_path_launches``), qagg a
    leaf a round under ``compressed``, no fedavg, every leaf with no dim on
    ``model`` equal bit for bit on the model ranks of its block after the
    rounds."""
    from repro_torch.configs.base import get_arch
    for r in rows:
        add(r["launches"])
    lead = rows[0]
    differ = _whole_differ(rows, shape[-1], lambda r: r["checksum"])
    period = len(rows) // lead["K"]
    same = all(rows[r]["checksum"] == rows[r % period]["checksum"]
               for r in range(len(rows)))
    total = get_arch(arch).n_layers
    routing = lead["routing"]
    moe = get_arch(arch).moe
    assignments = routing["calls"] * bpc * seq * (moe.top_k if moe else 0)
    emit({"phase": phase, "mesh": list(shape), "arch": arch,
          "mode": lead["mode"], "optimizer": lead["optimizer"],
          "schedule": sched, "n_layers": n_layers,
          "reduced": [] if n_layers == total else
          [f"depth {n_layers} of {total}"],
          "clients": lead["K"], "batch_per_client": bpc,
          "seq": seq, "rounds": ROUNDS,
          "params_per_rank": [r["params_per_rank"] for r in rows],
          "init_s_rank": [r["init_s"] for r in rows],
          "init_peak_rank": [r["init_peak"] for r in rows],
          "round_s": lead["round_s"], "tokens_per_s": lead["tokens_per_s"],
          "losses": lead["losses"],
          **{f"{span}_ms_rank": [r[f"{span}_ms_rank"] for r in rows]
             for span in ("aggregate", "model_collectives",
                          "data_collectives")},
          **{f"{span}_ms_max": lead[f"{span}_ms_max"]
             for span in ("aggregate", "model_collectives",
                          "data_collectives")},
          "moe_calls": routing["calls"], "dropped": routing["dropped"],
          "dropped_share": (routing["dropped"] / assignments
                            if assignments else None),
          "aux_mean": routing["aux_mean"],
          "peak_rank": [r["peak"] for r in rows],
          "flash_rank": [r["launches"]["flash_fwd"] for r in rows],
          "wkv6_rank": [r["launches"]["wkv6"] for r in rows],
          "ssm_scan_rank": [r["launches"]["ssm_scan"] for r in rows],
          "qagg_rank": [r["launches"]["qagg"] for r in rows],
          "blocks_identical_across_clients": same,
          "whole_leaves": len(lead["whole"]),
          "whole_leaves_differing_across_model_ranks": differ})
    want = _path_launches(arch, n_layers, seq)
    want_qagg = lead["leaves"] * ROUNDS if sched == "compressed" else 0
    if (not all(math.isfinite(x) for x in lead["losses"]) or not same
            or lead["optimizer"] != get_arch(arch).optimizer
            or max(r["peak"] for r in rows) >= CARD_BYTES
            or any(any(r["launches"][k] != n for k, n in want.items())
                   or r["launches"]["qagg"] != want_qagg
                   or r["launches"]["fedavg"] for r in rows)
            or differ):
        faults.append(f"{phase} {shape} {arch} {n_layers} {sched}: {rows}")


def phase_tp(torch, dev) -> dict:
    """The model axis over four cards: leg (d) ``tp_time``, leg (f)
    ``moe_time``, ``lin_time``, ``fe_agree`` and ``fe_time`` on a (1, 4)
    mesh, then on a (2, 2) one legs (c) ``tp_agree``, (e) ``moe_agree``,
    ``lin_agree``, ``fe_agree``, (d), (f), ``lin_time`` and ``fe_time``.  Each mesh's lines are printed as soon as it ends, before
    any check fails the phase; returns the legs' launches, summed over the
    ranks."""
    from repro_torch.launch import mesh as mesh_lib

    launches, faults = {}, []

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for shape in ((1, 4), (2, 2)):
        legs = [f"tp_time:{sched}" for sh, sched in TP_TIME if sh == shape]
        if shape == (2, 2):
            legs[:0] = ["tp_agree", "moe_agree", "lin_agree"]
        legs += ["fe_agree"] + [
            f"{kind}_time:{arch}:{n}:{sched}"
            for kind, table in (("moe", MOE_TIME), ("lin", LIN_TIME),
                                ("fe", FE_TIME))
            for sh, arch, n, sched in table if sh == shape]
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(_tp_rank, shape[0], (legs,), model=shape[1],
                               device="cuda", timeout_s=TP_TIMEOUT_S)
        _spawned("tp_spawn", shape, legs, time.perf_counter() - t0, ranks)
        if "tp_agree" in legs:
            _emit_tp_agree(ranks, add, faults)
        if "moe_agree" in legs:
            _emit_agree("moe_agree", shape, [(MOE_ARCH,) + c
                                             for c in MOE_AGREE],
                        BATCH_PER_CLIENT, ranks, add, faults)
            _emit_agree("lin_agree", shape, LIN_AGREE, BATCH_PER_CLIENT,
                        ranks, add, faults)
        _emit_agree("fe_agree", shape, FE_AGREE[shape], FE_BPC, ranks, add,
                    faults, FE_SEQ)
        for sh, sched in TP_TIME:
            if sh == shape:
                _emit_tp_time(shape, sched, [r[f"tp_time:{sched}"]
                                             for r in ranks], add, faults)
        for kind, table in (("moe", MOE_TIME), ("lin", LIN_TIME),
                            ("fe", FE_TIME)):
            for sh, arch, n, sched in table:
                if sh == shape:
                    _emit_time(f"{kind}_time", shape, arch, n, sched,
                               _per(FE_BPC, arch) if kind == "fe"
                               else BATCH_PER_CLIENT,
                               [r[f"{kind}_time:{arch}:{n}:{sched}"]
                                for r in ranks], add, faults,
                               _per(FE_SEQ, arch) if kind == "fe"
                               else DIST_SEQ)
    if faults:
        raise AssertionError("\n".join(faults))
    return launches


# the shared mode: one client a pod, its parameters FSDP-split over its
# data ranks (``embed``) and tensor-parallel over its model ranks, the MoE
# configs' declared deployment.  Batch 2 a client, so each data rank of a
# (2, 2, 1) mesh takes one row.  Leg (g) ``shared_agree``: at one layer,
# two rounds (round 0 at a learning rate of 0) of each case against the
# single-card rounds on card 0, on a (2, 2, 1) mesh (K = 2) and a
# (1, 2, 2) one (K = 1: experts, or rwkv6's heads, on model, embed on
# data); the checks are ``moe_agree``'s
SHARED_BPC = 2
SHARED_AGREE = {(2, 2, 1): [(MOE_ARCH, "tree", "fedavg"),
                            (MOE_ARCH, "flat", "fedavg"),
                            (MOE_ARCH, "compressed", "fedavg"),
                            (MOE_ARCH, "tree", "multi_krum"),
                            (DIST_ARCH, "tree", "fedavg"),
                            ("rwkv6-7b", "tree", "fedavg"),
                            ("hymba-1.5b", "tree", "fedavg")],
                (1, 2, 2): [(MOE_ARCH, "flat", "fedavg"),
                            ("rwkv6-7b", "flat", "fedavg")]}
# leg (h) ``shared_time`` on (2, 2, 1), two rounds each: mixtral-8x22b at
# the most layers under about 72 GB a rank (a layer is 2.50 B parameters,
# 1.25 B a rank: 6 layers took 70.56 GB, and a seventh would add about 11
# GB), and qwen2-7b at all 28 layers under AdamW (3.8 B parameters a rank)
SHARED_TIME = [(MOE_ARCH, 6, "tree"), (MOE_ARCH, 6, "compressed"),
               (DIST_ARCH, 28, "tree")]


def _shared(cfg):
    """``cfg`` in ``shared`` mode (mixtral's and kimi-k2's own)."""
    import dataclasses
    return cfg.replace(fl=dataclasses.replace(cfg.fl, mode="shared"))


def phase_shared(torch, dev) -> dict:
    """The shared mode over four cards, one spawn a mesh shape: leg (g)
    ``shared_agree``, ``fe_shared_agree`` and leg (h) ``shared_time`` on a
    (2, 2, 1) mesh, then legs (g) and ``fe_shared_agree`` on a (1, 2, 2)
    one.  Each mesh's lines are printed as soon as
    it ends, before any check fails the phase; returns the legs'
    launches, summed over the ranks."""
    from repro_torch.launch import mesh as mesh_lib

    launches, faults = {}, []

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for shape, cases in SHARED_AGREE.items():
        legs = ["shared_agree", "fe_shared_agree"]
        if shape == (2, 2, 1):
            legs += [f"shared_time:{arch}:{n}:{sched}"
                     for arch, n, sched in SHARED_TIME]
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(_tp_rank, shape[1], (legs,), model=shape[2],
                               pods=shape[0], device="cuda",
                               timeout_s=TP_TIMEOUT_S)
        _spawned("shared_spawn", shape, legs, time.perf_counter() - t0, ranks)
        _emit_agree("shared_agree", shape, cases, SHARED_BPC, ranks, add,
                    faults)
        _emit_agree("fe_shared_agree", shape, FE_SHARED_AGREE[shape],
                    FE_SHARED_BPC, ranks, add, faults, FE_SEQ)
        if shape == (2, 2, 1):
            for arch, n, sched in SHARED_TIME:
                _emit_time("shared_time", shape, arch, n, sched, SHARED_BPC,
                           [r[f"shared_time:{arch}:{n}:{sched}"]
                            for r in ranks], add, faults)
    if faults:
        raise AssertionError("\n".join(faults))
    return launches


# the model axis where the reference's resolver leaves a dim whole, on
# three of the four cards, a (1, 3) mesh: one client, K = 1, replica mode.
# At M = 3 internlm2-20b's 48 q heads split, 16 a rank across kv groups of
# 6 (its 8 kv heads whole: one expanded kv head a q head), its MLP (16384)
# stays whole and its vocab (92544) splits; mixtral-8x22b's 48 q heads
# straddle likewise, its vocab (32768), experts (8) and their width
# (16384) stay whole; rwkv6-7b keeps every dim whole (64 heads, 14336,
# 4096, 65536: a replicated client); whisper-small splits its 12 heads and
# 3072-wide MLP, its vocab (51865 padded to 51968) stays whole.  Leg
# ``tp3_agree``: two rounds (round 0 at a learning rate of 0) of each case
# against the single-card K = 1 rounds on card 0, under ``_emit_agree``'s
# checks: (arch, layers, schedule, strategy)
TP3_AGREE = [("internlm2-20b", 2, "tree", "fedavg"),
             ("mixtral-8x22b", 1, "tree", "fedavg"),
             ("rwkv6-7b", 2, "tree", "fedavg")]
TP3_FE_AGREE = [("whisper-small", 2, "tree", "fedavg")]
# leg ``tp3_agg``: the ``compressed`` aggregation alone (one client has
# nothing to aggregate) on each rank's blocks of a two-client
# internlm2-20b bank at 2 layers, whose MLP leaves are whole blocks
TP3_AGG_LAYERS = 2
# leg ``tp3_time``: internlm2-20b under its config's Adafactor at the
# most layers under about 72 GB a rank.  A layer is 0.34 B parameters a
# rank (16 of 48 q heads, the whole kv, wo's rows, the whole MLP): the
# weights, gradients and updates and Adafactor's f32 temporaries of the
# whole stacked MLP leaf, 3.06 GB a layer in the dry run's trace of the
# cell (``launch/dryrun.lower_cell``, counted on the meta device), 69.5 GB
# at 22 layers, 72.6 at 23; 69.58 GB measured at 22 on an H100 80GB HBM3
# at 700 W
TP3_TIME = ("internlm2-20b", 22, "tree")
# leg ``serve_tp3_time``: internlm2-20b served at all 48 layers (16.7 B
# parameters, 33.4 GB of bf16 weights a rank), ``serve_tp_time``'s traffic
SERVE_TP3_TIME = ("internlm2-20b", 48, SERVE_PROMPT, SERVE_REQUESTS, None)
TP3_TIMEOUT_S = 900


def _tp3_cases(table):
    """``table``'s (config cut to its layers, in ``replica`` mode,
    schedule, strategy)."""
    return [(_replica(_fe_cfg(arch, n)), sched, strat)
            for arch, n, sched, strat in table]


def _tp3_agree(torch, mesh) -> list:
    """Leg ``tp3_agree`` on (1, 3): ``TP3_AGREE`` through the trainer,
    then ``TP3_FE_AGREE`` through ``_FrontendTrainer`` (frames)."""
    return (_agree_rounds(torch, mesh, _tp3_cases(TP3_AGREE),
                          BATCH_PER_CLIENT)
            + _agree_rounds(torch, mesh, _tp3_cases(TP3_FE_AGREE), FE_BPC,
                            trainer=_FrontendTrainer, seq=FE_SEQ))


def _tp3_agg(torch, mesh) -> dict:
    """Leg ``tp3_agg`` on (1, 3): each rank's blocks of a two-client
    internlm2-20b bank (``TP3_AGG_LAYERS`` layers, the clients drawn
    apart) through ``aggregate_params`` under ``compressed`` (int8
    quantize and the qagg kernel, a launch a leaf), with the launch
    counters set to 0 just before and read just after, against the same
    call on rank 0's whole bank (broadcast; each rank compares its
    block).  The whole MLP leaves' blocks are the whole leaves."""
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.core import aggregation, fl_step
    from repro_torch.core.topology import AggSchedule
    from repro_torch.dist import sharding as shd

    cfg = _replica(_fe_cfg("internlm2-20b", TP3_AGG_LAYERS))
    dev, K = mesh.device, 2
    decls = fl_step.fl_param_decls(cfg, K)
    specs = [(None,) + s for s in T.leaves(fl_step.param_specs(
        cfg, {"data": 1, "model": mesh.shape["model"]}))]
    w = torch.tensor(TP_AGREE_WEIGHTS, device=dev)
    schedule = AggSchedule("compressed", K)
    want = None
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        bank = shd.materialize(decls, 1, dev)
        aggregation.aggregate_params(bank, w, schedule, "fedavg")
        want = [t[0].clone() for t in T.leaves(bank)]
        del bank
    mine = shd.materialize(decls, 1, dev,
                           lambda i, x: shd.local_block(x, specs[i], mesh))
    torch.cuda.synchronize(dev)
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    aggregation.aggregate_params(mine, w, schedule, "fedavg")
    end.record()
    torch.cuda.synchronize(dev)
    launches = read_launches()
    got = [t[0] for t in T.leaves(mine)]
    blocks = []
    for i, (g, d) in enumerate(zip(got, T.leaves(decls))):
        x = want[i] if want else torch.empty(d.shape[1:], dtype=g.dtype,
                                             device=dev)
        dist.broadcast(x, src=0)
        blocks.append(shd.local_block(x, specs[i][1:], mesh))
    whole = [s for s in specs if "model" not in s]
    out = {"leaves": len(got), "whole_leaves": len(whole),
           "ms": start.elapsed_time(end), "launches": launches,
           **_slot_compare(torch, dict(enumerate(got)),
                           dict(enumerate(blocks)))}
    del mine, got, blocks, want
    return out


# --------------------------------------------------------------------------
# serving on the model and data axes: one engine a rank, NCCL between them
# --------------------------------------------------------------------------

# leg (i) ``serve_tp_agree``: at one layer, each case's batch (prompt
# lengths from the seed's tokens; SERVE_MAX_NEW teacher-forced steps) on
# the ranks against the single card's engine on card 0's weights, as the
# cache layout named beside it: a full-attention cache of S + 33 slots
# splits on its sequence where that divides M, else on qwen2-7b's 4 kv
# heads; hymba-1.5b's window ring (min(1024, S) slots) on its sequence
# (R3 holds at 2048 and shows at 1800), whole at 1001; mixtral-8x22b's
# unpadded windowed cache (R4) in its declared shared mode
SERVE_TP_AGREE = {
    (1, 4): [("qwen2-7b", (2047, 2047, 1900, 1536), "seq"),
             ("qwen2-7b", (2048, 2048, 1700, 2048), "heads"),
             ("rwkv6-7b", (2048, 2048, 1800, 1536), None),
             ("hymba-1.5b", (2048, 2048, 2048, 2048), "seq"),
             ("hymba-1.5b", (1800, 1800, 1536, 1800), "seq"),
             ("hymba-1.5b", (1001, 1001, 900, 1001), "whole"),
             ("whisper-small", (224, 224, 100, 224), "heads"),
             ("whisper-small", (223, 223, 223, 60), "seq"),
             ("internvl2-2b", (2047, 2047, 1900, 1536), "seq")],
    (2, 2): [("qwen2-7b", (2047, 2047, 1900, 1536), "seq"),
             ("qwen2-7b", (2048, 2048, 1700, 2048), "heads"),
             ("mixtral-8x22b", (2048, 2048, 1900, 2048), "seq"),
             ("rwkv6-7b", (2048, 2048, 1800, 1536), None),
             ("hymba-1.5b", (1800, 1800, 1536, 1800), "seq"),
             ("whisper-small", (223, 223, 12, 223), "seq"),
             ("internvl2-2b", (2048, 2048, 1700, 2048), "heads")],
    # ``phase_tp3``: internlm2-20b at 2 layers on (1, 3), its 16 q heads a
    # rank across kv groups of 6: 2079 slots split on their sequence
    # (2046-token prompts), 2081 whole (neither they nor the 8 kv heads
    # divide 3)
    (1, 3): [("internlm2-20b", (2046, 2046, 1900, 1536), "seq"),
             ("internlm2-20b", (2048, 2048, 1700, 2048), "whole")]}
# the depth of each mesh's ``serve_tp_agree`` cases (by default one layer)
SERVE_TP_AGREE_LAYERS = {(1, 3): 2}
# whisper-small's cross cache of 1500 frames splits on its sequence at a
# model axis of 2 and of 4, whatever its self cache's layout (S + 33 slots:
# 257 at a 224-token prompt, heads; 256 at 223, seq); frames or patches
# from a seed (``_frontend_engine``)
SERVE_TP_CROSS = {"whisper-small": "seq"}
# leg (j) ``serve_tp_time`` on (1, 4): the serving cells' traffic (8
# requests at batch 4, prompts of 1536-2048 tokens, 32 new) at full depth,
# but mixtral-8x22b at 28 of its 56 layers (at 56 its 64 decode steps, 514
# ms each on four H100 80GB HBM3 at 700 W, took 33 s of the four-card
# script), and qwen2-7b at the reference's decode_32k context (one batch of 4
# prompts of 32 768 tokens; 32 800 slots, which 4 divides: seq-split):
# (arch, layers, prompt lengths, requests, max_seq)
SERVE_TP_TIME = [("mixtral-8x22b", 28, SERVE_PROMPT, SERVE_REQUESTS, None),
                 ("qwen2-7b", 28, SERVE_PROMPT, SERVE_REQUESTS, None),
                 ("rwkv6-7b", 32, SERVE_PROMPT, SERVE_REQUESTS, None),
                 ("qwen2-7b", 28, (32768, 32768), SERVE_BATCH, 32800),
                 ("whisper-small", 12, (4, 224), SERVE_REQUESTS, 448),
                 ("internvl2-2b", 24, SERVE_PROMPT, SERVE_REQUESTS, None)]
SERVE_TP_TIMEOUT_S = 900


def _nodrop(cfg):
    """An MoE config at a capacity factor of E / top_k: no assignment is
    dropped at prefill, so the single card's bf16 and f32 runs and the
    ranks' route every token alike (a drop is a discontinuity the logits'
    yardstick cannot measure)."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _frontend_engine():
    """``ServeEngine`` with the encoder-decoder's frames or the VLM's
    patches drawn from a seed in place of its zero stub inputs (zero ones
    project to exactly 0 at zero-initialised biases and would leave the
    encoder, the cross-attention and the injection unchecked): the whole
    batch's (B, n, feat_dim) drawn on the CPU, each rank taking its rows.
    Other families have no such inputs."""
    import torch
    from repro_torch.serve.engine import ServeEngine

    class FrontendEngine(ServeEngine):
        def prefill(self, tokens, max_new):
            self._batch_rows = tokens.shape[0]
            return super().prefill(tokens, max_new)

        def _extra_inputs(self, B, S):
            fe = self.cfg.frontend
            if fe is None:
                return {}
            encdec = self.cfg.family == "encdec"
            n = fe.n_tokens if encdec else min(fe.n_tokens, S)
            gen = torch.Generator().manual_seed(9)
            x = torch.randn((self._batch_rows, n, fe.feat_dim),
                            generator=gen)[self.rows(self._batch_rows)]
            return {"frames" if encdec else "patches":
                    x.to(torch.bfloat16).to(self.device)}
    return FrontendEngine


def _serve_flash(cfg, S, steps, cross_kind) -> int:
    """The flash launches of one served batch of S-token prompts and
    ``steps`` decode steps: a prefill layer over more than the threshold
    of keys; the encoder-decoder's encoder and cross-attention layers over
    its frames at prefill, and its cross layers at every step where the
    cross cache is not split on its sequence (decode then attends it as
    training does)."""
    L, thr = cfg.n_layers, cfg.attn_chunk_threshold
    if cfg.family == "rwkv":
        return 0
    n = L if S > thr else 0
    if cfg.family == "encdec" and cfg.frontend.n_tokens > thr:
        n += cfg.n_enc_layers + L * (1 + (steps if cross_kind != "seq"
                                           else 0))
    return n


def _forced(torch, engine, toks, tokens):
    """Prefill ``toks`` (B, S), then one decode step a column of
    ``tokens`` (B, n) (None: greedy) -> (the logits of the engine's rows,
    (n + 1, b, V) f32 on its card; the tokens fed)."""
    B, S = toks.shape
    n = SERVE_MAX_NEW if tokens is None else tokens.shape[1]
    rows = engine.rows(B)
    logits, cache = engine.prefill(toks, n)
    out, fed = [logits.float()], []
    for j in range(n):
        cur = out[-1].argmax(-1) if tokens is None else \
            torch.from_numpy(tokens[rows, j]).to(engine.device)
        fed.append(cur)
        out.append(engine.decode(cache, cur, S + j).float())
    del cache
    return torch.stack(out), torch.stack(fed, dim=1).cpu().numpy()


def _serve_tp_agree(torch, mesh) -> list:
    """Leg (i) on this rank: each ``SERVE_TP_AGREE`` case of its mesh at
    one layer (``SERVE_TP_AGREE_LAYERS``: at two on (1, 3)).  The single card's engine runs bf16 weights from the seed
    greedily (rank 0's tokens are every rank's), then bf16 and f32 copies
    teacher-forced on those tokens; the rank's engine, on its blocks of
    the same weights (``init_params(..., mesh=)``), runs teacher-forced
    with the launch counters set to 0 just before and read just after.
    Each of the rank's logit rows, prefill and every step, is held against
    the f32 single card's: its relative L2 distance at most
    SERVE_NOISE_FACTOR times the bf16 single card's own.  whisper-small
    and internvl2-2b run at one layer (whisper: one encoder and one
    decoder layer) with frames or patches from a seed; whisper's self and
    cross caches each take their own layout."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model_api

    ServeEngine = _frontend_engine()
    dev, out = mesh.device, []
    shape = (mesh.shape["data"], mesh.shape["model"])
    for i, (arch, lens, kind) in enumerate(SERVE_TP_AGREE[shape]):
        cfg = _nodrop(_fe_cfg(arch, SERVE_TP_AGREE_LAYERS.get(shape, 1)))
        rng = np.random.default_rng(100 + i)
        toks = np.zeros((len(lens), max(lens)), np.int32)
        for r, n in enumerate(lens):
            toks[r, toks.shape[1] - n:] = rng.integers(0, cfg.vocab, n)
        max_seq = toks.shape[1] + SERVE_MAX_NEW + 1
        gc.collect()
        torch.cuda.empty_cache()
        params = model_api.init_params(cfg, 0, dev)
        single = ServeEngine(cfg, params, batch_size=len(lens),
                             max_seq=max_seq, device=dev)
        bf16, tokens = _forced(torch, single, toks, None)
        tokens = mesh.broadcast(tokens)
        bf16 = _forced(torch, single, toks, tokens)[0]
        params32 = T.tree_map(lambda t: t.float(), params)
        del params, single
        f32 = _forced(torch, ServeEngine(cfg, params32, batch_size=len(lens),
                                         max_seq=max_seq, device=dev),
                      toks, tokens)[0]
        del params32
        gc.collect()
        torch.cuda.empty_cache()
        engine = ServeEngine(cfg, model_api.init_params(cfg, 0, dev,
                                                        mesh=mesh),
                             batch_size=len(lens), max_seq=max_seq,
                             mesh=mesh)
        reset_launches()
        got = _forced(torch, engine, toks, tokens)[0]
        torch.cuda.synchronize(dev)
        launches = read_launches(("flash_fwd", "wkv6", "ssm_scan"))
        rows = engine.rows(len(lens))
        want, noise = f32[:, rows], bf16[:, rows]
        dist = lambda a: ((a - want).norm(dim=-1)
                          / want.norm(dim=-1)).cpu().numpy()
        err, ref = dist(got), dist(noise)
        L = cfg.n_layers
        cross = engine.cross_layout
        cross = None if cross is None else cross.kind
        flash = _serve_flash(cfg, max(lens), SERVE_MAX_NEW, cross)
        scans = L * (1 + SERVE_MAX_NEW)
        out.append({
            "arch": arch, "mode": cfg.fl.mode, "prompt_lens": list(lens),
            "layout": None if engine.layout is None else engine.layout.kind,
            "layout_wanted": kind, "cross_layout": cross,
            "cross_layout_wanted": SERVE_TP_CROSS.get(arch),
            "rows": [rows.start, rows.stop],
            "max_rel_l2": float(err.max()),
            "bf16_single_card_rel_l2_max": float(ref.max()),
            "max_ratio": float((err / ref).max()),
            "held": bool((err <= SERVE_NOISE_FACTOR * ref).all()),
            "argmax_equal_share": float((got.argmax(-1) == want.argmax(-1))
                                        .float().mean()),
            "launches": launches,
            "launches_wanted": {
                "flash_fwd": flash,
                "wkv6": scans if cfg.family == "rwkv" else 0,
                "ssm_scan": scans if cfg.family == "hybrid" else 0}})
        del engine, got, bf16, f32, want, noise
    return out


def _serve_tp_time(torch, mesh, arch, n_layers, lens, n_requests,
                   max_seq) -> dict:
    """Leg (j) on this rank: ``n_requests`` prompts of ``lens`` tokens (from
    the seed) through the rank's engine, SERVE_MAX_NEW new tokens each, at
    batch SERVE_BATCH: TTFT and decode time a batch, the model group's
    collectives (CUDA event pairs), the peak, the cache a rank holds
    beside the single card's (from the decls), and the launches.  The
    peak is read twice: after init (each stacked leaf drawn a layer at a
    time) and over the serving alone.  The engine takes the zero stub
    frames or patches, as ``phase_serve``'s; a decode step's read bound
    counts the weights it reads (not the encoder's or the patch
    projection) and the rank's cache, whisper's cross cache included."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.models import kvcache as kvc
    from repro_torch.models import model_api
    from repro_torch.serve.engine import ServeEngine

    dev = mesh.device
    cfg = get_arch(arch).replace(n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model_api.init_params(cfg, 0, dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    nbytes = lambda t: t.numel() * t.element_size()
    weight_bytes = sum(nbytes(t) for t in T.leaves(params))
    # what a decode step reads of them: every weight but the encoder's and
    # the patch projection (``phase_serve``'s rule)
    step_bytes = sum(nbytes(t) for path, t in T.leaves_with_path(params)
                     if path[0] not in ("enc_in", "enc_layers", "enc_norm",
                                        "vis_proj"))
    rng = np.random.default_rng(0)
    sizes = rng.integers(lens[0], lens[1] + 1, n_requests)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in sizes]
    max_seq = max_seq or lens[1] + SERVE_MAX_NEW + 1
    engine = ServeEngine(cfg, params, batch_size=SERVE_BATCH,
                         max_seq=max_seq, mesh=mesh)
    engine.tp.events = []
    reset_launches()
    batches = []
    for b in range(0, n_requests, SERVE_BATCH):
        before = dict(engine.stats)
        for p in prompts[b:b + SERVE_BATCH]:
            engine.submit(p, SERVE_MAX_NEW)
        done = engine.run()
        S = max(len(p) for p in prompts[b:b + SERVE_BATCH])
        decls = engine.model.cache_decl(cfg, SERVE_BATCH, max(
            kvc.serve_cache_len(cfg, S, SERVE_MAX_NEW, max_seq), 1))
        specs = T.leaves(kvc.cache_specs(cfg, decls, mesh))
        cross = engine.cross_layout
        batches.append({
            "S": S, "layout": (None if engine.layout is None
                               else engine.layout.kind),
            "cross_layout": None if cross is None else cross.kind,
            "tokens_out": sum(len(r.out) for r in done),
            **{k: engine.stats[k] - before[k] for k in
               ("prefill_tokens", "prefill_s", "decode_steps", "decode_s")},
            "cache_bytes_rank": sum(
                d.dtype.itemsize * shd.local_block(
                    torch.empty(d.shape, device="meta"), s, mesh).numel()
                for d, s in zip(T.leaves(decls), specs)),
            "cache_bytes_single_card": sum(d.dtype.itemsize * d.size
                                           for d in T.leaves(decls))})
    torch.cuda.synchronize(dev)
    launches = read_launches(("flash_fwd", "wkv6", "ssm_scan"))
    coll_ms = sum(s.elapsed_time(e) for s, e in engine.tp.events)
    st = engine.stats
    decode_ms = st["decode_s"] / st["decode_steps"] * 1e3
    cache_rank = max(b["cache_bytes_rank"] for b in batches)
    L, B = cfg.n_layers, len(batches)
    scans = L * (1 + SERVE_MAX_NEW) * B
    flash = sum(_serve_flash(cfg, b["S"], SERVE_MAX_NEW, b["cross_layout"])
                for b in batches)
    return {"arch": arch, "n_layers": L, "mesh": mesh.shape,
            "reduced": [] if L == get_arch(arch).n_layers
            else [f"depth {L} of {get_arch(arch).n_layers}"],
            "requests": n_requests, "batch": SERVE_BATCH,
            "max_new": SERVE_MAX_NEW, "max_seq": max_seq,
            "prompt_lens": [int(n) for n in sizes],
            "params_rank": sum(t.numel() for t in T.leaves(params)),
            "weight_bytes_rank": weight_bytes, "init_s": init_s,
            "init_peak": init_peak, "batches": batches,
            "ttft_s_per_batch": [b["prefill_s"] for b in batches],
            "prefill_tokens_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_ms_per_step": decode_ms,
            "decode_ms_per_step_per_batch": [
                b["decode_s"] / b["decode_steps"] * 1e3 for b in batches],
            "decode_tokens_s": SERVE_BATCH * st["decode_steps"]
            / st["decode_s"],
            "decode_read_bytes_rank": step_bytes + cache_rank,
            "decode_bound_ms": (step_bytes + cache_rank) / HBM_BW
            * 1e3,
            "model_collectives_ms": coll_ms,
            "model_collectives": len(engine.tp.events),
            "peak": torch.cuda.max_memory_allocated(dev),
            "launches": launches,
            "launches_wanted": {
                "flash_fwd": flash,
                "wkv6": scans if cfg.family == "rwkv" else 0,
                "ssm_scan": scans if cfg.family == "hybrid" else 0}}


def _serve_world1(torch, mesh) -> list:
    """The one-card leg on a (1, 1) mesh: each family's engine at one layer
    (whisper-small: one encoder and one decoder layer) and published
    widths, the parameters through ``init_params(..., mesh=)`` and the
    engine on the mesh, against the plain parameters and engine (frames
    or patches from a seed, ``_frontend_engine``): the weights, each
    step's logits and the tokens bit for bit, and the mesh engine's
    launches."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model_api

    ServeEngine = _frontend_engine()
    dev, out = mesh.device, []
    rng = np.random.default_rng(7)
    for arch in ("qwen2-7b", "mixtral-8x22b", "rwkv6-7b", "hymba-1.5b",
                 "whisper-small", "internvl2-2b"):
        cfg = _fe_cfg(arch, 1)
        toks = rng.integers(0, cfg.vocab, (SERVE_BATCH, 1800)) \
            .astype(np.int32)
        gc.collect()
        torch.cuda.empty_cache()
        runs = []
        for on_mesh in (True, False):
            params = model_api.init_params(cfg, 0, dev,
                                           mesh=mesh if on_mesh else None)
            engine = ServeEngine(cfg, params, batch_size=SERVE_BATCH,
                                 max_seq=1800 + SERVE_MAX_NEW + 1,
                                 mesh=mesh if on_mesh else None, device=dev)
            reset_launches()
            logits, tokens = _forced(torch, engine, toks, None)
            torch.cuda.synchronize(dev)
            cross = engine.cross_layout
            runs.append((T.leaves(params), logits, tokens,
                         read_launches(("flash_fwd", "wkv6", "ssm_scan"))))
            del engine
        (pm, lm, tm, launches), (pp, lp, tp_, _) = runs
        scans = 1 + SERVE_MAX_NEW
        out.append({"arch": arch, "n_layers": 1, "batch": SERVE_BATCH,
                    "prompt_len": 1800, "max_new": SERVE_MAX_NEW,
                    "params_equal": all(torch.equal(a, b)
                                        for a, b in zip(pm, pp)),
                    "logits_equal": bool(torch.equal(lm, lp)),
                    "tokens_equal": bool((tm == tp_).all()),
                    "launches": launches,
                    "launches_wanted": {
                        "flash_fwd": _serve_flash(
                            cfg, 1800, SERVE_MAX_NEW,
                            None if cross is None else cross.kind),
                        "wkv6": scans if cfg.family == "rwkv" else 0,
                        "ssm_scan": scans if cfg.family == "hybrid" else 0}})
        del runs, pm, pp, lm, lp
    return out


def _serve_tp_rank(mesh, legs):
    """One rank of ``phase_serve_tp`` (a spawned process), with the matmul
    settings of ``main``: ``serve_world1``, ``serve_tp_agree``, each
    ``serve_tp_time:<row>`` (an index into SERVE_TP_TIME) and
    ``serve_tp3_time`` in ``legs``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "shape": mesh.shape,
           "device": torch.cuda.get_device_name(mesh.device)}
    leg_s = out["leg_s"] = {}
    for leg in legs:
        t0 = time.perf_counter()
        if leg == "serve_world1":
            out[leg] = _serve_world1(torch, mesh)
        elif leg == "serve_tp_agree":
            out[leg] = _serve_tp_agree(torch, mesh)
        elif leg == "serve_tp3_time":
            out[leg] = _serve_tp_time(torch, mesh, *SERVE_TP3_TIME)
        else:
            out[leg] = _serve_tp_time(
                torch, mesh, *SERVE_TP_TIME[int(leg.split(":")[1])])
        leg_s[leg] = time.perf_counter() - t0
    return out


def _emit_serve_agree(shape, ranks, add, faults):
    """The ``serve_tp_agree`` lines of a mesh and their checks: every rank
    within ``SERVE_NOISE_FACTOR`` of the bf16 single card's distance from
    the f32 one, the layouts as named, the launches exact."""
    for i, (arch, lens, kind) in enumerate(SERVE_TP_AGREE[shape]):
        rows = [r["serve_tp_agree"][i] for r in ranks]
        for r in rows:
            add(r["launches"])
        emit({"phase": "serve_tp_agree", "mesh": list(shape),
              "arch": arch, "n_layers": SERVE_TP_AGREE_LAYERS.get(shape, 1),
              "mode": rows[0]["mode"],
              "prompt_lens": list(lens), "layout": rows[0]["layout"],
              "layout_wanted": kind,
              "cross_layout": rows[0]["cross_layout"],
              "max_new": SERVE_MAX_NEW,
              "noise_factor": SERVE_NOISE_FACTOR,
              "max_rel_l2_rank": [r["max_rel_l2"] for r in rows],
              "bf16_single_card_rel_l2_max": [
                  r["bf16_single_card_rel_l2_max"] for r in rows],
              "max_ratio_rank": [r["max_ratio"] for r in rows],
              "argmax_equal_share_rank": [r["argmax_equal_share"]
                                          for r in rows],
              "held_rank": [r["held"] for r in rows],
              "launches_rank": [r["launches"] for r in rows]})
        for r in rows:
            if (not r["held"] or r["layout"] != kind
                    or r["cross_layout"] != r["cross_layout_wanted"]
                    or r["launches"] != r["launches_wanted"]):
                faults.append(f"serve_tp_agree {shape} {arch} "
                              f"{lens}: {r}")


def _emit_serve_time(shape, leg, row, ranks, add, faults) -> dict:
    """A ``serve_tp_time`` line (leg ``leg`` of ``row``'s cell) and its
    checks: exact launches, every peak under the card, every token out.
    Returns rank 0's row."""
    rows = [r[leg] for r in ranks]
    lead = rows[0]
    for r in rows:
        add(r["launches"])
    emit({"phase": "serve_tp_time", "mesh": list(shape),
          **{k: v for k, v in lead.items()
             if k not in ("launches", "peak", "model_collectives_ms",
                          "init_s", "init_peak")},
          "init_s_rank": [r["init_s"] for r in rows],
          "init_peak_rank": [r["init_peak"] for r in rows],
          "peak_rank": [r["peak"] for r in rows],
          "model_collectives_ms_rank": [r["model_collectives_ms"]
                                        for r in rows],
          "launches_rank": [r["launches"] for r in rows]})
    for r in rows:
        if (r["launches"] != r["launches_wanted"]
                or max(r["peak"], r["init_peak"]) >= CARD_BYTES
                or sum(b["tokens_out"] for b in r["batches"])
                != row[3] * SERVE_MAX_NEW):
            faults.append(f"serve_tp_time {shape} {row[:2]}: {r}")
    return lead


def phase_serve_tp(torch, dev) -> dict:
    """Serving on the model and data axes.  One card: ``_serve_world1`` on
    a (1, 1) mesh.  Four cards: leg (i) ``serve_tp_agree`` and leg (j)
    ``serve_tp_time`` on a (1, 4) mesh, then leg (i) on a (2, 2) one.  Each
    mesh's lines are printed as soon as it ends, before any check fails
    the phase; returns the legs' launches, summed over the ranks."""
    from repro_torch.launch import mesh as mesh_lib

    world = torch.cuda.device_count()
    launches, faults = {}, []

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    shapes = {(1, 1): ["serve_world1"]} if world < 4 else {
        (1, 4): ["serve_tp_agree"] + [f"serve_tp_time:{i}" for i in
                                      range(len(SERVE_TP_TIME))],
        (2, 2): ["serve_tp_agree"]}
    for shape, legs in shapes.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(_serve_tp_rank, shape[0], (legs,),
                               model=shape[1], device="cuda",
                               timeout_s=SERVE_TP_TIMEOUT_S)
        _spawned("serve_tp_spawn", shape, legs, time.perf_counter() - t0, ranks)
        if "serve_world1" in legs:
            for case in ranks[0]["serve_world1"]:
                emit({"phase": "serve_world1", **case})
                add(case["launches"])
                if not (case["params_equal"] and case["logits_equal"]
                        and case["tokens_equal"]) or \
                        case["launches"] != case["launches_wanted"]:
                    faults.append(f"serve_world1: {case}")
        if "serve_tp_agree" in legs:
            _emit_serve_agree(shape, ranks, add, faults)
        for i, row in enumerate(SERVE_TP_TIME):
            leg = f"serve_tp_time:{i}"
            if leg in legs:
                MEASURED[("serve_tp_time", shape, i)] = _emit_serve_time(
                    shape, leg, row, ranks, add, faults)
    if faults:
        raise AssertionError("\n".join(faults))
    return launches


def _tp3_rank(mesh, legs):
    """One rank of ``phase_tp3`` (a spawned process): its training legs
    (``_tp_rank``), then its serving legs (``_serve_tp_rank``)."""
    train = [leg for leg in legs if not leg.startswith("serve")]
    out = _tp_rank(mesh, train)
    serve = _serve_tp_rank(mesh, [leg for leg in legs if leg not in train])
    out["leg_s"].update(serve.pop("leg_s"))
    out.update({k: v for k, v in serve.items() if k in legs})
    return out


def phase_tp3(torch, dev) -> dict:
    """The model axis where dims stay whole, on three of the cards: one
    spawn of a (1, 3) mesh running ``tp3_agree``, ``tp3_agg``,
    ``tp3_time``, ``serve_tp_agree`` (internlm2-20b at 2 layers) and
    ``serve_tp3_time`` (at 48).  Its lines are printed as soon as it
    ends, before any check fails the phase; returns the legs' launches,
    summed over the ranks."""
    from repro_torch.launch import mesh as mesh_lib

    launches, faults = {}, []

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    shape = (1, 3)
    arch, n, sched = TP3_TIME
    time_leg = f"tp3_time:{arch}:{n}:{sched}"
    legs = ["tp3_agree", "tp3_agg", time_leg, "serve_tp_agree",
            "serve_tp3_time"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(_tp3_rank, shape[0], (legs,), model=shape[1],
                           device="cuda", timeout_s=TP3_TIMEOUT_S)
    _spawned("tp3_spawn", shape, legs, time.perf_counter() - t0, ranks)
    cases = [(a, sc, st) for a, _, sc, st in TP3_AGREE + TP3_FE_AGREE]
    layers = {a: k for a, k, _, _ in TP3_AGREE + TP3_FE_AGREE}
    bpc = {a: (FE_BPC[a] if a in FE_BPC else BATCH_PER_CLIENT)
           for a, _, _ in cases}
    seq = {a: (FE_SEQ[a] if a in FE_SEQ else DIST_SEQ) for a, _, _ in cases}
    _emit_agree("tp3_agree", shape, cases, bpc, ranks, add, faults, seq,
                layers)
    rows = [r["tp3_agg"] for r in ranks]
    for r in rows:
        add(r["launches"])
    emit({"phase": "tp3_agg", "mesh": list(shape), "arch": "internlm2-20b",
          "n_layers": TP3_AGG_LAYERS, "clients": 2,
          "weights": list(TP_AGREE_WEIGHTS), "schedule": "compressed",
          "leaves": rows[0]["leaves"], "whole_leaves": rows[0]["whole_leaves"],
          "rank": [{k: r[k] for k in ("exact", "max_abs_err",
                                      "elements_differing", "finite", "ms")}
                   for r in rows],
          "launches_rank": [r["launches"] for r in rows]})
    for r in rows:
        got = r["launches"]
        if (not r["exact"] or got["qagg"] != r["leaves"] or got["fedavg"]
                or got["flash_fwd"]):
            faults.append(f"tp3_agg: {r}")
    _emit_time("tp3_time", shape, arch, n, sched, BATCH_PER_CLIENT,
               [r[time_leg] for r in ranks], add, faults)
    _emit_serve_agree(shape, ranks, add, faults)
    _emit_serve_time(shape, "serve_tp3_time", SERVE_TP3_TIME, ranks, add,
                     faults)
    if faults:
        raise AssertionError("\n".join(faults))
    return launches


def _dist_rank(mesh, legs):
    """One rank of ``phase_dist`` (a spawned process): the legs it is
    given, with the matmul settings of ``main``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "device": torch.cuda.get_device_name(mesh.device)}
    legs_of = {"world1": _dist_world1, "agree": _dist_agree,
               "time": _dist_time}
    for leg in legs:
        out[leg] = legs_of[leg](torch, mesh)
    return out


def _nvlink() -> dict:
    """The link between card 0 and card 1 as ``nvidia-smi topo -m`` reports
    it (``NV<n>``: n NVLink 4 links), and card 0's NVLink ports and their
    rates from ``nvidia-smi nvlink -s``; ``bytes_s`` is the per-direction
    rate to take, or None where neither reports it.  Both outputs go to
    chiprun_out/; a query the machine refuses is recorded, not raised."""
    import re
    runs = {}
    for args in (["topo", "-m"], ["nvlink", "-s", "-i", "0"]):
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
        runs[" ".join(args)] = out
    OUT.mkdir(exist_ok=True)
    (OUT / "nvidia_smi_topo.txt").write_text("\n".join(
        f"$ nvidia-smi {k} (rc {v.returncode})\n{v.stdout}{v.stderr}"
        for k, v in runs.items()))
    topo, links = runs["topo -m"], runs["nvlink -s -i 0"]
    entry = None
    for line in topo.stdout.splitlines() if topo.returncode == 0 else []:
        cells = line.split()
        if len(cells) > 2 and cells[0] == "GPU0":
            entry = cells[2]
    rates = [float(x) for x in re.findall(r"Link \d+: ([\d.]+) GB/s",
                                          links.stdout)] \
        if links.returncode == 0 else []
    m = re.fullmatch(r"NV(\d+)", entry or "")
    bytes_s = (sum(rates) * 1e9 if rates
               else int(m.group(1)) * NVLINK4_LINK_BYTES_S if m else None)
    return {"topo_entry": entry, "topo_rc": topo.returncode,
            "nvlink_ports": len(rates), "nvlink_port_gb_s": rates[:1],
            "bytes_s": bytes_s}


def phase_dist(torch, dev) -> dict:
    """The rank path over every card of the host, one client a card and
    NCCL between them (``launch.mesh.spawn``; a rank's failure or a run
    past ``DIST_TIMEOUT_S`` raises here).  One card: ``_dist_world1``.
    More: leg (a) ``_dist_agree`` and leg (b) ``_dist_time``.  Returns
    the main path's launches, summed over the ranks."""
    from repro_torch.launch import mesh as mesh_lib

    world = torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    legs = ("world1",) if world == 1 else ("agree", "time")
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(_dist_rank, world, (legs,), device="cuda",
                           timeout_s=DIST_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    if world == 1:
        w1 = ranks[0]["world1"]
        add(w1["launches"])
        emit({"phase": "dist", "dist": {
            "world": 1, "backend": ranks[0]["backend"], "arch": DIST_ARCH,
            "n_layers": 1, "clients": 1, "rounds": ROUNDS, "seq": DIST_SEQ,
            "wall_s": wall_s, **w1}})
        if not w1["state_equal"] or not w1["no_model_axis"] or \
                w1["losses"] != w1["single_device_losses"]:
            raise AssertionError(f"dist: the rank path at world 1 differs "
                                 f"from the single-device round: {w1}")
        if not all(a["equal"] for a in w1["aggregate"].values()):
            raise AssertionError(f"dist: aggregation at world 1: {w1}")
        w1m = w1["moe"]
        if not w1m["state_equal"] or w1m["optimizer"] != "adafactor" or \
                w1m["losses"] != w1m["single_device_losses"] or \
                w1m["routing"] != w1m["single_device_routing"] or \
                w1m["launches"]["flash_fwd"] != 2 * ROUNDS or any(
                    n for k, n in w1m["launches"].items() if k != "flash_fwd"):
            raise AssertionError(f"dist: mixtral-8x22b under Adafactor at "
                                 f"world 1 differs from the single-device "
                                 f"round: {w1m}")
        add(w1m["launches"])
        if w1["launches"]["flash_fwd"] < ROUNDS or any(
                n for k, n in w1["launches"].items() if k != "flash_fwd"):
            raise AssertionError(f"dist: launches {w1['launches']}")
        return launches

    link = _nvlink()
    faults = []
    for i, (sched, strat, fail) in enumerate(DIST_AGREE):
        rows = [r["agree"][i] for r in ranks]
        lead = rows[0]
        for r in rows:
            add(r["launches"])
        same = all(r["checksum"] == lead["checksum"] for r in rows)
        rel = abs(lead["loss"] - lead["single_loss"]) / abs(
            lead["single_loss"])
        emit({"phase": "dist_agree", "world": world, "schedule": sched,
              "strategy": strat, "fail_at": lead["fail_at"],
              "level_groups": lead["level_groups"],
              "n_clients": lead["n_clients"], "loss": lead["loss"],
              "single_card_loss": lead["single_loss"], "loss_rel_err": rel,
              "exact": lead["exact"], "max_abs_err": lead["max_abs_err"],
              "elements_differing": lead["elements_differing"],
              "beyond_1_bf16_ulp": lead["beyond_1_bf16_ulp"],
              "beyond_1_bf16_ulp_max_err": lead["beyond_1_bf16_ulp_max_err"],
              "beyond_1_bf16_ulp_max_abs_value": lead[
                  "beyond_1_bf16_ulp_max_abs_value"],
              "beyond_sum_tolerance": lead["beyond_sum_tolerance"],
              "slots_identical_across_ranks": same,
              "time_s": lead["time_s"], "aggregate_ms_max": lead[
                  "aggregate_ms"],
              "aggregate_ms_rank": [r["rank_ms"].get("aggregate_ms")
                                    for r in rows],
              "peak_rank": [r["peak"] for r in rows],
              "launches_rank": [r["launches"] for r in rows]})
        must_be_exact = sched == "compressed" or strat in EXACT_STRATEGIES
        if (not lead["finite"] or not same or rel > 1e-6
                or lead["level_groups"] != lead["single_level_groups"]
                or (must_be_exact and not lead["exact"])
                or lead["beyond_sum_tolerance"]):
            faults.append(f"dist_agree {sched}/{strat}: {lead}")
        want_qagg = lead["leaves"] if sched == "compressed" else 0
        for r in rows:
            got = r["launches"]
            if (got["flash_fwd"] < 1 or got["qagg"] != want_qagg
                    or got["fedavg"] or got["quantize"]
                    or got["dequantize"]):
                faults.append(f"dist_agree {sched}/{strat}: rank launches "
                              f"{got}")
    for i, sched in enumerate(DIST_TIME_SCHEDULES):
        rows = [r["time"][i] for r in ranks]
        lead = rows[0]
        for r in rows:
            add(r["launches"])
        sent = max(r["bytes_sent"] for r in rows)
        same = all(r["checksum"] == lead["checksum"] for r in rows)
        emit({"phase": "dist_time", "world": world, "schedule": sched,
              "arch": DIST_ARCH, "n_layers": DIST_TIME_LAYERS,
              "reduced": [f"depth {DIST_TIME_LAYERS} of 28"],
              "clients": world, "batch_per_client": BATCH_PER_CLIENT,
              "seq": DIST_SEQ, "rounds": ROUNDS,
              "params_per_client": lead["params_per_client"],
              "level_groups": lead["level_groups"],
              "init_s_rank": [r["init_s"] for r in rows],
              "round_s": lead["round_s"], "losses": lead["losses"],
              "aggregate_ms_rank": [r["aggregate_ms_rank"] for r in rows],
              "aggregate_ms_max": lead["aggregate_ms_max"],
              "bytes_sent_rank": [r["bytes_sent"] for r in rows],
              "link": link,
              "link_bound_ms": (sent / link["bytes_s"] * 1e3
                                if link["bytes_s"] else None),
              "peak_rank": [r["peak"] for r in rows],
              "flash_rank": [r["launches"]["flash_fwd"] for r in rows],
              "qagg_rank": [r["launches"]["qagg"] for r in rows],
              "slots_identical_across_ranks": same})
        if not all(math.isfinite(x) for x in lead["losses"]) or not same \
                or max(r["peak"] for r in rows) >= CARD_BYTES:
            faults.append(f"dist_time {sched}: {rows}")
    emit({"phase": "dist", "dist": {"world": world,
                                    "backend": ranks[0]["backend"],
                                    "cards": [r["device"] for r in ranks],
                                    "link": link, "wall_s": wall_s}})
    if faults:
        raise AssertionError("\n".join(faults))
    if world == 4:
        add(phase_tp(torch, dev))
        add(phase_shared(torch, dev))
    if world >= 3:
        add(phase_tp3(torch, dev))
    return launches


# ---- the dry run (``launch/dryrun.py``) against the four-card legs ------
# the cells, traced on the meta device in a subprocess on the host (its
# ``fake`` process group cannot share a process with NCCL's): tp_time's
# qwen2-7b at 28 layers (batch 1 a client, DIST_SEQ tokens) on (1, 4) tree
# and (2, 2) flat, and serve_tp_time's 32k context on (1, 4) (4 prompts of
# 32 768 tokens, the cache at 32 800 slots): (cell, mesh, schedule)
DRYRUN_CELLS = [("tp_time", (1, 4), "tree"), ("tp_time", (2, 2), "flat"),
                ("serve_tp_time", (1, 4), None)]
DRYRUN_SERVE_ROW = next(i for i, row in enumerate(SERVE_TP_TIME)
                        if row[4] == 32800)
# the cell whose extra round is also counted on the card
DRYRUN_OP_ROUND = ((1, 4), "tree")
DRYRUN_PEAK_RTOL = 0.15     # predicted peak against max_memory_allocated
DRYRUN_TIMEOUT_S = 600
MEASURED = {}               # rank 0's rows of the legs the dry run predicts


def dryrun_cells(path: str) -> None:
    """The dry run of ``DRYRUN_CELLS`` (``launch/dryrun.lower_cell``),
    written to ``path`` as JSON; ``phase_dryrun`` runs it in a subprocess
    that sees no card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    recs = []
    for cell, (D, M), sched in DRYRUN_CELLS:
        if cell == "tp_time":
            shape = ShapeConfig(cell, DIST_SEQ, D * BATCH_PER_CLIENT, "train")
            layers = TP_TIME_LAYERS
        else:
            arch, layers, lens, _, max_seq = SERVE_TP_TIME[DRYRUN_SERVE_ROW]
            shape = ShapeConfig(cell, max_seq, SERVE_BATCH, "decode")
        recs.append(dryrun.lower_cell(
            DIST_ARCH, shape, False, schedule=sched,
            overrides={"n_layers": layers},
            mesh_shape={"data": D, "model": M}))
    Path(path).write_text(json.dumps(recs))


def _op_diff(meta: dict, card: dict) -> dict:
    """Where the meta trace's ``OpCost`` and the card's round's differ
    (each op's calls apart)."""
    out = {k: (v, card[k]) for k, v in meta.items()
           if k != "op_counts" and v != card[k]}
    ops = set(meta["op_counts"]) | set(card["op_counts"])
    out["op_counts"] = {o: (meta["op_counts"].get(o, 0),
                            card["op_counts"].get(o, 0)) for o in sorted(ops)
                        if meta["op_counts"].get(o) != card["op_counts"].get(o)}
    return out


def phase_dryrun(torch, dev) -> None:
    """The dry run of ``DRYRUN_CELLS`` in a subprocess on the host, against
    what the four-card legs measured (rank 0's rows): exactly, each
    rank's parameters and state bytes and a round's kernel launches; for
    (1, 4) tree, every count of the card's extra round under ``OpCounter``
    (aten FLOPs and bytes, each aten op's calls, the collectives by kind and
    group size, the kernels' calls, FLOPs and bytes); within
    ``DRYRUN_PEAK_RTOL`` the predicted peak against round 1's
    ``max_memory_allocated``; exactly the 32k cell's cache bytes a rank.
    Printed beside them: the roofline's bound and dominant term against
    round 1's time, the whole-step share model FLOPs / (cards x 989 TFLOP/s
    x round s), and the NVLink rate ``nvidia-smi nvlink -s`` reads beside
    ``NVLINK_BW``.  On fewer than four cards there are no legs to hold it
    against, and the phase does not run (the CPU tests cover the records'
    own checks)."""
    from repro_torch.launch.mesh import NVLINK_BW, PEAK_FLOPS_BF16
    if torch.cuda.device_count() < 4:
        return
    OUT.mkdir(exist_ok=True)
    path = OUT / "dryrun_cells.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-cells",
         str(path)], env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    if proc.returncode:
        raise AssertionError(f"dryrun: the subprocess exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    recs = json.loads(path.read_text())
    wall_s = time.perf_counter() - t0
    smi = smi_line()
    link = _nvlink()
    faults = []
    for (cell, shape, sched), rec in zip(DRYRUN_CELLS, recs):
        if rec["status"] != "ok":
            faults.append(f"dryrun {cell} {shape}: {rec}")
            continue
        rf, mem = rec["roofline"], rec["memory"]
        line = {"phase": "dryrun", "cell": cell, "mesh": list(shape),
                "schedule": sched, "arch": DIST_ARCH, "trace_s":
                rec["trace_s"], "subprocess_s": wall_s,
                "params_per_rank": rec["params_per_rank"],
                "memory": mem, "kernels": rec["kernels"],
                "roofline": {k: rf[k] for k in (
                    "flops_per_dev", "hbm_bytes_per_dev", "collective_bytes",
                    "collective_cross_node_bytes", "collective_by_group",
                    "compute_s", "memory_s", "collective_s", "bound_s",
                    "dominant", "model_flops_total")},
                "nvidia_smi": smi}
        if cell == "tp_time":
            flash = rec["kernels"].get("flash_fwd", {}).get("launches", 0)
            if flash != 2 * TP_TIME_LAYERS or set(rec["kernels"]) != {
                    "flash_fwd"}:
                faults.append(f"dryrun {cell} {shape}: kernels "
                              f"{rec['kernels']}")
            got = MEASURED[("tp_time", shape, sched)]
            round_s = got["round_s"][1]
            peak = got["round1_max_memory_allocated"]
            line["measured"] = {
                "params_per_rank": got["params_per_rank"],
                "state_bytes": got["state_bytes"],
                "launches_per_round": {k: n / ROUNDS for k, n in
                                       got["launches"].items()},
                "round1_s": round_s, "round1_max_memory_allocated": peak,
                "peak_ratio": mem["total_per_device"] / peak,
                "bound_s_over_round1_s": rf["bound_s"] / round_s,
                "whole_step_share": rf["model_flops_total"] / (
                    rec["n_devices"] * PEAK_FLOPS_BF16 * round_s)}
            if (got["params_per_rank"] != rec["params_per_rank"]
                    or got["state_bytes"] != mem["state_bytes"]
                    or got["launches"]["flash_fwd"] != flash * ROUNDS
                    or abs(mem["total_per_device"] / peak - 1)
                    > DRYRUN_PEAK_RTOL):
                faults.append(f"dryrun {cell} {shape}: {line}")
            if (shape, sched) == DRYRUN_OP_ROUND:
                diff = _op_diff(rec["op_cost"], got["op_cost"])
                line["op_counts_equal"] = not any(diff.values())
                line["op_diff"] = diff
                if not line["op_counts_equal"]:
                    faults.append(f"dryrun {cell} {shape}: the card's "
                                  f"round counts differ: {diff}")
        else:
            got = MEASURED[("serve_tp_time", shape, DRYRUN_SERVE_ROW)]
            line["measured"] = {"cache_bytes_rank":
                                got["batches"][0]["cache_bytes_rank"]}
            if got["batches"][0]["cache_bytes_rank"] != \
                    mem["cache_bytes"]:
                faults.append(f"dryrun {cell} {shape}: {line}")
        line["nvlink"] = {"nvidia_smi_bytes_s": link["bytes_s"],
                          "NVLINK_BW": NVLINK_BW}
        emit(line)
    if faults:
        raise AssertionError("\n".join(faults))


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
         "bound_by": fed["bound_by"], "library_ms": fed["library_ms"]},
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
         "bound_by": qagg["bound_by"], "library_ms": None}]
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


# phases that use one card and nothing a second card changes: they run
# where the script runs on one card, and on more the four-card legs take
# their time (the one-card run holds the same checks)
ONE_CARD_ONLY = ("strategies", "resume_full")


def main(argv=None) -> int:
    adopt_orphans()
    try:
        return run(argv)
    finally:
        stop_children()


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace each training round with torch.profiler "
                         "(tables under chiprun_out/; slows the rounds)")
    ap.add_argument("--dryrun-cells", metavar="JSON", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_cells:              # phase_dryrun's subprocess
        dryrun_cells(args.dryrun_cells)
        return 0

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
    walls = {}
    LEG_WALLS.clear()

    def timed(name, fn, *a):
        """``fn(*a)``, its wall time added to ``walls[name]``."""
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    timed("device", phase_device, torch, dev, smi)
    fed = timed("fedavg", phase_fedavg, torch, dev)
    flash = timed("flash", phase_flash, torch, dev)
    qagg = timed("qagg", phase_qagg, torch, dev)
    quant8 = timed("quant8", phase_quant8, torch, dev)
    wkv = timed("wkv", phase_wkv, torch, dev)
    skip = ONE_CARD_ONLY if torch.cuda.device_count() > 1 else ()
    if skip:
        emit({"phase": "one_card_only", "cards": torch.cuda.device_count(),
              "not_run": list(skip)})
    if "strategies" not in skip:
        timed("strategies", phase_strategies, torch, dev)
    launches = {}
    for phase, arch, n_layers, schedule, strategy, fail_at in TRAIN_CELLS:
        add(timed(phase, phase_train, torch, dev, phase, arch, n_layers,
                  schedule, strategy, fail_at, args.profile))
    for cell in FRONTEND_TRAIN_CELLS:
        add(timed(cell[0], phase_train_frontend, torch, dev, *cell,
                  args.profile))
    add(timed("adapter", phase_adapter, torch, dev))
    timed("resume", phase_resume, torch, dev)
    if "resume_full" not in skip:
        add(timed("resume_full", phase_resume_full, torch, dev))
    timed("serve_kernels", phase_serve_kernels, torch, dev)
    for cell in SERVE_CELLS:
        add(timed(cell[0], phase_serve, torch, dev, *cell))
    add(timed("dist", phase_dist, torch, dev))
    add(timed("serve_tp", phase_serve_tp, torch, dev))
    timed("dryrun", phase_dryrun, torch, dev)
    emit({"phase": "walls", "s": walls, "legs_s": LEG_WALLS})
    emit({"kernels": kernel_rows(fed, flash, qagg, quant8, wkv, launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
