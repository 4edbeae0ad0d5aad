"""Dispatch for the fedavg kernel (``csrc/fedavg.cu``) and the int8
dequantize-aggregate kernel qagg (``csrc/qagg.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises (wrong card, failed build, failed launch, unsupported
dtype or shape).  ``launches`` and ``qagg_launches`` count kernel launches,
so a run can show that its aggregation went through the kernels.  A meta
tensor (a dry run, ``launch/dryrun.py``) gets the kernel's output shape
and dtype and launches nothing.  ``cost`` and ``qagg_cost`` give one
launch's (FLOPs, bytes); each launch, and each meta call, reports them to
the active op counters (``_build.record``)."""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg.ref import fedavg_ref, qagg_ref

launches = 0
qagg_launches = 0

_FN = {torch.bfloat16: "fedavg_bf16", torch.float32: "fedavg_f32"}
MAX_CLIENTS = 256


def cost(K: int, N: int, dtype) -> tuple[float, float]:
    """(FLOPs, bytes) of one fedavg launch over a (K, N) stack: a multiply
    and an add per element; the stack read and the mean written once."""
    return 2.0 * K * N, float((K * N + N) * dtype.itemsize)


def qagg_cost(K: int, R: int, G: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one qagg launch over K (R, G) int8 payloads: a
    scale, a weight and an add per element; q and the f32 row scales read,
    the f32 sum written."""
    return 3.0 * K * R * G, float(K * R * G + 4 * K * R + 4 * R * G)


def fedavg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading (clients) axis of (K, N) -> (N,), in
    the input dtype, accumulated in f32."""
    global launches
    if stacked.dim() != 2 or weights.shape != (stacked.shape[0],):
        raise ValueError(f"fedavg: stacked {tuple(stacked.shape)} must be "
                         f"(K, N) and weights (K,), got {tuple(weights.shape)}")
    if stacked.device.type == "cpu":
        return fedavg_ref(stacked, weights)
    meta = stacked.device.type == "meta"
    if not meta:
        _build.check_device(stacked, "fedavg")
    K, N = stacked.shape
    if stacked.dtype not in _FN:
        raise TypeError(f"fedavg kernel takes bf16 or f32, got {stacked.dtype}")
    if not 1 <= K <= MAX_CLIENTS or N < 1:
        raise ValueError(f"fedavg kernel takes 1..{MAX_CLIENTS} clients and "
                         f"N >= 1, got ({K}, {N})")
    if not stacked.is_contiguous():
        raise ValueError("fedavg kernel takes a contiguous (K, N) stack")
    if weights.device != stacked.device or weights.dtype != torch.float32:
        raise ValueError("fedavg kernel takes f32 weights on the stack's card")
    w = weights.contiguous()
    out = torch.empty((N,), dtype=stacked.dtype, device=stacked.device)
    if not meta:
        status = getattr(_build.load(), _FN[stacked.dtype])(
            stacked.data_ptr(), w.data_ptr(), out.data_ptr(), K, N,
            _build.stream_ptr(stacked))
        _build.check_status(status, "fedavg")
        launches += 1
    _build.record("fedavg", cost, K, N, stacked.dtype)
    return out


def qagg(q: torch.Tensor, scales: torch.Tensor,
         weights: torch.Tensor) -> torch.Tensor:
    """Fused int8 dequantize + weighted sum over the leading client axis.

    q: (K, *shape) int8 with ``quantize_int8``-style per-last-dim-row
    scales (K, *shape[:-1], 1) f32; weights: (K,).  Returns the f32
    weighted sum shaped ``shape``.  The kernel sees (K, R, G): G is the
    last dim (1 for a scalar leaf), R the rows before it."""
    global qagg_launches
    K = q.shape[0]
    shape = q.shape[1:]
    G = shape[-1] if shape else 1
    q3 = q.reshape(K, -1, G)
    s3 = scales.reshape(K, -1, 1)
    if weights.shape != (K,) or s3.shape != q3.shape[:2] + (1,):
        raise ValueError(f"qagg: q {tuple(q.shape)} needs scales with one "
                         f"value per row and weights ({K},), got "
                         f"{tuple(scales.shape)} and {tuple(weights.shape)}")
    if q.device.type == "cpu":
        return qagg_ref(q3, s3, weights).reshape(shape)
    meta = q.device.type == "meta"
    if not meta:
        _build.check_device(q, "qagg")
    R = q3.shape[1]
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"qagg kernel takes int8 q and f32 scales, got "
                        f"{q.dtype} and {scales.dtype}")
    if not 1 <= K <= MAX_CLIENTS or R * G < 1:
        raise ValueError(f"qagg kernel takes 1..{MAX_CLIENTS} clients and "
                         f"a non-empty leaf, got {tuple(q.shape)}")
    if not (q3.is_contiguous() and s3.is_contiguous()):
        raise ValueError("qagg kernel takes contiguous q and scales")
    if (weights.device != q.device or weights.dtype != torch.float32
            or scales.device != q.device):
        raise ValueError("qagg kernel takes f32 weights and scales on q's card")
    w = weights.contiguous()
    out = torch.empty((R, G), dtype=torch.float32, device=q.device)
    if not meta:
        status = _build.load().qagg(
            q3.data_ptr(), s3.data_ptr(), w.data_ptr(), out.data_ptr(), K, R,
            G, _build.stream_ptr(q))
        _build.check_status(status, "qagg")
        qagg_launches += 1
    _build.record("qagg", qagg_cost, K, R, G)
    return out.reshape(shape)


def fedavg_pytree(params_stacked, weights):
    """Apply fedavg leaf-wise over a client-stacked parameter tree."""
    def one(leaf):
        K = leaf.shape[0]
        return fedavg(leaf.reshape(K, -1), weights).reshape(leaf.shape[1:])
    return T.tree_map(one, params_stacked)
