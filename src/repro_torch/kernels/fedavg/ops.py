"""Dispatch for the fedavg kernel (``csrc/fedavg.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises (wrong card, failed build, failed launch, unsupported
dtype or shape).  ``launches`` counts kernel launches, so a run can show
that its aggregation went through the kernel."""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg.ref import fedavg_ref

launches = 0

_FN = {torch.bfloat16: "fedavg_bf16", torch.float32: "fedavg_f32"}
MAX_CLIENTS = 256


def fedavg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading (clients) axis of (K, N) -> (N,), in
    the input dtype, accumulated in f32."""
    global launches
    if stacked.dim() != 2 or weights.shape != (stacked.shape[0],):
        raise ValueError(f"fedavg: stacked {tuple(stacked.shape)} must be "
                         f"(K, N) and weights (K,), got {tuple(weights.shape)}")
    if stacked.device.type == "cpu":
        return fedavg_ref(stacked, weights)
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
    status = getattr(_build.load(), _FN[stacked.dtype])(
        stacked.data_ptr(), w.data_ptr(), out.data_ptr(), K, N,
        _build.stream_ptr(stacked))
    _build.check_status(status, "fedavg")
    launches += 1
    return out


def fedavg_pytree(params_stacked, weights):
    """Apply fedavg leaf-wise over a client-stacked parameter tree."""
    def one(leaf):
        K = leaf.shape[0]
        return fedavg(leaf.reshape(K, -1), weights).reshape(leaf.shape[1:])
    return T.tree_map(one, params_stacked)
