"""Plain PyTorch versions of the fused weighted-aggregation kernels
(FedAvg and the int8 dequantize-aggregate ``qagg``).

Both sum the clients in the kernels' fixed order k = 0..K-1, with separate
f32 multiplies and adds, so on the card they agree with the kernels bit for
bit.  Against the JAX package, ``fedavg_ref`` agrees with its einsum to f32
rounding, and ``qagg_ref`` with its ``qagg_ref`` run op by op bit for bit.
Compiled (its Pallas kernel, or under ``jax.jit``), XLA fuses ``sum(x * w)``
into fused multiply-adds, which changes no bit at unit weights, the
``compressed`` schedule's case."""
from __future__ import annotations

import torch


def _weighted_sum(x, w, idx):
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in idx:
        acc = acc + x[k].float() * w[k]
        total = total + w[k]
    return acc, total


def fedavg_ref(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (K, N) — K client parameter blocks; weights: (K,).
    Returns the weighted mean (N,), computed in f32, cast back."""
    w = weights.float()
    acc, total = _weighted_sum(stacked, w, range(stacked.shape[0]))
    return (acc / total).to(stacked.dtype)


def fedavg_tree_ref(stacked, weights, groups):
    """Hierarchical version: per-group weighted sums, then their sum —
    equal to ``fedavg_ref`` up to f32 rounding (associativity)."""
    w = weights.float()
    acc = torch.zeros(stacked.shape[1:], dtype=torch.float32,
                      device=stacked.device)
    total = torch.zeros((), dtype=torch.float32, device=stacked.device)
    for g in groups:
        a, t = _weighted_sum(stacked, w, g)
        acc = acc + a
        total = total + t
    return (acc / total).to(stacked.dtype)


def qagg_ref(q: torch.Tensor, scales: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """q: (K, R, G) int8; scales: (K, R, 1) f32; weights: (K,).  Returns
    the f32 sum over k = 0..K-1, in that order, of
    ``(q[k] * scales[k]) * weights[k]``: (R, G)."""
    w = weights.float()
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for k in range(q.shape[0]):
        acc = acc + (q[k].float() * scales[k]) * w[k]
    return acc
