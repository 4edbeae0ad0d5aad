"""Plain PyTorch versions of the fused weighted-aggregation (FedAvg) kernel.

``fedavg_ref`` sums the clients in the kernel's fixed order k = 0..K-1,
with separate f32 multiplies and adds, so on the card it agrees with the
kernel bit for bit; against the JAX package's einsum it agrees to f32
rounding."""
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
