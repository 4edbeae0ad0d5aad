"""Deterministic synthetic data: token streams for LM training and an
MNIST-like classification set for the paper-replication benchmarks
(no network access in this environment — the distribution is procedural
but class-structured, so FedAvg convergence curves behave like Fig. 7).
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Markov-ish synthetic token stream with learnable structure:
    next-token depends on a sliding hash of the previous K tokens, so CE
    genuinely decreases during training."""

    def __init__(self, vocab: int, seed: int = 0, order: int = 3,
                 noise: float = 0.1):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.order = order
        self.noise = noise
        self._mix = self.rng.integers(1, vocab, size=order) | 1

    def batch(self, batch: int, seq: int, step: int = 0):
        rng = np.random.default_rng((hash((step, batch, seq)) & 0xffffffff))
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, :self.order] = rng.integers(0, self.vocab,
                                            (batch, self.order))
        for t in range(self.order, seq + 1):
            det = (toks[:, t - self.order:t] * self._mix).sum(1) % self.vocab
            noise = rng.integers(0, self.vocab, batch)
            use_noise = rng.random(batch) < self.noise
            toks[:, t] = np.where(use_noise, noise, det)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def mnist_like(n: int, seed: int = 0, n_classes: int = 10, dim: int = 784,
               structure_seed: int = 42):
    """Class-structured 28x28-like data: per-class template + noise +
    smooth deformation.  The class structure (templates/basis) is fixed by
    ``structure_seed`` so independently drawn train/test sets share it;
    ``seed`` only draws samples."""
    srng = np.random.default_rng(structure_seed)
    templates = srng.normal(0, 1.0, (n_classes, dim)).astype(np.float32)
    basis = srng.normal(0, 1, (8, dim)).astype(np.float32)  # confusables
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    coef = rng.normal(0, 0.6, (n, 8)).astype(np.float32)
    x = templates[y] + coef @ basis + rng.normal(0, 1.5, (n, dim)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)
