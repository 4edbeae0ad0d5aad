"""Tiny numpy MLP — the paper's Fig.7 workload (MNIST digit classifier).
Pure numpy so the control-plane benchmarks measure SDFLMQ, not XLA."""
from __future__ import annotations

import numpy as np

Params = dict[str, np.ndarray]


def init_mlp(seed: int = 0, dims=(784, 128, 10)) -> Params:
    rng = np.random.default_rng(seed)
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = (rng.normal(0, 1, (dims[i], dims[i + 1]))
                      * np.sqrt(2.0 / dims[i])).astype(np.float32)
        p[f"b{i}"] = np.zeros(dims[i + 1], np.float32)
    return p


def _forward(p: Params, x: np.ndarray):
    n = len([k for k in p if k.startswith("w")])
    h = x
    acts = [x]
    for i in range(n):
        z = h @ p[f"w{i}"] + p[f"b{i}"]
        h = np.maximum(z, 0) if i < n - 1 else z
        acts.append(h)
    return h, acts


def predict(p: Params, x: np.ndarray) -> np.ndarray:
    return _forward(p, x)[0].argmax(-1)


def accuracy(p: Params, x: np.ndarray, y: np.ndarray) -> float:
    return float((predict(p, x) == y).mean())


def train_epochs(p: Params, x: np.ndarray, y: np.ndarray, epochs: int = 5,
                 lr: float = 0.01, batch: int = 32, seed: int = 0) -> Params:
    rng = np.random.default_rng(seed)
    p = {k: v.copy() for k, v in p.items()}
    n = len(x)
    n_layers = len([k for k in p if k.startswith("w")])
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n, batch):
            idx = order[s:s + batch]
            xb, yb = x[idx], y[idx]
            logits, acts = _forward(p, xb)
            z = logits - logits.max(-1, keepdims=True)
            e = np.exp(z)
            probs = e / e.sum(-1, keepdims=True)
            g = probs
            g[np.arange(len(yb)), yb] -= 1.0
            g /= len(yb)
            for i in reversed(range(n_layers)):
                a_in = acts[i]
                p[f"w{i}"] -= lr * (a_in.T @ g)
                p[f"b{i}"] -= lr * g.sum(0)
                if i > 0:
                    g = (g @ p[f"w{i}"].T) * (acts[i] > 0)
    return p
