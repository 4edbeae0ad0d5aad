"""The federation's inputs as the seed defines them, worked out again in
plain NumPy: each client's token stream and each client's FedAvg weight
(its sample count).

The definitions are the trainer's (its per-client Markov token streams,
non-IID through each client's own mixing constants and noise rate, and its
simulated fleet's sample counts), written out here so that the comparison
holds the trainer's data layer to them.
"""
from __future__ import annotations

import numpy as np

ORDER = 3


def client_tokens(vocab: int, seed: int, client: int, batch: int, seq: int,
                  step: int) -> dict:
    """Client ``client``'s batch of round ``step``: {"tokens", "labels"},
    each (batch, seq) int32."""
    rng = np.random.default_rng(seed + client)
    mix = rng.integers(1, vocab, size=ORDER) | 1
    noise = 0.05 + 0.1 * (client % 3)
    rng = np.random.default_rng(hash((step, batch, seq)) & 0xffffffff)
    toks = np.zeros((batch, seq + 1), np.int64)
    toks[:, :ORDER] = rng.integers(0, vocab, (batch, ORDER))
    for t in range(ORDER, seq + 1):
        det = (toks[:, t - ORDER:t] * mix).sum(1) % vocab
        draw = rng.integers(0, vocab, batch)
        use = rng.random(batch) < noise
        toks[:, t] = np.where(use, draw, det)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def fedavg_weights(seed: int, n_clients: int) -> np.ndarray:
    """(K,) f32: each client's sample count, drawn after its memory,
    bandwidth and speed from one generator, in client order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clients):
        rng.choice([512, 1024, 2048, 4096])
        rng.uniform(100, 1000)
        rng.uniform(0.25, 2.0)
        out.append(int(rng.integers(200, 2000)) or 1.0)
    return np.asarray(out, np.float32)
