"""Federated data partitioning: IID and Dirichlet non-IID splits plus
per-client token-stream shards (each FL client sees its own distribution —
the heterogeneity that motivates SDFLMQ's role optimization)."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import TokenStream, mnist_like


def dirichlet_split(y: np.ndarray, n_clients: int, alpha: float = 0.5,
                    seed: int = 0) -> list[np.ndarray]:
    """Label-skewed split (lower alpha = more skew).  Every client gets at
    least one sample."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, cuts)):
            idx_per_client[ci].extend(part.tolist())
    out = []
    for ci in range(n_clients):
        if not idx_per_client[ci]:
            idx_per_client[ci] = [int(rng.integers(0, len(y)))]
        out.append(np.asarray(sorted(idx_per_client[ci])))
    return out


def iid_split(n: int, n_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


class FederatedMNIST:
    """The paper's evaluation setup: each client holds a fraction of the
    training set (Fig. 7 uses 1% per client across 5 clients)."""

    def __init__(self, n_clients: int, frac_per_client: float = 0.01,
                 total: int = 60000, alpha: float | None = None,
                 seed: int = 0):
        self.x, self.y = mnist_like(total, seed=seed)
        per = max(1, int(total * frac_per_client))
        if alpha is None:
            splits = iid_split(total, n_clients, seed)
            self.client_idx = [s[:per] for s in splits]
        else:
            splits = dirichlet_split(self.y, n_clients, alpha, seed)
            self.client_idx = [s[:per] for s in splits]
        xt, yt = mnist_like(10000, seed=seed + 1)
        self.test = (xt, yt)

    def client_data(self, i: int):
        idx = self.client_idx[i]
        return self.x[idx], self.y[idx]

    def n_samples(self, i: int) -> int:
        return len(self.client_idx[i])


class FederatedTokens:
    """Per-client token streams with distinct transition structure
    (non-IID) — used by the LM examples and the e2e driver."""

    def __init__(self, vocab: int, n_clients: int, seed: int = 0,
                 heterogeneous: bool = True):
        self.streams = [
            TokenStream(vocab, seed=seed + (i if heterogeneous else 0),
                        noise=0.05 + 0.1 * (i % 3))
            for i in range(n_clients)
        ]

    def client_batch(self, i: int, batch: int, seq: int, step: int):
        return self.streams[i].batch(batch, seq, step)

    def global_batch(self, clients: int, per_client: int, seq: int, step: int):
        import numpy as np
        bs = [self.client_batch(i, per_client, seq, step)
              for i in range(clients)]
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}
