"""Client system stats (paper: PSUtil/Tracemalloc readings drive the role
optimizer).  On the simulated fleet, heterogeneous per-client stats evolve
deterministically; on a real host, ``local_stats`` reads the process."""
from __future__ import annotations

import os
import resource
import zlib
from dataclasses import asdict, dataclass

import numpy as np


@dataclass
class ClientStats:
    client_id: str
    mem_total_mb: float = 1024.0
    mem_free_mb: float = 512.0
    bandwidth_mbps: float = 100.0
    cpu_speed: float = 1.0          # relative compute speed
    last_round_s: float = 0.0       # measured round latency
    rounds_as_aggregator: int = 0
    samples: int = 0                # local dataset size (FedAvg weight)
    reputation: float = 1.0         # coordinator trust score (defense)

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ClientStats":
        return ClientStats(**d)


class StatsSimulator:
    """Deterministic heterogeneous fleet: each client gets a capability draw
    plus slow drift + jitter per round (the paper's motivation: aggregator
    merit changes over time, so roles must move)."""

    def __init__(self, client_ids: list[str], seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.base: dict[str, ClientStats] = {}
        for cid in client_ids:
            self.base[cid] = ClientStats(
                client_id=cid,
                mem_total_mb=float(self.rng.choice([512, 1024, 2048, 4096])),
                bandwidth_mbps=float(self.rng.uniform(100, 1000)),
                cpu_speed=float(self.rng.uniform(0.25, 2.0)),
                samples=int(self.rng.integers(200, 2000)),
            )
            self.base[cid].mem_free_mb = self.base[cid].mem_total_mb * 0.7

    def sample(self, cid: str, round_idx: int) -> ClientStats:
        b = self.base[cid]
        # stable per-client phase: str hash() is randomized per process
        # (PYTHONHASHSEED), which would make fleets differ across runs
        phase = zlib.crc32(cid.encode()) % 13
        drift = 0.5 + 0.5 * np.sin(round_idx / 7.0 + phase)
        jitter = float(self.rng.uniform(0.8, 1.2))
        s = ClientStats(**b.to_dict())
        s.mem_free_mb = b.mem_total_mb * 0.4 * drift * jitter
        s.bandwidth_mbps = b.bandwidth_mbps * jitter
        return s


def local_stats(client_id: str) -> ClientStats:
    """Best-effort real process stats (no psutil in this environment)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    rss_mb = ru.ru_maxrss / 1024.0
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**20
    return ClientStats(client_id=client_id, mem_total_mb=total,
                       mem_free_mb=max(total - rss_mb, 0.0),
                       bandwidth_mbps=1000.0, cpu_speed=1.0)
