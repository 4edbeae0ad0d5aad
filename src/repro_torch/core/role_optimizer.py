"""Role-optimization policies (paper §III-E6): the load balancer that ranks
clients for aggregator duty each round.  Policies are modular — register
new ones with ``@policy("name")``.  A policy sees the per-client stats and
the round index and returns client ids best-first.
"""
from __future__ import annotations

import functools
from typing import Callable

from repro_torch.core.stats import ClientStats

_POLICIES: dict[str, Callable] = {}


def policy(name: str):
    def deco(fn):
        # Every policy sees the empty cohort (all clients churned out
        # mid-round); ranking nothing is [] — not a ZeroDivisionError in
        # round_robin's modulo or an arbitrary per-policy crash.
        @functools.wraps(fn)
        def guarded(stats: dict[str, ClientStats], round_idx: int,
                    *args, **kwargs) -> list[str]:
            if not stats:
                return []
            return fn(stats, round_idx, *args, **kwargs)
        _POLICIES[name] = guarded
        return guarded
    return deco


def get_policy(name: str) -> Callable:
    if name not in _POLICIES:
        raise KeyError(f"unknown role policy {name!r}; have {sorted(_POLICIES)}")
    return _POLICIES[name]


def list_policies() -> list[str]:
    return sorted(_POLICIES)


@policy("static")
def static_policy(stats: dict[str, ClientStats], round_idx: int) -> list[str]:
    """Fixed aggregator placement (the paper's client/server strawman)."""
    return sorted(stats)


@policy("round_robin")
def round_robin(stats: dict[str, ClientStats], round_idx: int) -> list[str]:
    """Rotate aggregator duty to avoid device exhaustion (paper §II)."""
    ids = sorted(stats)
    k = round_idx % len(ids)
    return ids[k:] + ids[:k]


@policy("memory_aware")
def memory_aware(stats: dict[str, ClientStats], round_idx: int) -> list[str]:
    """Rank by free memory + bandwidth (aggregators hold K models and
    receive them over the network — the paper's overflow scenario)."""
    def score(s: ClientStats) -> float:
        return s.mem_free_mb + 0.5 * s.bandwidth_mbps
    return sorted(stats, key=lambda c: -score(stats[c]))


@policy("perf_aware")
def perf_aware(stats: dict[str, ClientStats], round_idx: int) -> list[str]:
    """Memory/bandwidth/speed blend, penalizing measured round latency and
    consecutive aggregator duty (exhaustion avoidance)."""
    def score(s: ClientStats) -> float:
        return (s.mem_free_mb / max(s.mem_total_mb, 1.0)
                + 0.002 * s.bandwidth_mbps
                + 0.5 * s.cpu_speed
                - 0.2 * s.last_round_s
                - 0.1 * s.rounds_as_aggregator)
    return sorted(stats, key=lambda c: -score(stats[c]))


@policy("reputation_aware")
def reputation_aware(stats: dict[str, ClientStats], round_idx: int) -> list[str]:
    """Moving-target defense (fedstellar-style): aggregator duty rotates
    round-by-round across the *trusted* set (reputation >= 0.5, the
    coordinator's ``demote_below`` default), so a compromised head cannot
    own a cluster indefinitely; suspects sort to the back (best reputation
    first) and only ever rank when no trusted client remains."""
    def rep(c: str) -> float:
        return getattr(stats[c], "reputation", 1.0)
    ids = sorted(stats)
    trusted = [c for c in ids if rep(c) >= 0.5]
    suspects = [c for c in ids if rep(c) < 0.5]
    if not trusted:            # everyone quarantined: degrade gracefully
        return sorted(ids, key=lambda c: -rep(c))
    k = round_idx % len(trusted)
    return trusted[k:] + trusted[:k] + sorted(suspects, key=lambda c: -rep(c))


@policy("blackbox")
def blackbox(stats: dict[str, ClientStats], round_idx: int) -> list[str]:
    """Black-box optimizer stub (paper future work: swarm/GA): hill-climbs
    on last_round_s only, no visibility into client internals."""
    return sorted(stats, key=lambda c: stats[c].last_round_s)


@policy("genetic")
def genetic(stats: dict[str, ClientStats], round_idx: int,
            pop: int = 24, gens: int = 12, elite: int = 4) -> list[str]:
    """Black-box aggregator placement via a small genetic algorithm —
    the paper's §VII expansion.  Chromosome = permutation of clients
    (prefix become aggregator candidates); fitness = modeled round delay
    of a 30%-aggregator tree under that ranking (bandwidth-serialized
    receive at each head + slowest-trainer arrival).  Deterministic per
    (round, membership)."""
    import zlib

    import numpy as np

    ids = sorted(stats)
    n = len(ids)
    if n <= 2:
        return ids
    # stable across processes (python str hash is salted)
    seed = zlib.crc32(repr((round_idx, ids)).encode())
    rng = np.random.default_rng(seed)
    n_agg = max(1, int(round(n * 0.3)))

    def fitness(perm) -> float:
        heads = [ids[i] for i in perm[:n_agg]]
        rest = [ids[i] for i in perm[n_agg:]]
        share = -(-len(rest) // n_agg)
        total = 0.0
        worst_head = 0.0
        for hi, h in enumerate(heads):
            members = rest[hi * share:(hi + 1) * share]
            bw = stats[h].bandwidth_mbps + 1e-3
            recv = (len(members) + 1) / bw          # serialized inbound
            arrive = max([1.0 / max(stats[m].cpu_speed, 1e-3)
                          for m in members] or [0.0])
            head_t = (max(recv, arrive)
                      + 0.1 * stats[h].rounds_as_aggregator)
            total += head_t
            worst_head = max(worst_head, head_t)
        # Root fan-in: the elected root receives one model per OTHER
        # head, so a single-head tree pays nothing; the session elects
        # the best-connected head as root, so that is the one priced.
        root_bw = max(stats[h].bandwidth_mbps for h in heads) + 1e-3
        fan_in = (n_agg - 1) / root_bw
        # mean head load as a mild balance term: among placements with
        # the same critical path, prefer the one loading heads evenly
        return worst_head + fan_in + 0.05 * total / n_agg

    population = [rng.permutation(n) for _ in range(pop)]
    for _ in range(gens):
        scored = sorted(population, key=fitness)
        nxt = scored[:elite]
        while len(nxt) < pop:
            a, b = scored[rng.integers(0, max(elite * 2, 2))], \
                scored[rng.integers(0, max(elite * 2, 2))]
            cut = int(rng.integers(1, n))
            prefix = list(a[:cut])
            taken = set(prefix)         # O(n) crossover, not O(n^2) scans
            child = prefix + [g for g in b if g not in taken]
            if rng.random() < 0.3:                  # swap mutation
                i, j = rng.integers(0, n, 2)
                child[i], child[j] = child[j], child[i]
            nxt.append(np.asarray(child))
        population = nxt
    best = min(population, key=fitness)
    return [ids[i] for i in best]
