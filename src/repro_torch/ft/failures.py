"""Fault tolerance: failure injection + detection, straggler mitigation,
elastic membership.  The detection path IS the paper's mechanism: a dead
client's MQTT last-will fires -> coordinator drops it and rearranges roles
(only affected clients receive messages); the data plane recompiles (and
caches) the aggregation schedule for the surviving membership.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class FailurePlan:
    """Deterministic failure/straggle schedule for tests and benchmarks."""
    fail_at: dict[int, list[str]] = field(default_factory=dict)     # round -> clients
    straggle_at: dict[int, dict[str, float]] = field(default_factory=dict)
    join_at: dict[int, list[str]] = field(default_factory=dict)

    @staticmethod
    def random(client_ids: list[str], rounds: int, p_fail: float = 0.02,
               p_straggle: float = 0.1, seed: int = 0) -> "FailurePlan":
        rng = np.random.default_rng(seed)
        plan = FailurePlan()
        alive = list(client_ids)
        for r in range(rounds):
            dead = [c for c in alive if rng.random() < p_fail]
            if dead and len(alive) - len(dead) >= 2:
                plan.fail_at[r] = dead
                alive = [c for c in alive if c not in dead]
            slow = {c: float(rng.uniform(2, 10)) for c in alive
                    if rng.random() < p_straggle}
            if slow:
                plan.straggle_at[r] = slow
        return plan


class StragglerPolicy:
    """Deadline-based partial aggregation: after ``deadline_s`` (or a
    quantile of observed latencies), the coordinator flushes aggregators;
    FedAvg weights renormalize over the responsive subset — the update
    stays an unbiased weighted mean of received contributions.

    Attach a shared ``repro_torch.api.transport.SimClock`` to read waits from
    virtual time instead of counting them: ``round_started()`` stamps the
    round's start and ``should_cut(got=…, expected=…)`` (no explicit
    ``waited_s``) measures the wait on the clock."""

    def __init__(self, deadline_s: float = 0.0, quantile: float = 0.9,
                 min_fraction: float = 0.5, clock=None):
        self.deadline_s = deadline_s
        self.quantile = quantile
        self.min_fraction = min_fraction
        self.clock = clock                  # SimClock-like: .now
        self.round_started_at = 0.0
        self.history: list[float] = []

    def attach_clock(self, clock) -> "StragglerPolicy":
        self.clock = clock
        return self

    def round_started(self, now: float | None = None) -> None:
        self.round_started_at = (now if now is not None
                                 else self.clock.now if self.clock else 0.0)

    def waited(self) -> float:
        if self.clock is None:
            return 0.0
        return self.clock.now - self.round_started_at

    def observe(self, latency_s: float) -> None:
        self.history.append(latency_s)
        self.history = self.history[-256:]

    def deadline(self) -> float:
        if self.deadline_s > 0:
            return self.deadline_s
        if not self.history:
            return float("inf")
        return 1.5 * float(np.quantile(self.history, self.quantile))

    def should_cut(self, waited_s: float | None = None, got: int = 0,
                   expected: int = 0) -> bool:
        if waited_s is None:
            waited_s = self.waited()        # read the shared virtual clock
        if got >= expected:
            return True
        if got < self.min_fraction * expected:
            return False
        return waited_s >= self.deadline()


def demote_stragglers(latencies: dict[str, float], ranked: list[str],
                      factor: float = 2.0) -> list[str]:
    """Aggregator candidates persistently slower than the median get pushed
    to the back of the ranking (exhaustion avoidance, paper §II)."""
    if not latencies:
        return ranked
    med = float(np.median(list(latencies.values())))
    slow = {c for c, l in latencies.items() if l > factor * med}
    return [c for c in ranked if c not in slow] + \
           [c for c in ranked if c in slow]
