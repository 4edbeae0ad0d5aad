"""FL session state machine (paper §III-E1, Fig. 4).

Lifecycle: CREATED -> WAITING (for contributors) -> CLUSTERING -> RUNNING
(round loop) -> TERMINATED (round budget or wall-clock expiry).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.stats import ClientStats


class SessionState(str, enum.Enum):
    CREATED = "created"
    WAITING = "waiting"
    CLUSTERING = "clustering"
    RUNNING = "running"
    TERMINATED = "terminated"


@dataclass
class FLSession:
    session_id: str
    model_name: str
    creator: str
    fl_rounds: int
    capacity_min: int
    capacity_max: int
    session_time_s: float = 3600.0
    waiting_time_s: float = 120.0
    strategy: str = "fedavg"           # aggregation strategy (repro_torch.api)
    state: SessionState = SessionState.CREATED
    round_idx: int = 0
    contributors: dict[str, ClientStats] = field(default_factory=dict)
    preferred_roles: dict[str, str] = field(default_factory=dict)
    ready: set = field(default_factory=set)
    created_at: float = 0.0            # SimClock stamp at creation
    round_started_at: float = 0.0      # SimClock stamp of the current round
    round_deadline_s: float = 0.0      # straggler deadline (0 = none)
    async_cfg: Optional[dict] = None   # async admission rules (None = sync)
    defense_cfg: Optional[dict] = None  # adversarial defense knobs (None = off)
    history: list[dict] = field(default_factory=list)

    def join(self, client_id: str, stats: ClientStats,
             preferred_role: str = "trainer") -> bool:
        if self.state not in (SessionState.CREATED, SessionState.WAITING,
                              SessionState.RUNNING):
            return False   # elastic join mid-session is allowed (RUNNING)
        if len(self.contributors) >= self.capacity_max:
            return False
        self.contributors[client_id] = stats
        self.preferred_roles[client_id] = preferred_role
        if self.state != SessionState.RUNNING:
            self.state = SessionState.WAITING
        return True

    def leave(self, client_id: str) -> None:
        self.contributors.pop(client_id, None)
        self.preferred_roles.pop(client_id, None)
        self.ready.discard(client_id)

    @property
    def full(self) -> bool:
        return len(self.contributors) >= self.capacity_max

    @property
    def quorum(self) -> bool:
        return len(self.contributors) >= self.capacity_min

    def mark_ready(self, client_id: str, stats: Optional[ClientStats] = None) -> None:
        if client_id in self.contributors:
            self.ready.add(client_id)
            if stats is not None:
                self.contributors[client_id] = stats

    @property
    def all_ready(self) -> bool:
        # mark_ready keeps ready ⊆ contributors, so a length check short-
        # circuits the O(n) set build on every non-final readiness ping
        if len(self.ready) < len(self.contributors):
            return False
        return self.ready >= set(self.contributors)

    def next_round(self) -> None:
        self.history.append({"round": self.round_idx,
                             "participants": sorted(self.ready)})
        self.round_idx += 1
        self.ready.clear()
        if self.round_idx >= self.fl_rounds:
            self.state = SessionState.TERMINATED

    def describe(self) -> dict:
        return {
            "session_id": self.session_id, "model_name": self.model_name,
            "state": self.state.value, "round": self.round_idx,
            "fl_rounds": self.fl_rounds, "strategy": self.strategy,
            "async": self.async_cfg,
            "contributors": sorted(self.contributors),
        }
