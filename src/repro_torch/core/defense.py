"""Self-defending control plane: defense configuration + reputation book.

The SDFL pitch — *any* edge node can take aggregation duty — cuts both
ways: any compromised node can poison a cluster's partial or squat on a
head role.  This module holds the control-plane side of the defense:

* :class:`DefenseConfig` — the knobs, serialized onto the wire exactly
  like the async config (``create_session`` carries it; the retained
  topology broadcast re-distributes it plus the live reputation map, so
  every aggregator — including late joiners — screens with the same
  rules).
* :class:`ReputationBook` — per-client trust scores in ``[0, 1]`` kept by
  the coordinator.  Update-norm outliers, heartbeat misses, and staleness
  *penalize*; clean completed rounds *heal*.  Scores feed three places:
  aggregators scale a sender's combine weight by its reputation (and
  reject below ``reject_below``), the volunteer boost in aggregator
  ranking excludes clients below ``demote_below``, and the
  ``reputation_aware`` role policy rotates head duty across the trusted
  set (fedstellar-style moving-target defense) so a poisoned head cannot
  own a cluster indefinitely.

The coordinator never touches model tensors — norm screening happens at
the aggregators (core/client.py), which report outliers back over
``sdflmq/coord/defense_report`` metadata only, keeping the paper's
coordinator-sees-no-models property intact.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass
class DefenseConfig:
    """Knobs for the self-defending control plane (all virtual-time)."""
    # -- heartbeat liveness -------------------------------------------------
    heartbeat_period_s: float = 1.0     # per-client heartbeat cadence
    liveness_misses: int = 3            # missed beats before a penalty
    # -- update-norm outlier gate (at aggregators) --------------------------
    norm_gate_mult: float = 4.0         # reject when norm/weight > mult*EWMA
    norm_warmup: int = 3                # observations before the gate arms
    norm_alpha: float = 0.3             # EWMA step for the norm baseline
    # -- reputation dynamics ------------------------------------------------
    outlier_penalty: float = 0.3        # norm-gate rejection
    miss_penalty: float = 0.2           # heartbeat-liveness miss
    stale_penalty: float = 0.05         # repeated stale contributions
    heal_rate: float = 0.05             # per clean completed round
    reject_below: float = 0.2           # drop the sender's updates entirely
    demote_below: float = 0.5           # no aggregator duty below this

    def to_wire(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_wire(d: "DefenseConfig | dict | bool | None"):
        if d is None or d is False:
            return None
        if isinstance(d, DefenseConfig):
            return d
        if d is True:
            return DefenseConfig()
        known = {f for f in DefenseConfig.__dataclass_fields__}
        return DefenseConfig(**{k: v for k, v in dict(d).items()
                                if k in known})


class ReputationBook:
    """Per-client trust scores in ``[0, 1]``; every client starts at 1.0."""

    def __init__(self, cfg: DefenseConfig):
        self.cfg = cfg
        self.scores: dict[str, float] = {}
        self.penalties = 0
        self.heals = 0

    def score(self, client_id: str) -> float:
        return self.scores.get(client_id, 1.0)

    def penalize(self, client_id: str, amount: float) -> float:
        s = max(0.0, self.score(client_id) - amount)
        self.scores[client_id] = s
        self.penalties += 1
        return s

    def heal(self, client_id: str) -> float:
        s = min(1.0, self.score(client_id) + self.cfg.heal_rate)
        self.scores[client_id] = s
        self.heals += 1
        return s

    def quarantined(self, client_id: str) -> bool:
        return self.score(client_id) < self.cfg.demote_below

    def snapshot(self) -> dict[str, float]:
        """Wire-ready map (only clients that ever diverged from 1.0)."""
        return {c: round(s, 6) for c, s in self.scores.items()}
