"""FL roles and the client-side Role Arbiter (paper §III-C).

A client may hold several duties at once (paper Fig. 5b: A/T5 heads a leaf
cluster AND the root): it trains into exactly one leaf cluster and may
aggregate any number of clusters at different levels.  The arbiter owns the
mapping between duties and MQTT subscriptions: a role change is exactly the
subscription delta — nobody else is touched (the paper's key property).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class Role(str, enum.Enum):
    TRAINER = "trainer"
    AGGREGATOR = "aggregator"
    TRAINER_AGGREGATOR = "trainer_aggregator"


@dataclass
class Duty:
    """One aggregation duty: collect ``expected`` inputs for ``cluster_id``
    and forward the weighted partial sum to ``parent`` (None = root)."""
    cluster_id: str
    expected: int
    parent: Optional[str]
    level: int

    def to_dict(self) -> dict:
        return {"cluster_id": self.cluster_id, "expected": self.expected,
                "parent": self.parent, "level": self.level}

    @staticmethod
    def from_dict(d: dict) -> "Duty":
        return Duty(d["cluster_id"], d["expected"], d["parent"], d["level"])


@dataclass
class ClientAssignment:
    client_id: str
    train_cluster: Optional[str]           # leaf cluster to publish into
    duties: list[Duty] = field(default_factory=list)

    @property
    def role(self) -> Role:
        if self.duties and self.train_cluster:
            return Role.TRAINER_AGGREGATOR
        if self.duties:
            return Role.AGGREGATOR
        return Role.TRAINER

    def to_dict(self) -> dict:
        return {"client_id": self.client_id, "train_cluster": self.train_cluster,
                "duties": [d.to_dict() for d in self.duties]}

    @staticmethod
    def from_dict(d: dict) -> "ClientAssignment":
        return ClientAssignment(d["client_id"], d["train_cluster"],
                                [Duty.from_dict(x) for x in d["duties"]])


@dataclass
class RoleArbiter:
    client_id: str
    assignment: Optional[ClientAssignment] = None
    subscribed_topics: list[str] = field(default_factory=list)
    role_changes: int = 0

    @property
    def is_aggregator(self) -> bool:
        return self.assignment is not None and bool(self.assignment.duties)

    @property
    def is_trainer(self) -> bool:
        return self.assignment is None or self.assignment.train_cluster is not None

    def duty_for(self, cluster_id: str) -> Optional[Duty]:
        if self.assignment is None:
            return None
        for d in self.assignment.duties:
            if d.cluster_id == cluster_id:
                return d
        return None

    def update(self, new: ClientAssignment) -> tuple[list[str], list[str]]:
        """Returns (topics_to_unsubscribe, topics_to_subscribe): only the
        delta against the current subscriptions (paper §III-E5, Fig. 6)."""
        from repro_torch.core import topics as T
        sid = (new.duties[0].cluster_id if new.duties
               else new.train_cluster or "").split(":")[0]
        old_topics = set(self.subscribed_topics)
        new_topics = {T.cluster_agg(sid, d.cluster_id) for d in new.duties}
        to_unsub = sorted(old_topics - new_topics)
        to_sub = sorted(new_topics - old_topics)
        if self.assignment is None or self.assignment.to_dict() != new.to_dict():
            self.role_changes += 1
        self.assignment = new
        self.subscribed_topics = sorted(new_topics)
        return to_unsub, to_sub
