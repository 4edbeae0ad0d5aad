"""Clustering engine (paper §III-E2): hierarchical cluster construction.

The coordinator first selects aggregators (cluster heads) via the role-
optimization policy, then attaches trainers to heads level by level:
level 0 clusters hold trainers under a head; higher levels cluster the
heads themselves, up to a single root aggregator.  ``aggregator_ratio``
(paper Fig. 8 uses 30%) and ``levels`` control the shape; ``levels=1``
with one head is the centralized baseline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.roles import ClientAssignment, Duty
from repro_torch.core.stats import ClientStats


@dataclass
class Cluster:
    cluster_id: str                 # "<sid>:L<level>C<idx>"
    level: int
    head: str                       # aggregator client id
    members: list[str]              # clients publishing INTO this cluster
    parent: str | None = None       # cluster the head publishes to


@dataclass
class ClusterTree:
    session_id: str
    levels: list[list[Cluster]]     # levels[0] = leaf clusters
    client_order: list[str]         # stable participant ordering

    @property
    def root(self) -> Cluster:
        return self.levels[-1][0]

    def all_clusters(self) -> list[Cluster]:
        return [c for lvl in self.levels for c in lvl]

    def heads_at(self, level: int) -> list[str]:
        return [c.head for c in self.levels[level]]

    def assignments(self) -> dict[str, ClientAssignment]:
        """Per-client assignment: one leaf train-cluster + every aggregation
        duty the client heads (a client may head clusters at several levels,
        paper Fig. 5b)."""
        leaf_of = {}
        for c in self.levels[0]:
            for m in c.members:
                leaf_of[m] = c.cluster_id
        out = {cid: ClientAssignment(cid, leaf_of.get(cid))
               for cid in self.client_order}
        for c in self.all_clusters():
            out[c.head].duties.append(
                Duty(c.cluster_id, len(c.members), c.parent, c.level))
        for a in out.values():
            a.duties.sort(key=lambda d: d.level)
        return out

    def describe(self) -> dict:
        return {
            "session_id": self.session_id,
            "levels": [[{"id": c.cluster_id, "head": c.head,
                         "members": c.members, "parent": c.parent}
                        for c in lvl] for lvl in self.levels],
            "client_order": self.client_order,
        }

    @staticmethod
    def from_describe(d: dict) -> "ClusterTree":
        levels = [[Cluster(c["id"], li, c["head"], list(c["members"]),
                           c["parent"]) for c in lvl]
                  for li, lvl in enumerate(d["levels"])]
        return ClusterTree(d["session_id"], levels, list(d["client_order"]))


def _chunks(xs: list, n_groups: int) -> list[list]:
    """Split xs into n_groups contiguous, near-equal chunks."""
    n_groups = max(1, min(n_groups, len(xs)))
    size = math.ceil(len(xs) / n_groups)
    return [xs[i * size:(i + 1) * size] for i in range(n_groups)
            if xs[i * size:(i + 1) * size]]


def build_tree(session_id: str, clients: list[str], ranked_aggregators: list[str],
               aggregator_ratio: float = 0.3, levels: int = 3) -> ClusterTree:
    """clients: all participants; ranked_aggregators: aggregator candidates
    best-first (from the role optimizer).  levels counts aggregation levels
    including the root (paper's 3-layer = root + intermediates + trainers).
    """
    n = len(clients)
    assert n >= 1
    if levels <= 1 or n <= 2:
        head = ranked_aggregators[0]
        c = Cluster(f"{session_id}:L0C0", 0, head, list(clients))
        return ClusterTree(session_id, [[c]], list(clients))

    n_mid = max(1, min(int(round(n * aggregator_ratio)), n))
    heads0 = ranked_aggregators[:n_mid]
    # leaf level: each head anchors its own cluster (a head MUST be a member
    # of the cluster it aggregates — required by both the self-delivering
    # MQTT path and the collective mapping), trainers are spread across them
    head_set = set(heads0)                  # O(1) lookup at fleet scale
    rest = [c for c in clients if c not in head_set]
    shares = _chunks(rest, n_mid) if rest else []
    leaf = []
    for i, h in enumerate(heads0):
        members = [h] + (shares[i] if i < len(shares) else [])
        leaf.append(Cluster(f"{session_id}:L0C{i}", 0, h, members))
    tree_levels = [leaf]
    # intermediate levels cluster the heads of the previous level
    prev_heads = [c.head for c in leaf]
    lvl = 1
    while lvl < levels - 1 and len(prev_heads) > 2:
        n_h = max(1, len(prev_heads) // 3)
        hgroups = _chunks(prev_heads, n_h)
        cur = [Cluster(f"{session_id}:L{lvl}C{i}", lvl, grp[0], grp)
               for i, grp in enumerate(hgroups)]
        tree_levels.append(cur)
        prev_heads = [c.head for c in cur]
        lvl += 1
    # root
    root = Cluster(f"{session_id}:L{lvl}C0", lvl, prev_heads[0], prev_heads)
    tree_levels.append(root if isinstance(root, list) else [root])
    # wire parents
    for li in range(len(tree_levels) - 1):
        head_to_parent = {}
        for c in tree_levels[li + 1]:
            for m in c.members:
                head_to_parent[m] = c.cluster_id
        for c in tree_levels[li]:
            c.parent = head_to_parent.get(c.head)
    return ClusterTree(session_id, tree_levels, list(clients))


def validate_tree(tree: ClusterTree, clients: list[str]) -> list[str]:
    """Invariant checks (also used by hypothesis property tests).
    Returns list of violations (empty = valid)."""
    errs = []
    leaf_members = [m for c in tree.levels[0] for m in c.members]
    if sorted(leaf_members) != sorted(clients):
        errs.append("leaf clusters must partition the client set")
    if len(set(leaf_members)) != len(leaf_members):
        errs.append("client appears in more than one leaf cluster")
    for li in range(len(tree.levels) - 1):
        prev_heads = sorted(c.head for c in tree.levels[li])
        members = sorted(m for c in tree.levels[li + 1] for m in c.members)
        if prev_heads != members:
            errs.append(f"level {li + 1} members must equal level {li} heads")
    if len(tree.levels[-1]) != 1:
        errs.append("top level must be a single root cluster")
    for c in tree.all_clusters():
        if c.head not in c.members:
            errs.append(f"head {c.head} not in members of {c.cluster_id}")
    return errs
