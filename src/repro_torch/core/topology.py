"""Topology compiler: ClusterTree (control plane) -> collective schedule
(data plane).

The coordinator's cluster tree is compiled into per-level
``axis_index_groups`` over the FL client mesh axis.  Level-0 groups are the
leaf clusters; at level l>0 only the previous level's heads contribute
(everyone else is masked to zero), so each psum level reproduces exactly
the paper's hierarchical aggregation — and the lowered HLO shows one
(grouped) all-reduce per level instead of one global all-reduce.

Because ``axis_index_groups`` must partition the axis, clients that do not
participate at a level are assigned to the group of their level-0 head and
contribute zeros.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.clustering import ClusterTree


@dataclass(frozen=True)
class AggSchedule:
    """Static description of one aggregation schedule (hashable: usable as
    a compiled-step cache key)."""
    kind: str                                   # tree | flat | rs_ag | compressed
    n_clients: int
    level_groups: tuple = ()                    # per level: tuple of tuples
    head_masks: tuple = ()                      # per level>0: tuple of 0/1

    def signature(self) -> str:
        return f"{self.kind}/{self.n_clients}/{hash((self.level_groups, self.head_masks)) & 0xffffffff:x}"


def _groups_partition(assign: dict[int, int], n: int) -> tuple:
    """Client-index -> group-id mapping into sorted tuple-of-tuples."""
    groups: dict[int, list[int]] = {}
    for idx in range(n):
        groups.setdefault(assign[idx], []).append(idx)
    return tuple(tuple(g) for _, g in sorted(groups.items()))


def compile_tree(tree: ClusterTree, kind: str = "tree",
                 axis_size: int = 0, index_of: dict | None = None) -> AggSchedule:
    """Map a cluster tree onto mesh-axis collective groups.

    ``index_of`` maps client id -> mesh-axis index (default: enumeration
    order); ``axis_size`` >= #clients pads the groups with dead/vacant rows
    (they ride in group 0 at every level — the FL round step gives them
    zero weight, so sums are unaffected, but axis_index_groups must
    partition the full axis)."""
    if index_of is None:
        index_of = {cid: i for i, cid in enumerate(tree.client_order)}
    order = index_of
    n = max(axis_size, len(tree.client_order),
            max(order.values(), default=-1) + 1)
    if kind != "tree":
        return AggSchedule(kind, n)

    level_groups = []
    head_masks = []
    # level 0: leaf clusters partition everyone; vacant rows ride in group 0
    leaf_of = {i: 0 for i in range(n)}
    for gi, c in enumerate(tree.levels[0]):
        for m in c.members:
            leaf_of[order[m]] = gi
    level_groups.append(_groups_partition(leaf_of, n))

    # parent chain: every client -> head of the cluster it feeds into
    # (a multi-level head keeps the highest-level parent; walks stop as soon
    # as the current node participates at the target level)
    parent: dict[int, int] = {}
    for lvl_clusters in tree.levels:
        for c in lvl_clusters:
            for m in c.members:
                if order[m] != order[c.head]:
                    parent[order[m]] = order[c.head]

    # higher levels: heads of the previous level carry partial sums;
    # everyone else rides along in its head's group with zero contribution
    for lvl in range(1, len(tree.levels)):
        head_to_gid = {}
        for gi, c in enumerate(tree.levels[lvl]):
            for m in c.members:
                head_to_gid[order[m]] = gi
        mask = tuple(1 if idx in head_to_gid else 0 for idx in range(n))

        def gid_for(idx: int) -> int:
            cur = idx
            for _ in range(n + 1):
                if cur in head_to_gid:
                    return head_to_gid[cur]
                nxt = parent.get(cur, cur)
                if nxt == cur:
                    return 0
                cur = nxt
            return 0

        assign = {idx: gid_for(idx) for idx in range(n)}
        level_groups.append(_groups_partition(assign, n))
        head_masks.append(mask)

    return AggSchedule("tree", n, tuple(level_groups), tuple(head_masks))


def flat_schedule(n_clients: int) -> AggSchedule:
    """Centralized baseline: one global all-reduce."""
    return AggSchedule("flat", n_clients)


def validate_schedule(s: AggSchedule) -> list[str]:
    errs = []
    for lvl, groups in enumerate(s.level_groups):
        flat = sorted(i for g in groups for i in g)
        if flat != list(range(s.n_clients)):
            errs.append(f"level {lvl} groups do not partition the axis")
    for mask in s.head_masks:
        if len(mask) != s.n_clients:
            errs.append("mask length mismatch")
    return errs
