"""Fleet-scale cohorts: thousands of logical clients behind ONE endpoint.

The paper's target deployments are edge fleets of 10^4-10^6 devices, but
one Python ``SDFLMQClient`` per participant tops out at a few hundred.  A
``CohortClient`` fronts N *logical* client ids over a single MQTT
connection, with memory-bounded per-member state:

  * **ParamBank** — a struct-of-arrays parameter bank: per tensor key one
    ``(N, *shape)`` array; logical client i IS row i.  No per-member param
    pytrees, no per-member Python objects beyond a row index.
  * **shared accumulator arenas** — aggregation duties held by fronted
    members reuse the same streaming flat-f64 ``_Accumulator`` machinery as
    individual clients, in one shared per-session dict (``_SessionCtx``).
  * **control-plane batching** — one ``cohort_session`` RPC joins all N
    ids, one ``cohort_ready`` reports the round, and the coordinator sends
    one ``role_assignment_batch`` per cohort instead of N messages.
  * **intra-cohort bypass** — a contribution whose target cluster head is
    fronted by the same cohort is ingested by a direct call (the exact
    ``_on_cluster_input`` handler the broker would invoke), skipping frame
    encode/route/decode; only cross-cohort partials and the retained
    global publish touch the broker.

Bit-identity: a federation fronted by one cohort replays the exact
per-accumulator float64 operation order of N individual clients (members
ingest in global sorted order with the same depth-first flush cascade), so
the final global is bit-identical — property-tested for fedavg / fedprox /
trimmed_mean at cohort sizes {1, 7, 64}.  With several cohorts whose
members share a cluster, the pre-aggregated cross-cohort partial changes
the f64 association order; results then agree to float tolerance instead.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core import topics as T
from repro_torch.core.client import (Params, SDFLMQClient, _Accumulator,
                               _SessionCtx)
from repro_torch.core.mqttfc import raw_handler
from repro_torch.core.roles import ClientAssignment, Duty
from repro_torch.core.stats import ClientStats


class ParamBank:
    """Struct-of-arrays per-member parameter storage.

    ``data[key]`` is one ``(N, *shape)`` C-contiguous array; logical
    member i owns row i.  Row views are C-contiguous slices, so numpy
    reductions over a row are bit-identical to the same reduction over a
    standalone copy of that row (same pairwise-summation layout).
    """

    def __init__(self, member_ids: list, template: Params):
        self.ids: list[str] = sorted(member_ids)
        self.index: dict[str, int] = {c: i for i, c in enumerate(self.ids)}
        self.n = len(self.ids)
        # explicit allocate-and-fill: ascontiguousarray of a broadcast view
        # can hand back the read-only view itself when n == 1
        self.data: dict[str, np.ndarray] = {}
        for k, v in template.items():
            v = np.asarray(v)
            arr = np.empty((self.n,) + v.shape, v.dtype)
            arr[...] = v
            self.data[k] = arr
        self.weights = np.ones(self.n, np.float64)

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.data.values()) + self.weights.nbytes

    def row(self, member_id: str) -> Params:
        """Member's params as views into the bank (zero copy)."""
        i = self.index[member_id]
        return {k: v[i] for k, v in self.data.items()}

    def set_row(self, member_id: str, params: Params,
                weight: Optional[float] = None) -> None:
        i = self.index[member_id]
        for k, v in params.items():
            self.data[k][i] = v
        if weight is not None:
            self.weights[i] = float(weight)

    def weight(self, member_id: str) -> float:
        return float(self.weights[self.index[member_id]])

    def broadcast(self, params: Params) -> None:
        """Load a new global into every row (round start)."""
        for k, v in params.items():
            self.data[k][:] = np.asarray(v)[None]


class CohortArbiter:
    """Role arbiter over N fronted members: per-member assignments, one
    merged duty index (cluster ids are unique per head, so duties never
    collide), and the cohort connection's subscription set as the union of
    every member's duty topics."""

    def __init__(self, cohort_id: str):
        self.client_id = cohort_id
        self.members: dict[str, ClientAssignment] = {}
        self._duties: dict[str, Duty] = {}          # cluster_id -> duty
        self.subscribed_topics: list[str] = []
        self.role_changes = 0
        self.assignment = None      # base-class surface (unused by cohorts)

    @property
    def is_aggregator(self) -> bool:
        return bool(self._duties)

    def duty_for(self, cluster_id: str) -> Optional[Duty]:
        return self._duties.get(cluster_id)

    def train_cluster_of(self, member_id: str) -> Optional[str]:
        asg = self.members.get(member_id)
        return asg.train_cluster if asg is not None else None

    def apply_batch(self, assignments: list[dict]) -> tuple[list[str], list[str]]:
        """Fold a ``role_assignment_batch`` in; returns the subscription
        delta (to_unsubscribe, to_subscribe) for the shared connection."""
        for d in assignments:
            asg = ClientAssignment.from_dict(d)
            self.members[asg.client_id] = asg
            self.role_changes += 1
        return self._rebuild()

    def remove_members(self, member_ids) -> tuple[list[str], list[str]]:
        for cid in member_ids:
            self.members.pop(cid, None)
        return self._rebuild()

    def _rebuild(self) -> tuple[list[str], list[str]]:
        self._duties = {}
        new_topics = set()
        for asg in self.members.values():
            sid = (asg.duties[0].cluster_id if asg.duties
                   else asg.train_cluster or "").split(":")[0]
            for d in asg.duties:
                self._duties[d.cluster_id] = d
                new_topics.add(T.cluster_agg(sid, d.cluster_id))
        old_topics = set(self.subscribed_topics)
        self.subscribed_topics = sorted(new_topics)
        return sorted(old_topics - new_topics), sorted(new_topics - old_topics)


class CohortClient(SDFLMQClient):
    """One endpoint fronting N logical client ids (fleet-scale mode).

    The aggregation service, strategy hooks, defense plumbing, and global
    handling are inherited unchanged from ``SDFLMQClient`` — a cohort IS a
    client whose arbiter merges N members' duties and whose local-training
    state lives in a ``ParamBank`` instead of one pytree.
    """

    def __init__(self, cohort_id: str, broker, member_ids: list,
                 wire_format: str = "tb",
                 stats: Optional[ClientStats] = None):
        super().__init__(cohort_id, broker, preferred_role="trainer",
                         stats=stats or ClientStats(cohort_id),
                         wire_format=wire_format)
        self.member_ids: list[str] = sorted(str(m) for m in member_ids)
        self.active: set[str] = set(self.member_ids)
        self.arbiter = CohortArbiter(cohort_id)     # replaces RoleArbiter
        self.banks: dict[str, ParamBank] = {}       # session -> bank
        self.joined: dict[str, list] = {}           # session -> accepted ids
        # cross-cohort uplink arenas: one accumulator per remote-headed
        # cluster, pre-aggregating our members' contributions into a single
        # covers=k partial (buffers reused across rounds)
        self._uplink: dict[tuple, _Accumulator] = {}
        self.bypassed_messages = 0      # intra-cohort deliveries kept local
        self.uplink_partials = 0        # cross-cohort batched publishes

    # ------------------------------------------------------------------
    # Control plane
    # ------------------------------------------------------------------
    def join_fleet_session(self, session_id: str, model_name: str,
                           fl_rounds: int = 0, capacity_min: int = 0,
                           capacity_max: int = 0,
                           session_time_s: float = 3600.0,
                           waiting_time_s: float = 120.0,
                           strategy: str = "fedavg") -> None:
        """Create-or-join ``session_id`` with every fronted member in ONE
        RPC (the coordinator's ``cohort_session`` endpoint)."""
        from repro_torch.api.strategies import get_strategy
        strategy = get_strategy(strategy).name      # fail fast, canonical
        ctx = self.models.ensure(session_id, model_name)
        ctx.strategy = strategy
        self._subscribe_session(session_id)
        self.fc.call(T.coord("cohort_session"), session_id, self.client_id,
                     sorted(self.active), model_name, fl_rounds,
                     capacity_min, capacity_max, session_time_s,
                     waiting_time_s, preferred_role="trainer",
                     strategy=strategy)

    def _on_ctrl(self, payload: dict) -> None:
        ev = payload.get("event")
        if ev == "role_assignment_batch":
            self._apply_assignments(payload["assignments"])
        elif ev == "role_assignment":
            # an individually-routed member assignment (elastic paths)
            self._apply_assignments([payload["assignment"]])
        elif ev == "cohort_joined":
            sid = payload["session"]["session_id"]
            self.joined[sid] = list(payload.get("accepted", []))

    def _apply_assignments(self, assignments: list[dict]) -> None:
        to_unsub, to_sub = self.arbiter.apply_batch(assignments)
        for t in to_unsub:
            self.fc.unbind(t)
        for t in to_sub:
            self.fc.subscribe_raw(t, raw_handler(self._on_cluster_input))

    def signal_ready_all(self, session_id: str) -> None:
        """One batched readiness report for every active member."""
        ctx = self.models.sessions.get(session_id)
        self.fc.call(T.coord("cohort_ready"), session_id, self.client_id,
                     sorted(self.active),
                     round_idx=ctx.round_idx if ctx else None)

    def drop_members(self, session_id: str, member_ids) -> None:
        """Member-level churn: the named logical ids leave the session (one
        batched RPC, one coordinator rearrangement)."""
        gone = [m for m in member_ids if m in self.active]
        if not gone:
            return
        self.active.difference_update(gone)
        self.arbiter.remove_members(gone)
        self.fc.call(T.coord("cohort_leave"), session_id, self.client_id,
                     gone)

    # ------------------------------------------------------------------
    # Data plane
    # ------------------------------------------------------------------
    def set_bank(self, session_id: str, template: Params) -> ParamBank:
        """Allocate the session's struct-of-arrays bank from a per-member
        parameter template (all members start identical)."""
        bank = ParamBank(sorted(self.active), template)
        self.banks[session_id] = bank
        return bank

    def bank(self, session_id: str) -> ParamBank:
        return self.banks[session_id]

    def train_members(self, session_id: str,
                      fn: Callable[[str, Params], tuple[Params, float]],
                      from_global: bool = True) -> None:
        """Per-member training pass: ``fn(member_id, start_params) ->
        (new_params, weight)`` in sorted member order.  ``from_global``
        starts every member from the current global (standard FedAvg);
        otherwise from the member's own bank row (personalization)."""
        ctx = self.models.get(session_id)
        bank = self.banks[session_id]
        base = ctx.params if (from_global and ctx.params is not None) else None
        for cid in sorted(self.active):
            if cid not in bank.index:
                continue
            start = ({k: np.array(v) for k, v in base.items()}
                     if base is not None else
                     {k: np.array(v) for k, v in bank.row(cid).items()})
            new_params, w = fn(cid, start)
            bank.set_row(cid, new_params, w)

    def train_vectorized(self, session_id: str,
                         fn: Callable[[dict, np.ndarray, Optional[Params]],
                                      tuple[dict, np.ndarray]]) -> None:
        """Vectorized training pass over the whole bank: ``fn(data,
        weights, global_params) -> (data, weights)`` where every ``data``
        leaf is member-stacked ``(N, *shape)`` — the numpy twin of the
        compiled ``build_cohort_local_step`` vmap path."""
        ctx = self.models.get(session_id)
        bank = self.banks[session_id]
        data, weights = fn(bank.data, bank.weights, ctx.params)
        for k, v in data.items():
            if v is not bank.data[k]:
                bank.data[k][...] = v
        if weights is not bank.weights:
            bank.weights[...] = weights

    def run_local_round(self, session_id: str) -> None:
        """Publish every trained member row for aggregation, replaying the
        exact schedule N individual clients would produce: members ingest
        in global sorted order; a cluster headed by this cohort aggregates
        locally (direct handler call, depth-first flush cascade); a
        remote-headed cluster receives ONE pre-aggregated ``covers=k``
        partial at the position its last local member would have published.
        """
        ctx = self.models.get(session_id)
        if ctx.async_cfg is not None:
            raise RuntimeError("cohorts support synchronous sessions only")
        bank = self.banks[session_id]
        strat = self._strategy_for(ctx)
        members = [c for c in sorted(self.active)
                   if c in bank.index
                   and self.arbiter.train_cluster_of(c) is not None]
        # per remote-headed cluster: how many of our members remain before
        # the batched partial is complete and can be published
        remaining: dict[str, int] = {}
        for cid in members:
            cl = self.arbiter.train_cluster_of(cid)
            if self.arbiter.duty_for(cl) is None:
                remaining[cl] = remaining.get(cl, 0) + 1
        for cid in members:
            cluster = self.arbiter.train_cluster_of(cid)
            w = bank.weight(cid)
            if self.arbiter.duty_for(cluster) is not None:
                # head fronted by this cohort: direct ingest through the
                # real handler (defense, premap, flush — everything applies)
                body = {"params": bank.row(cid), "weight": w,
                        "sender": cid, "partial": False,
                        "round": ctx.round_idx}
                self.bypassed_messages += 1
                self._on_cluster_input(
                    T.cluster_agg(session_id, cluster), {"a": [body]})
            else:
                self._uplink_add(session_id, ctx, strat, cluster, cid, w,
                                 bank)
                remaining[cluster] -= 1
                if remaining[cluster] == 0:
                    self._uplink_publish(session_id, ctx, strat, cluster)

    # -- cross-cohort uplink: pre-aggregated covers=k partials ----------
    def _uplink_add(self, session_id: str, ctx: _SessionCtx, strat,
                    cluster: str, member_id: str, w: float,
                    bank: ParamBank) -> None:
        a = self._uplink.setdefault((session_id, cluster), _Accumulator())
        if a.flushed:
            a.restart()
        contrib: Params = bank.row(member_id)
        if not self._premap_is_identity(strat):
            # same premap, applied exactly once per leaf — the receiving
            # head treats the batch as already-premapped partial rows
            contrib = strat.premap(contrib, ctx.global_params, np)
        if strat.reduction == "stack":
            a.add_stack_row(contrib, w, expected_rows=1)
        else:
            a.add_sum(contrib, w)
        a.weight += w
        a.received += 1

    def _uplink_publish(self, session_id: str, ctx: _SessionCtx, strat,
                        cluster: str) -> None:
        a = self._uplink[(session_id, cluster)]
        if a.received == 0:
            return
        legacy_wire = self.fc.wire_format == "legacy"
        if strat.reduction == "stack":
            if legacy_wire:
                sv = a.stacked_views()
                payload = {"entries": [
                    {"params": {k: sv[k][i] for k in sv},
                     "weight": a.row_weights[i]} for i in range(a.n_rows)],
                    "weight": a.weight, "sender": self.client_id,
                    "partial": True, "covers": a.n_rows,
                    "round": ctx.round_idx}
            else:
                payload = {"stack": a.stack_slice(),
                           "weights": list(a.row_weights),
                           "weight": a.weight, "sender": self.client_id,
                           "partial": True, "covers": a.n_rows,
                           "round": ctx.round_idx}
        else:
            partial = (dict(a.acc_views()) if legacy_wire
                       else a.partial_bundle())
            payload = {"params": partial, "weight": a.weight,
                       "sender": self.client_id, "partial": True,
                       "covers": a.received, "round": ctx.round_idx}
        self.uplink_partials += 1
        self.fc.call(T.cluster_agg(session_id, cluster), payload)
        a.restart()
        a.flushed = True

    # -- intra-cohort bypass for the flush cascade ----------------------
    def _send_cluster(self, session_id: str, cluster_id: str,
                      payload: dict) -> None:
        if self.arbiter.duty_for(cluster_id) is not None:
            # parent head fronted by this cohort too: skip the broker
            self.bypassed_messages += 1
            self._on_cluster_input(
                T.cluster_agg(session_id, cluster_id), {"a": [payload]})
        else:
            self.fc.call(T.cluster_agg(session_id, cluster_id), payload)

    # cohorts never use the single-client training surface
    def send_local(self, session_id: str) -> None:  # pragma: no cover
        raise RuntimeError("CohortClient trains through run_local_round()")
