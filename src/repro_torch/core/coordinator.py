"""Coordinator logic (paper §III-D/E): session management, clustering
engine, role (re)arrangement, role optimization, failure detection.

The coordinator never touches model tensors — it only consumes metadata
(client stats, readiness) and emits routing/placement metadata (role
assignments, cluster topology), exactly as in the paper.  Role
*rearrangement* messages go only to clients whose assignment changed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core import topics as T
from repro_torch.core.clustering import ClusterTree, build_tree, validate_tree
from repro_torch.core.defense import DefenseConfig, ReputationBook
from repro_torch.core.mqttfc import MQTTFC
from repro_torch.core.role_optimizer import get_policy
from repro_torch.core.roles import ClientAssignment
from repro_torch.core.session import FLSession, SessionState
from repro_torch.core.stats import ClientStats


@dataclass
class CoordinatorConfig:
    role_policy: str = "memory_aware"
    aggregator_ratio: float = 0.3
    levels: int = 3
    round_deadline_s: float = 0.0
    # virtual seconds between per-level flush broadcasts on a deadline cut,
    # so level-l partials cross the (delayed) links before level-l+1 heads
    # see their own flush; 0 keeps the synchronous level-by-level pump
    flush_spacing_s: float = 0.0


class Coordinator:
    def __init__(self, broker, cfg: Optional[CoordinatorConfig] = None,
                 client_id: str = "coordinator", clock=None):
        # ``broker`` is any repro_torch.api.transport.Transport implementation;
        # ``clock`` (a repro_torch.api.transport.SimClock) arms waiting-time and
        # round-deadline timers on virtual time — without one, expiry stays
        # caller-driven (expire_waiting / force_round_end)
        self.cfg = cfg or CoordinatorConfig()
        self.clock = clock
        self.fc = MQTTFC(broker, client_id)
        self.sessions: dict[str, FLSession] = {}
        self.trees: dict[str, ClusterTree] = {}
        self.assignments: dict[str, dict[str, ClientAssignment]] = {}
        # wire-form assignment cache: avoids re-serializing 100k unchanged
        # assignments every rearrangement just to diff them
        self._assign_wire: dict[str, dict[str, dict]] = {}
        # cohort registry: one CohortClient endpoint fronts many logical
        # ids over a single connection — control traffic for a fronted id
        # routes to (and batches on) the cohort's own control topic
        self.cohort_members: dict[str, set[str]] = {}
        self._cohort_of: dict[str, str] = {}
        self.failed_clients: set[str] = set()
        self.on_round_complete: Optional[Callable] = None   # hook for driver
        self.rearrangement_messages = 0     # paper's "negligible cost" claim
        self.arrangement_messages = 0
        self.deadline_cuts = 0              # rounds ended by the deadline
        self.roles_rotations = 0            # aggregator-set changes (defense)
        self._pending_cut: dict[str, int] = {}   # sid -> round being cut
        # defense state: per-session reputation books + heartbeat bookkeeping
        self.books: dict[str, ReputationBook] = {}
        self._heartbeats: dict[str, dict[str, float]] = {}   # sid -> cid -> t
        # optional telemetry facade (repro_torch.obs.Telemetry); set by
        # Federation(metrics=...).  None = zero-overhead default.
        self.obs = None
        self._round_wall: dict[str, float] = {}  # sid -> perf_counter stamp
        # RFC bindings
        self.fc.bind(T.coord("create_session"), self._create_session)
        self.fc.bind(T.coord("join_session"), self._join_session)
        self.fc.bind(T.coord("leave_session"), self._leave_session)
        self.fc.bind(T.coord("client_ready"), self._client_ready)
        self.fc.bind(T.coord("cohort_session"), self._cohort_session)
        self.fc.bind(T.coord("cohort_ready"), self._cohort_ready)
        self.fc.bind(T.coord("cohort_leave"), self._cohort_leave)
        self.fc.bind(T.coord("heartbeat"), self._heartbeat)
        self.fc.bind(T.coord("defense_report"), self._defense_report)
        self.fc.subscribe_raw(f"{T.ROOT}/will/+", self._on_will_raw)

    # ------------------------------------------------------------------
    # RFC endpoints
    # ------------------------------------------------------------------
    def _create_session(self, session_id: str, model_name: str, creator: str,
                        fl_rounds: int, capacity_min: int, capacity_max: int,
                        session_time_s: float = 3600.0,
                        waiting_time_s: float = 120.0,
                        preferred_role: str = "aggregator",
                        stats: Optional[dict] = None,
                        strategy: str = "fedavg",
                        async_cfg: Optional[dict] = None,
                        defense_cfg: Optional[dict] = None) -> None:
        if session_id in self.sessions:
            # paper: first create wins; later requests are dumped
            return
        s = FLSession(session_id, model_name, creator, fl_rounds,
                      capacity_min, capacity_max, session_time_s,
                      waiting_time_s, strategy=strategy,
                      round_deadline_s=self.cfg.round_deadline_s,
                      async_cfg=dict(async_cfg) if async_cfg else None,
                      defense_cfg=dict(defense_cfg) if defense_cfg else None)
        self.sessions[session_id] = s
        if s.defense_cfg is not None:
            self.books[session_id] = ReputationBook(
                DefenseConfig.from_wire(s.defense_cfg))
            self._heartbeats[session_id] = {}
        if self.clock is not None:
            s.created_at = self.clock.now
            if 0 < waiting_time_s < float("inf"):
                self.clock.schedule(self.clock.now + waiting_time_s,
                                    lambda: self.expire_waiting(session_id),
                                    timer=True)
        st = ClientStats.from_dict(stats) if stats else ClientStats(creator)
        s.join(creator, st, preferred_role)
        self._note_alive(session_id, creator)
        self._notify(creator, {"event": "session_created",
                               "session": s.describe()})
        self._maybe_start(session_id)

    def _join_session(self, session_id: str, client_id: str, model_name: str,
                      fl_rounds: int = 0, preferred_role: str = "trainer",
                      stats: Optional[dict] = None) -> None:
        s = self.sessions.get(session_id)
        if s is None or s.model_name != model_name:
            self._notify(client_id, {"event": "join_rejected",
                                     "session_id": session_id})
            return
        st = ClientStats.from_dict(stats) if stats else ClientStats(client_id)
        ok = s.join(client_id, st, preferred_role)
        if ok:
            self._note_alive(session_id, client_id)
        self._notify(client_id, {"event": "joined" if ok else "join_rejected",
                                 "session": s.describe()})
        if ok and s.state == SessionState.RUNNING:
            self._arrange(session_id, rearrange=True)   # elastic join
        else:
            self._maybe_start(session_id)

    def _leave_session(self, session_id: str, client_id: str) -> None:
        s = self.sessions.get(session_id)
        if s:
            s.leave(client_id)
            if s.state == SessionState.RUNNING:
                self._arrange(session_id, rearrange=True)

    def _client_ready(self, session_id: str, client_id: str,
                      stats: Optional[dict] = None,
                      metrics: Optional[dict] = None,
                      round_idx: Optional[int] = None) -> None:
        """Round-status update (paper §III-E4): client finished its role's
        work; carries fresh system stats for the optimizer.  ``round_idx``
        stamps which round the client reported for — a readiness signal
        held back by a partition (or riding a slow link) must not count
        toward a later round."""
        s = self.sessions.get(session_id)
        if s is None or s.state != SessionState.RUNNING:
            return
        if s.async_cfg is not None:
            return      # async sessions have no round barrier to report to
        if round_idx is not None and round_idx != s.round_idx:
            return                           # stale readiness: discard
        st = ClientStats.from_dict(stats) if stats else None
        first = not s.ready
        s.mark_ready(client_id, st)
        if first and s.ready:
            self._arm_deadline(session_id)
        if s.all_ready:
            if self.clock is not None:
                # everyone reported, but the aggregation cascade (partials
                # climbing the tree, the root's global publish) may still be
                # in flight on slower links — close the round only once the
                # delivery queue settles, so the new round's reset doesn't
                # orphan the old round's partials
                rnd = s.round_idx
                self.clock.call_when_idle(
                    lambda: self._finish_settled_round(session_id, rnd))
            else:
                self._finish_round(session_id)

    def _finish_settled_round(self, session_id: str, round_idx: int) -> None:
        s = self.sessions.get(session_id)
        if s is not None and s.state == SessionState.RUNNING \
                and s.round_idx == round_idx and s.all_ready:
            self._finish_round(session_id)

    # ------------------------------------------------------------------
    # Cohort endpoints: fleet-scale control-plane batching.  One
    # CohortClient connection fronts N logical ids; joins, readiness, and
    # leaves arrive as one message per cohort instead of one per device.
    # ------------------------------------------------------------------
    @staticmethod
    def _brief(s: FLSession) -> dict:
        """describe() without the contributor list — a fleet session's id
        roster is O(N) and cohorts already know their own members."""
        return {"session_id": s.session_id, "model_name": s.model_name,
                "state": s.state.value, "round": s.round_idx,
                "fl_rounds": s.fl_rounds, "strategy": s.strategy,
                "async": s.async_cfg,
                "n_contributors": len(s.contributors)}

    def _cohort_session(self, session_id: str, cohort_id: str,
                        client_ids: list, model_name: str,
                        fl_rounds: int = 0, capacity_min: int = 0,
                        capacity_max: int = 0,
                        session_time_s: float = 3600.0,
                        waiting_time_s: float = 120.0,
                        preferred_role: str = "trainer",
                        strategy: str = "fedavg",
                        stats_list: Optional[list] = None) -> None:
        """Create-or-join with a batch of logical ids.  The first cohort to
        name a session creates it (capacity from its parameters); every
        cohort's members join in one RPC.  One ack lands on the cohort's
        control topic."""
        ids = [str(c) for c in client_ids]
        mem = self.cohort_members.setdefault(cohort_id, set())
        for cid in ids:
            self._cohort_of[cid] = cohort_id    # route notifies BEFORE acks
        mem.update(ids)
        s = self.sessions.get(session_id)
        if s is None:
            if not ids:
                return
            s = FLSession(session_id, model_name, ids[0], fl_rounds,
                          capacity_min or len(ids),
                          capacity_max or len(ids),
                          session_time_s, waiting_time_s, strategy=strategy,
                          round_deadline_s=self.cfg.round_deadline_s)
            self.sessions[session_id] = s
            if self.clock is not None:
                s.created_at = self.clock.now
                if 0 < waiting_time_s < float("inf"):
                    self.clock.schedule(
                        self.clock.now + waiting_time_s,
                        lambda: self.expire_waiting(session_id), timer=True)
        elif s.model_name != model_name:
            self._notify(cohort_id, {"event": "join_rejected",
                                     "session_id": session_id})
            return
        accepted, rejected = [], []
        for i, cid in enumerate(ids):
            st = (ClientStats.from_dict(stats_list[i])
                  if stats_list else ClientStats(cid))
            if s.join(cid, st, preferred_role):
                accepted.append(cid)
                self._note_alive(session_id, cid)
            else:
                rejected.append(cid)
        self._notify(cohort_id, {"event": "cohort_joined",
                                 "cohort_id": cohort_id,
                                 "accepted": accepted, "rejected": rejected,
                                 "session": self._brief(s)})
        if accepted and s.state == SessionState.RUNNING:
            self._arrange(session_id, rearrange=True)   # one elastic re-plan
        else:
            self._maybe_start(session_id)

    def _cohort_ready(self, session_id: str, cohort_id: str,
                      client_ids: list,
                      round_idx: Optional[int] = None,
                      stats_list: Optional[list] = None) -> None:
        """Batched ``client_ready``: the whole cohort reports in one
        message; the round barrier is checked once, after the batch."""
        s = self.sessions.get(session_id)
        if s is None or s.state != SessionState.RUNNING \
                or s.async_cfg is not None:
            return
        if round_idx is not None and round_idx != s.round_idx:
            return                           # stale readiness: discard
        first = not s.ready
        for i, cid in enumerate(client_ids):
            st = ClientStats.from_dict(stats_list[i]) if stats_list else None
            s.mark_ready(cid, st)
        if first and s.ready:
            self._arm_deadline(session_id)
        if s.all_ready:
            if self.clock is not None:
                rnd = s.round_idx
                self.clock.call_when_idle(
                    lambda: self._finish_settled_round(session_id, rnd))
            else:
                self._finish_round(session_id)

    def _cohort_leave(self, session_id: str, cohort_id: str,
                      client_ids: list) -> None:
        """Batched leave (member-level churn inside a cohort): one
        rearrangement for the whole batch."""
        s = self.sessions.get(session_id)
        if s is None:
            return
        mem = self.cohort_members.get(cohort_id)
        left = False
        for cid in client_ids:
            if cid in s.contributors:
                s.leave(cid)
                left = True
            if mem is not None:
                mem.discard(cid)
        if left and s.state == SessionState.RUNNING:
            self._arrange(session_id, rearrange=True)
            if s.contributors and s.all_ready:
                self._finish_round(session_id)

    # ------------------------------------------------------------------
    # Defense: heartbeat liveness + outlier reports -> reputation
    # ------------------------------------------------------------------
    def _note_alive(self, session_id: str, client_id: str) -> None:
        hb = self._heartbeats.get(session_id)
        if hb is not None:
            hb[client_id] = self.clock.now if self.clock is not None else 0.0

    def _heartbeat(self, session_id: str, client_id: str) -> None:
        """Per-client liveness beat on the shared clock (metadata only)."""
        self._note_alive(session_id, client_id)

    def _defense_report(self, session_id: str, client_id: str,
                        reason: str = "norm_outlier",
                        reporter: str = "") -> None:
        """An aggregator rejected ``client_id``'s update.  The coordinator
        only sees the *metadata* (who, why) — never the tensors — and turns
        it into a reputation penalty; crossing ``demote_below`` while the
        client holds aggregator duty triggers an immediate rearrangement
        (the moving-target demotion)."""
        book = self.books.get(session_id)
        s = self.sessions.get(session_id)
        if book is None or s is None or client_id not in s.contributors:
            return
        amount = (book.cfg.stale_penalty if reason == "stale"
                  else book.cfg.outlier_penalty)
        score = book.penalize(client_id, amount)
        if self.obs is not None:
            self.obs.trace("reputation_penalty", session=session_id,
                           client=client_id, reason=reason,
                           score=round(score, 4), reporter=reporter)
        if book.quarantined(client_id) and s.state == SessionState.RUNNING:
            asg = self.assignments.get(session_id, {}).get(client_id)
            if asg is not None and asg.duties:
                self._arrange(session_id, rearrange=True)  # demote now

    def _arm_liveness(self, session_id: str) -> None:
        """Periodic heartbeat sweep on the virtual clock: a contributor not
        heard from for ``liveness_misses`` beats takes a miss penalty per
        sweep.  Cancels itself when the session ends."""
        book = self.books.get(session_id)
        if book is None or self.clock is None:
            return
        cfg = book.cfg
        window = cfg.heartbeat_period_s * cfg.liveness_misses

        def sweep():
            s = self.sessions.get(session_id)
            if s is None or s.state == SessionState.TERMINATED:
                return False
            if s.state != SessionState.RUNNING:
                return True
            now = self.clock.now
            hb = self._heartbeats.setdefault(session_id, {})
            for cid in list(s.contributors):
                if now - hb.get(cid, 0.0) > window:
                    score = book.penalize(cid, cfg.miss_penalty)
                    if self.obs is not None:
                        self.obs.trace("heartbeat_miss", session=session_id,
                                       client=cid, score=round(score, 4))
            return True

        self.clock.schedule_periodic(window, sweep)

    def _on_will_raw(self, topic: str, payload) -> None:
        """Failure detector: LWT fired for a dead client."""
        args = payload["a"] if isinstance(payload, dict) else [payload]
        client_id = args[0] if args else topic.rsplit("/", 1)[-1]
        self.client_failed(client_id)

    def _on_global_raw(self, topic: str, payload) -> None:
        sid = topic.split("/")[2]
        if sid not in self._pending_cut:
            return
        body = payload["a"][0] if isinstance(payload, dict) and "a" in payload \
            else payload
        rnd = body.get("round") if isinstance(body, dict) else None
        if rnd == self._pending_cut[sid]:
            self._close_cut_round(sid, rnd)

    def _on_async_global(self, topic: str, payload) -> None:
        """Async-session bookkeeping: every minted global bumps the
        session's version counter; at ``fl_rounds`` versions the session
        terminates (the async analogue of the round budget)."""
        sid = topic.split("/")[2]
        s = self.sessions.get(sid)
        if s is None or s.async_cfg is None \
                or s.state != SessionState.RUNNING:
            return
        body = payload["a"][0] if isinstance(payload, dict) and "a" in payload \
            else payload
        ver = body.get("version", 0) if isinstance(body, dict) else 0
        if ver > s.round_idx:
            s.round_idx = ver
            s.history.append({"round": ver, "participants":
                              sorted(s.contributors)})
            if self.obs is not None:
                self.obs.trace("round_complete", session=sid, version=ver)
            if self.on_round_complete:
                self.on_round_complete(sid, ver)
        if 0 < s.fl_rounds <= ver:
            s.state = SessionState.TERMINATED
            self.fc.unbind(T.global_model(sid))
            if self.obs is not None:
                self.obs.trace("session_end", session=sid, rounds=ver)
            self._broadcast_status(sid, {"event": "session_terminated",
                                         "rounds": ver})

    # ------------------------------------------------------------------
    # Orchestration
    # ------------------------------------------------------------------
    def _maybe_start(self, session_id: str) -> None:
        s = self.sessions[session_id]
        if s.state == SessionState.WAITING and s.full:
            self.start_session(session_id)

    def expire_waiting(self, session_id: str) -> bool:
        """Waiting time elapsed (paper §III-E1): start at quorum even if not
        full.  Returns whether the session started."""
        s = self.sessions[session_id]
        if s.state == SessionState.WAITING and s.quorum:
            self.start_session(session_id)
            return True
        return False

    def start_session(self, session_id: str) -> None:
        """Quorum reached (or waiting time expired): cluster + arrange."""
        s = self.sessions[session_id]
        assert s.quorum, "cannot start below capacity_min"
        s.state = SessionState.CLUSTERING
        self._arrange(session_id, rearrange=False)
        s.state = SessionState.RUNNING
        if s.defense_cfg is not None:
            self._arm_liveness(session_id)
        if s.async_cfg is not None:
            # K-of-N mode: no round barrier.  The coordinator only watches
            # the global topic to track minted versions and terminate the
            # session once the version budget (fl_rounds) is spent.
            self.fc.subscribe_raw(T.global_model(session_id),
                                  self._on_async_global)
            return
        if self.obs is not None:
            self.obs.trace("round_start", session=session_id,
                           round=s.round_idx)
        self._broadcast_status(session_id, {"event": "round_start",
                                            "round": s.round_idx})
        self._arm_round(session_id)

    def _rank_aggregators(self, s: FLSession) -> list[str]:
        pol = get_policy(self.cfg.role_policy)
        ranked = pol(s.contributors, s.round_idx)
        # respect stated preferences: aggregator-volunteers first (paper:
        # clients notify preference; coordinator decides suitability) — but
        # a quarantined client cannot volunteer its way into head duty
        book = self.books.get(s.session_id)
        vols = [c for c in ranked
                if (s.preferred_roles.get(c, "").startswith("agg")
                    or s.preferred_roles.get(c) == "trainer_aggregator")
                and (book is None or not book.quarantined(c))]
        if not vols:
            return ranked
        vset = set(vols)                    # O(1) lookup at fleet scale
        return vols + [c for c in ranked if c not in vset]

    def _arrange(self, session_id: str, rearrange: bool) -> None:
        """(Re)build the cluster tree and send role assignments.  Initial
        arrangement informs everyone; rearrangement only the changed."""
        s = self.sessions[session_id]
        clients = sorted(s.contributors)
        if not clients:
            s.state = SessionState.TERMINATED
            return
        book = self.books.get(session_id)
        if book is not None:
            # live trust scores ride the stats the policies rank on
            for cid, st in s.contributors.items():
                st.reputation = book.score(cid)
        ranked = self._rank_aggregators(s)
        tree = build_tree(session_id, clients, ranked,
                          self.cfg.aggregator_ratio, self.cfg.levels)
        errs = validate_tree(tree, clients)
        assert not errs, errs
        new_assign = tree.assignments()
        old_assign = self.assignments.get(session_id, {})
        old_wire = self._assign_wire.get(session_id, {})
        new_wire = {cid: a.to_dict() for cid, a in new_assign.items()}
        self.trees[session_id] = tree
        self.assignments[session_id] = new_assign
        self._assign_wire[session_id] = new_wire
        if rearrange and old_assign:
            # moving-target bookkeeping: the aggregator set changing hands
            # IS a rotation (reputation demotions, policy rotation, churn)
            old_heads = {c for c, a in old_assign.items() if a.duties}
            new_heads = {c for c, a in new_assign.items() if a.duties}
            if old_heads != new_heads:
                self.roles_rotations += 1
                if self.obs is not None:
                    self.obs.trace(
                        "role_rotated", session=session_id,
                        round=s.round_idx,
                        promoted=sorted(new_heads - old_heads),
                        demoted=sorted(old_heads - new_heads))
        batches: dict[str, list] = {}       # cohort -> changed assignments
        for cid, wire in new_wire.items():
            if rearrange and old_wire.get(cid) == wire:
                continue  # unchanged: not a single message (paper's point)
            co = self._cohort_of.get(cid)
            if co is not None:
                batches.setdefault(co, []).append(wire)
                continue
            payload = {"event": "role_assignment", "assignment": wire,
                       "round": s.round_idx}
            self._notify(cid, payload)
            if rearrange:
                self.rearrangement_messages += 1
            else:
                self.arrangement_messages += 1
        for co, asgs in batches.items():
            # one batched assignment message per cohort endpoint — the
            # fronted ids share a connection, so per-device messages would
            # all ride the same link anyway
            self.fc.call(T.client_ctrl(co),
                         {"event": "role_assignment_batch",
                          "assignments": asgs, "round": s.round_idx})
            if rearrange:
                self.rearrangement_messages += 1
            else:
                self.arrangement_messages += 1
        # publish the topology on the session topic (paper Fig. 5a); the
        # session's aggregation strategy rides along (retained), so late
        # joiners and every aggregator agree on the reduction semantics
        status = {"event": "topology", "tree": tree.describe(),
                  "strategy": s.strategy, "round": s.round_idx}
        if s.async_cfg is not None:
            # admission rules + live cohort size for every async aggregator
            status["async"] = {**s.async_cfg,
                               "cohort": len(s.contributors)}
        if s.defense_cfg is not None:
            # screening rules + live reputation map for every aggregator
            # (retained: late joiners screen with the same scores)
            status["defense"] = {
                **s.defense_cfg,
                "reputation": book.snapshot() if book is not None else {}}
        self.fc.call(T.session_status(session_id), status, retain=True)
        for cid, st in s.contributors.items():
            if cid in new_assign and new_assign[cid].duties:
                st.rounds_as_aggregator += 1

    def _finish_round(self, session_id: str) -> None:
        s = self.sessions[session_id]
        if self._pending_cut.pop(session_id, None) is not None:
            self.fc.unbind(T.global_model(session_id))
        if self.obs is not None:
            virtual_s = (self.clock.now - s.round_started_at
                         if self.clock is not None else None)
            wall0 = self._round_wall.pop(session_id, None)
            wall_s = (time.perf_counter() - wall0
                      if wall0 is not None else None)
            self.obs.observe_round(session_id, virtual_s, wall_s)
            self.obs.trace("round_complete", session=session_id,
                           round=s.round_idx,
                           contributors=len(s.contributors))
        book = self.books.get(session_id)
        if book is not None:
            # clean completed round heals reputation slowly (penalties for
            # fresh misbehavior outweigh the drip, so healing never races
            # an active attacker back into head duty)
            for cid in s.ready:
                book.heal(cid)
        s.next_round()
        if self.on_round_complete:
            self.on_round_complete(session_id, s.round_idx)
        if s.state == SessionState.TERMINATED:
            if self.obs is not None:
                self.obs.trace("session_end", session=session_id,
                               rounds=s.round_idx)
            self._broadcast_status(session_id, {"event": "session_terminated",
                                                "rounds": s.round_idx})
            return
        # role optimization + rearrangement for the new round
        self._arrange(session_id, rearrange=True)
        if self.obs is not None:
            self.obs.trace("round_start", session=session_id,
                           round=s.round_idx)
        self._broadcast_status(session_id, {"event": "round_start",
                                            "round": s.round_idx})
        self._arm_round(session_id)

    def _arm_round(self, session_id: str) -> None:
        """New round began: stamp the shared clock.  The straggler deadline
        is *relative*: it arms when the round's first readiness report
        lands (``_arm_deadline``), so a round whose training simply hasn't
        started yet is never cut with zero contributions."""
        if self.clock is not None:
            self.sessions[session_id].round_started_at = self.clock.now
        if self.obs is not None:
            self._round_wall[session_id] = time.perf_counter()

    def _arm_deadline(self, session_id: str) -> None:
        """First readiness of the round observed: every other participant
        has ``round_deadline_s`` virtual seconds to report before the
        coordinator cuts the round (paper §II exhaustion avoidance /
        partial aggregation)."""
        s = self.sessions[session_id]
        if self.clock is None or s.round_deadline_s <= 0:
            return
        rnd = s.round_idx
        self.clock.schedule(
            self.clock.now + s.round_deadline_s,
            lambda: self._deadline_hit(session_id, rnd), timer=True)

    def _deadline_hit(self, session_id: str, round_idx: int) -> None:
        """Round deadline elapsed on the virtual clock with stragglers still
        missing: flush partial aggregates, then close the round once the
        flush cascade has fully drained."""
        s = self.sessions.get(session_id)
        if s is None or s.state != SessionState.RUNNING \
                or s.round_idx != round_idx or s.all_ready:
            return
        self.deadline_cuts += 1
        if self.obs is not None:
            self.obs.trace("deadline_cut", session=session_id,
                           round=round_idx)
        if session_id not in self._pending_cut:
            # observe this session's global publishes only while a cut is
            # pending — the cut round closes the moment its (partial)
            # global lands, and the coordinator doesn't pay for model
            # traffic the rest of the time
            self.fc.subscribe_raw(T.global_model(session_id),
                                  self._on_global_raw)
        self._pending_cut[session_id] = round_idx
        self.force_round_end(session_id)
        # primary close: the flushed (partial) global landing for this round
        # (_on_global_raw); fallback: the delivery queue going fully idle —
        # covers a cut where nothing reached the root at all
        self.clock.call_when_idle(
            lambda: self._close_cut_round(session_id, round_idx))

    def _close_cut_round(self, session_id: str, round_idx: int) -> None:
        s = self.sessions.get(session_id)
        if s is not None and s.state == SessionState.RUNNING \
                and s.round_idx == round_idx:
            self._finish_round(session_id)

    def force_round_end(self, session_id: str) -> None:
        """Straggler deadline hit: flush aggregators LEVEL BY LEVEL.  With
        no clock (or zero spacing) each publish fully drains the broker
        queue, so level-l partials reach level-l+1 heads before their own
        flush arrives; under a held clock with modeled latency, space the
        levels by ``flush_spacing_s`` virtual seconds instead."""
        tree = self.trees.get(session_id)
        n_levels = len(tree.levels) if tree else 1
        spacing = self.cfg.flush_spacing_s
        for lvl in range(n_levels):
            if self.clock is not None and spacing > 0:
                self.clock.schedule(
                    self.clock.now + lvl * spacing,
                    lambda l=lvl: self.fc.call(
                        T.session_status(session_id),
                        {"event": "flush", "level": l}))
            else:
                self.fc.call(T.session_status(session_id),
                             {"event": "flush", "level": lvl})

    def client_failed(self, client_id: str) -> None:
        members = self.cohort_members.pop(client_id, None)
        if members:
            # a cohort endpoint died: every logical id it fronted is gone
            self.failed_clients.update(members)
            for m in members:
                self._cohort_of.pop(m, None)
            for sid, s in self.sessions.items():
                hit = [m for m in members if m in s.contributors]
                if hit and s.state == SessionState.RUNNING:
                    for m in hit:
                        s.leave(m)
                    if s.contributors:
                        self._arrange(sid, rearrange=True)
                        if s.all_ready:
                            self._finish_round(sid)
                    else:
                        s.state = SessionState.TERMINATED
            return
        self.failed_clients.add(client_id)
        for sid, s in self.sessions.items():
            if client_id in s.contributors and s.state == SessionState.RUNNING:
                s.leave(client_id)
                self._arrange(sid, rearrange=True)
                if s.all_ready and s.contributors:
                    self._finish_round(sid)

    # ------------------------------------------------------------------
    def _notify(self, client_id: str, payload: dict) -> None:
        # control traffic for a cohort-fronted id lands on the cohort's
        # own control topic (the fronted ids have no connection of their own)
        self.fc.call(T.client_ctrl(self._cohort_of.get(client_id, client_id)),
                     payload)

    def _broadcast_status(self, session_id: str, payload: dict) -> None:
        self.fc.call(T.session_status(session_id), payload)

    def tree_of(self, session_id: str) -> ClusterTree:
        return self.trees[session_id]
