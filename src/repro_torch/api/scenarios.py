"""Declarative edge-network scenarios over the virtual clock.

Scenario builders turn "what goes wrong" into armed events on a
federation's ``SimClock`` (time-driven: partitions, flaky links) or its
round loop (round-driven churn, layered on ``ft.failures.FailurePlan``)::

    from repro_torch.api import Federation, scenarios

    fed = Federation(latency=dict(delay_s=0.01), round_deadline_s=2.0)
    session = fed.create_session(...)
    report = scenarios.play(
        session, train_fn,
        events=[scenarios.partition([["c0", "c1"], ["c2", "c3"]],
                                    t0=2.0, t1=5.0),
                scenarios.flaky_link("c4", p=0.3, delay_s=0.2),
                scenarios.churn(fail_at={3: ["c5"]}, join_at={5: ["c9"]})],
        rounds=8, round_time_s=1.0,
        initial_params=init)

``play`` drives a ``step_time``-paced round loop: each round's training and
publishes are enqueued with the clock **held**, then virtual time advances
in ``round_time_s`` strides — deliveries and control-plane timers (round
deadlines, partition windows) fire strictly in timestamp order, so messages
genuinely reorder, partitioned traffic waits for heal, and deadline cuts
land between deliveries exactly as they would on a real edge network.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.ft.failures import FailurePlan


def _amap(fn, *trees):
    """Elementwise map over parallel params pytrees (dict/list/tuple/leaf)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _amap(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_amap(fn, *vals) for vals in zip(*trees))
    return fn(*trees)


def _copy_tree(params):
    return _amap(lambda v: np.array(v), params)


# ---------------------------------------------------------------------------
# Scenario events
# ---------------------------------------------------------------------------

class ScenarioEvent:
    """Base: ``arm`` schedules time-driven triggers; ``apply_round`` fires
    once per round launch (before training)."""

    def arm(self, session) -> None:  # pragma: no cover - trivial default
        pass

    def apply_round(self, session, round_idx: int) -> None:
        pass


@dataclass
class Partition(ScenarioEvent):
    """Cut connectivity between client groups during ``[t0, t1)`` virtual
    seconds.  ``t1=None`` leaves the partition open until an explicit
    ``transport.heal()``.  Clients not named in any group (coordinator,
    parameter server, ...) keep full connectivity unless listed."""
    groups: Sequence[Sequence[str]]
    t0: float = 0.0
    t1: Optional[float] = None

    def arm(self, session) -> None:
        transport = session.federation.transport
        clock = session.federation.clock
        clock.schedule(self.t0,
                       lambda: transport.partition(*self.groups), timer=True)
        if self.t1 is not None:
            clock.schedule(self.t1, transport.heal, timer=True)


def _link_endpoints(spec) -> list:
    """Normalize a flaky-link spec — one client id, a list of ids, or a list
    of ``(a, b)`` link pairs (both endpoints degraded) — to client ids."""
    items = [spec] if isinstance(spec, str) else list(spec)
    out: list = []
    for item in items:
        ids = [item] if isinstance(item, str) else list(item)
        for cid in ids:
            if cid not in out:
                out.append(cid)
    return out


@dataclass
class FlakyLink(ScenarioEvent):
    """Degrade client links (loss probability ``p``, duplication probability
    ``dup_p`` for at-least-once redelivery, optional extra delay/jitter)
    during ``[t0, t1)``; restores the previous models at t1.  ``clients``
    accepts one client id, a list of ids, or ``(a, b)`` link pairs — so one
    builder can degrade a whole cluster's links."""
    clients: Union[str, Sequence]
    p: float = 0.0
    delay_s: float = 0.0
    jitter_s: float = 0.0
    dup_p: float = 0.0
    t0: float = 0.0
    t1: Optional[float] = None

    def arm(self, session) -> None:
        transport = session.federation.transport
        clock = session.federation.clock
        ids = _link_endpoints(self.clients)
        saved: dict = {}

        def degrade():
            for cid in ids:
                saved[cid] = transport.links.get(cid)
                transport.set_link(cid, delay_s=self.delay_s,
                                   jitter_s=self.jitter_s, drop_p=self.p,
                                   dup_p=self.dup_p)

        def restore():
            for cid in ids:
                prev = saved.pop(cid, None)
                if prev is None:
                    transport.clear_link(cid)
                else:
                    transport.links[cid] = prev

        clock.schedule(self.t0, degrade, timer=True)
        if self.t1 is not None:
            clock.schedule(self.t1, restore, timer=True)


@dataclass
class Churn(ScenarioEvent):
    """Round-driven membership churn from a ``FailurePlan``: at round ``r``
    fail ``plan.fail_at[r]`` abnormally (LWT fires), join
    ``plan.join_at[r]`` elastically, and slow ``plan.straggle_at[r]``
    (extra per-link delay for that round only)."""
    plan: FailurePlan
    _slowed: dict = field(default_factory=dict)

    def apply_round(self, session, round_idx: int) -> None:
        transport = session.federation.transport
        clock = session.federation.clock
        # restore last round's stragglers
        for cid, prev in self._slowed.items():
            if prev is None:
                transport.clear_link(cid)
            else:
                transport.links[cid] = prev
        self._slowed = {}
        changed = False
        for cid in self.plan.fail_at.get(round_idx, []):
            if cid in session.participants:
                session.fail(cid)
                changed = True
        for cid in self.plan.join_at.get(round_idx, []):
            session.join(session.federation.client(cid))
            changed = True
        if changed:
            # settle the rearrangement handshake before training starts, so
            # churn applies at the round boundary (not mid-flight)
            clock.run_until_idle()
        for cid, extra in self.plan.straggle_at.get(round_idx, {}).items():
            if cid not in session.participants:
                continue
            self._slowed[cid] = transport.links.get(cid)
            transport.set_link(cid, delay_s=extra)


# ---------------------------------------------------------------------------
# Adversarial events (malicious clients, not just faulty links)
# ---------------------------------------------------------------------------

@dataclass
class Attack(ScenarioEvent):
    """Base for adversarial clients: ``transform_update`` rewrites what an
    attacker-controlled client publishes for a round.  ``play``/``play_async``
    wrap the caller's ``train_fn`` so every attack sees (and may replace) the
    honest update before it hits the wire — deterministic, seeded only by the
    builder's own parameters, and composable with partitions/churn/flaky
    links.  Each injection emits an ``attack_injected`` trace through the
    federation's telemetry (when metrics are on) and bumps ``injected``."""
    clients: Sequence[str] = ()
    start_round: int = 0
    end_round: Optional[int] = None
    injected: int = field(default=0, init=False)

    kind = "attack"                     # class attr, not a dataclass field

    def _active(self, round_idx: int) -> bool:
        return (round_idx >= self.start_round
                and (self.end_round is None or round_idx < self.end_round))

    def targets(self, client_id: str) -> bool:
        return client_id in self.clients

    def transform_update(self, session, round_idx: int, client_id: str,
                         params, weight, global_params):
        """Return ``(params, weight)`` to replace the honest update, or
        ``None`` to leave it untouched this round."""
        raise NotImplementedError

    def maybe_transform(self, session, round_idx: int, client_id: str,
                        params, weight, global_params):
        if not self._active(round_idx) or not self.targets(client_id):
            return None
        out = self.transform_update(session, round_idx, client_id,
                                    params, weight, global_params)
        if out is not None:
            self.injected += 1
            obs = session.federation.obs
            if obs is not None:
                obs.trace("attack_injected", session=session.session_id,
                          attack=self.kind, client=client_id,
                          round=round_idx)
        return out


@dataclass
class LabelFlip(Attack):
    """Label-flip poisoning: the attacker trains against inverted labels,
    modeled as publishing the *inverted* update ``g - flip_scale*(p - g)``
    (it pulls the global exactly opposite to its honest gradient)."""
    flip_scale: float = 1.0

    kind = "label_flip"

    def transform_update(self, session, round_idx, client_id,
                         params, weight, global_params):
        s = self.flip_scale
        if global_params is None:
            return _amap(lambda v: np.asarray(
                -s * np.asarray(v, np.float64), np.asarray(v).dtype),
                params), weight
        def flip(v, gv):
            v = np.asarray(v)
            g64 = np.asarray(gv, np.float64)
            return np.asarray(g64 - s * (np.asarray(v, np.float64) - g64),
                              v.dtype)
        return _amap(flip, params, global_params), weight


@dataclass
class ScalePoison(Attack):
    """Model-poisoning by update inflation: publishes ``g + lam*(p - g)`` —
    the honest delta scaled ×``lam`` (boosted/model-replacement attack)."""
    lam: float = 10.0

    kind = "scale_poison"

    def transform_update(self, session, round_idx, client_id,
                         params, weight, global_params):
        lam = self.lam
        if global_params is None:
            return _amap(lambda v: np.asarray(
                lam * np.asarray(v, np.float64), np.asarray(v).dtype),
                params), weight
        def scale(v, gv):
            v = np.asarray(v)
            g64 = np.asarray(gv, np.float64)
            return np.asarray(g64 + lam * (np.asarray(v, np.float64) - g64),
                              v.dtype)
        return _amap(scale, params, global_params), weight


@dataclass
class FreeRider(Attack):
    """Free-riding: contribute nothing while claiming sample weight.
    ``mode="zero"`` republishes the current global (a zero update);
    ``mode="replay"`` replays the client's own stale round-0 update forever
    (first round trains honestly to have something to replay)."""
    mode: str = "zero"
    _cache: dict = field(default_factory=dict, init=False)

    kind = "free_rider"

    def transform_update(self, session, round_idx, client_id,
                         params, weight, global_params):
        if self.mode == "replay":
            hit = self._cache.get(client_id)
            if hit is None:
                self._cache[client_id] = (_copy_tree(params), weight)
                return None                 # honest once, stale forever after
            stale_p, stale_w = hit
            return _copy_tree(stale_p), stale_w
        if global_params is None:
            return _amap(lambda v: np.zeros_like(np.asarray(v)), params), \
                weight
        return _copy_tree(global_params), weight


@dataclass
class SybilFlood(Attack):
    """Sybil join flood: at round ``at_round`` mint ``count`` fresh client
    identities and push them through the elastic-join path; every admitted
    sybil then publishes scaled-poison updates (×``lam``).  The flood both
    stresses admission/rearrangement and hands the robust combines a
    colluding majority-attempt to reject."""
    count: int = 3
    at_round: int = 1
    lam: float = 5.0
    prefix: str = "sybil"
    joined: list = field(default_factory=list, init=False)

    kind = "sybil_flood"

    def targets(self, client_id: str) -> bool:
        return client_id in self.joined or client_id in self.clients

    def apply_round(self, session, round_idx: int) -> None:
        if round_idx != self.at_round:
            return
        obs = session.federation.obs
        for i in range(self.count):
            cid = f"{self.prefix}{i}"
            if session.join(cid):
                self.joined.append(cid)
                self.injected += 1
                if obs is not None:
                    obs.trace("attack_injected", session=session.session_id,
                              attack=self.kind, client=cid, round=round_idx)

    def transform_update(self, session, round_idx, client_id,
                         params, weight, global_params):
        lam = self.lam
        if global_params is None:
            return _amap(lambda v: np.asarray(
                lam * np.asarray(v, np.float64), np.asarray(v).dtype),
                params), weight
        def scale(v, gv):
            v = np.asarray(v)
            g64 = np.asarray(gv, np.float64)
            return np.asarray(g64 + lam * (np.asarray(v, np.float64) - g64),
                              v.dtype)
        return _amap(scale, params, global_params), weight


def wrap_attacks(session, train_fn: Callable,
                 events: Sequence[ScenarioEvent]) -> Callable:
    """Wrap ``train_fn`` so armed ``Attack`` events rewrite attacker-
    controlled updates before publish.  Attacks compose in event order
    (later attacks see earlier attacks' output).  No attacks → the original
    ``train_fn`` is returned unchanged (bit-identical clean runs)."""
    attacks = [ev for ev in events if isinstance(ev, Attack)]
    if not attacks:
        return train_fn

    def attacked(client_id, global_params, round_idx):
        params, weight = train_fn(client_id, global_params, round_idx)
        for atk in attacks:
            out = atk.maybe_transform(session, round_idx, client_id,
                                      params, weight, global_params)
            if out is not None:
                params, weight = out
        return params, weight

    return attacked


# ---- builders (the declarative surface) -----------------------------------

def partition(groups: Sequence[Sequence[str]], t0: float = 0.0,
              t1: Optional[float] = None) -> Partition:
    return Partition(groups, t0, t1)


def flaky_link(clients: Union[str, Sequence], p: float = 0.0,
               delay_s: float = 0.0, jitter_s: float = 0.0,
               dup_p: float = 0.0, t0: float = 0.0,
               t1: Optional[float] = None) -> FlakyLink:
    """``clients``: one id, a list of ids, or ``(a, b)`` link pairs."""
    return FlakyLink(clients, p, delay_s, jitter_s, dup_p, t0, t1)


def label_flip(clients: Sequence[str], flip_scale: float = 1.0,
               start_round: int = 0,
               end_round: Optional[int] = None) -> LabelFlip:
    return LabelFlip(list(clients), start_round, end_round, flip_scale)


def scale_poison(clients: Sequence[str], lam: float = 10.0,
                 start_round: int = 0,
                 end_round: Optional[int] = None) -> ScalePoison:
    return ScalePoison(list(clients), start_round, end_round, lam)


def free_rider(clients: Sequence[str], mode: str = "zero",
               start_round: int = 0,
               end_round: Optional[int] = None) -> FreeRider:
    assert mode in ("zero", "replay"), mode
    return FreeRider(list(clients), start_round, end_round, mode)


def sybil_flood(count: int = 3, at_round: int = 1, lam: float = 5.0,
                prefix: str = "sybil",
                end_round: Optional[int] = None) -> SybilFlood:
    return SybilFlood([], 0, end_round, count, at_round, lam, prefix)


def churn(plan: Optional[FailurePlan] = None, *,
          fail_at: Optional[dict] = None, join_at: Optional[dict] = None,
          straggle_at: Optional[dict] = None) -> Churn:
    if plan is None:
        plan = FailurePlan(fail_at=fail_at or {}, join_at=join_at or {},
                           straggle_at=straggle_at or {})
    return Churn(plan)


# ---------------------------------------------------------------------------
# The scenario runner
# ---------------------------------------------------------------------------

@dataclass
class ScenarioReport:
    rounds_launched: int = 0
    rounds_completed: int = 0
    final_state: str = ""
    virtual_time_s: float = 0.0
    deadline_cuts: int = 0
    stale_dropped: int = 0
    partition_held: int = 0
    partition_dropped: int = 0
    stalled: bool = False
    timeline: list = field(default_factory=list)   # (t, event) breadcrumbs


def play_async(session, train_fn: Callable,
               events: Sequence[ScenarioEvent] = (),
               target_version: Optional[int] = None,
               max_time_s: float = 600.0, initial_params=None):
    """Drive an ``AsyncFederatedSession`` through its K-of-N pacing loop
    with scenario ``events`` armed.  Time-driven events (partitions, flaky
    links) fire on the virtual clock exactly as in ``play``; round-driven
    events (churn) fire once per minted *global version* instead of per
    synchronous round.  Returns the session's ``AsyncReport`` (versions
    minted, admitted/stale-rejected contributions, gossip counters,
    virtual time, timeline)."""
    from repro_torch.api.async_fl import AsyncFederatedSession
    assert isinstance(session, AsyncFederatedSession), \
        "play_async drives async sessions; use play() for synchronous ones"
    train_fn = wrap_attacks(session, train_fn, events)
    return session.run_async(train_fn, target_version=target_version,
                             max_time_s=max_time_s, events=events,
                             initial_params=initial_params)


def play(session, train_fn: Callable, events: Sequence[ScenarioEvent] = (),
         rounds: Optional[int] = None, round_time_s: float = 1.0,
         initial_params=None, stats_fn: Optional[Callable] = None,
         max_idle_steps: int = 50) -> ScenarioReport:
    """Drive ``session`` through a virtual-time round loop with ``events``
    armed.  Each newly started round is trained + published immediately,
    then the clock advances in ``round_time_s`` strides until the session
    terminates, ``rounds`` rounds have launched, or no progress is made for
    ``max_idle_steps`` strides (e.g. an unhealed partition with no round
    deadline) — then ``report.stalled`` is set."""
    fed = session.federation
    clock = fed.clock
    report = ScenarioReport()
    if initial_params is not None:
        session._initial = initial_params
    train_fn = wrap_attacks(session, train_fn, events)
    for ev in events:
        ev.arm(session)
    launched = -1
    idle = 0
    with clock.hold():
        while session.state == "running":
            r = session.round_idx
            if rounds is not None and report.rounds_launched >= rounds \
                    and r != launched:
                break
            if r != launched:
                for ev in events:
                    ev.apply_round(session, r)
                if session.state != "running" or not session.participants:
                    break
                session.run_round_async(train_fn, stats_fn=stats_fn)
                launched = r
                report.rounds_launched += 1
                report.timeline.append((round(clock.now, 6), f"round {r}"))
                idle = 0
            clock.advance(round_time_s)
            if session.round_idx == launched:
                idle += 1
                if idle >= max_idle_steps:
                    report.stalled = True
                    break
    fed.deliver()
    report.rounds_completed = session.round_idx
    report.final_state = session.state
    report.virtual_time_s = clock.now
    coord = fed.coordinator
    report.deadline_cuts = coord.deadline_cuts
    transport = fed.transport
    report.partition_held = getattr(transport, "partition_held", 0)
    report.partition_dropped = getattr(transport, "partition_dropped", 0)
    report.stale_dropped = sum(
        cl.models.sessions[session.session_id].stale_dropped
        for cl in session.participants.values()
        if session.session_id in cl.models.sessions)
    if fed.obs is not None:
        # trace-derived timeline (the same events /metrics counts): labeled
        # control-plane events — round starts/completions, partitions,
        # heals, deadline cuts, mints — in virtual-time order.  The bare
        # "round N" breadcrumbs are preserved when metrics are off, keeping
        # the default bit-identical.
        report.timeline = fed.obs.tracer.timeline()
    return report
