"""Asynchronous federation: bounded-staleness FedBuff buffers, head gossip
under partitions, per-client round pacing — on the discrete-event substrate.

The synchronous round protocol (paper §III-E) blocks every round on the
slowest client.  ``AsyncFederatedSession`` removes the barrier while keeping
the whole cluster-tree data plane:

  * **Bounded-staleness aggregation** (FedBuff, Nguyen et al. 2022): every
    aggregator duty guards its streaming flat-f64 accumulator
    (``core.client._Accumulator`` — the buffer itself stays in-place and
    zero-copy) with an ``AsyncBuffer`` that admits *round-stamped*
    contributions.  A contribution trained ``s`` global versions ago is
    rejected when ``s > staleness_bound`` and otherwise admitted at weight
    ``w * discount(s)`` (constant or polynomial ``(1+s)^-a``, pluggable via
    the strategy's ``staleness_discount`` hook or ``AsyncConfig``).  The
    root mints a new global whenever ``buffer_k`` contributions have landed
    — K-of-N instead of the full cohort; intermediate heads forward their
    partial once a proportional share of their cluster has reported.  With
    ``buffer_k = cohort`` and an unlimited bound the trigger points and the
    accumulation order coincide exactly with the synchronous path, so the
    async globals are bit-identical to ``run_round`` (tested).

  * **Per-client pacing**: each client schedules its own next-round start
    on the shared ``SimClock`` (heterogeneous periods + seeded jitter), so
    client cadence is decoupled from any coordinator barrier.  Stragglers
    contribute late-but-stamped instead of blocking the federation.

  * **Head gossip**: cluster heads periodically publish their current model
    view on ``sdflmq/session/<sid>/gossip/<cid>`` (QoS 1).  When a head
    flushes a partial it also blends the buffer mean into its own view (a
    *site model*, stamped ``(version, site_seq)``), so during a
    ``partition()`` the side that lost the root keeps converging on gossip
    exchanges while the root's side keeps minting real globals.  Receivers
    adopt strictly-newer versions, average same-version site models, and on
    ``heal()`` the round-stamped rules reconcile both sides: held globals
    win, held contributions past the staleness bound are rejected and
    counted.

Everything runs on virtual time: two runs with the same seeds produce
bit-identical globals and identical event schedules.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.api.federation import FederatedSession, TrainFn


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclass
class AsyncConfig:
    """Knobs of one asynchronous session (serialized into the retained
    topology broadcast, so every aggregator applies the same admission
    rules — ``cohort`` is stamped in by the coordinator).

    Pass an instance (or a dict of these fields, or ``True`` for the
    defaults) as ``create_session(..., async_mode=...)`` to switch a
    session to K-of-N FedBuff federation:

    >>> from repro_torch.api import AsyncConfig
    >>> cfg = AsyncConfig(buffer_k=3, staleness_bound=2,
    ...                   base_period_s=0.5)
    >>> wire = cfg.to_wire()          # the admission-relevant subset
    >>> wire["k"], wire["bound"]
    (3, 2)
    >>> AsyncConfig().staleness_bound is None     # default: unbounded
    True
    """

    buffer_k: int = 2                 # contributions that trigger a global
    staleness_bound: Optional[int] = None   # None = unbounded
    staleness_weight: str = "strategy"      # strategy | constant | poly
    poly_a: float = 0.5               # exponent of the poly discount
    base_period_s: float = 1.0        # default per-client pacing period
    period_jitter_s: float = 0.0      # uniform jitter added to each gap
    periods: dict = field(default_factory=dict)   # per-client overrides
    seed: int = 0                     # pacing-jitter RNG seed
    gossip_period_s: float = 0.0      # 0 = head gossip off
    gossip_alpha: float = 0.5         # site-model blend factor

    def to_wire(self) -> dict:
        """The admission-relevant subset every aggregator needs."""
        return {"k": int(self.buffer_k), "bound": self.staleness_bound,
                "weight": self.staleness_weight, "poly_a": float(self.poly_a),
                "gossip_period_s": float(self.gossip_period_s),
                "gossip_alpha": float(self.gossip_alpha)}


def resolve_discount(acfg: dict, strat) -> Callable[[int], float]:
    """Staleness-discount weight function for one admission point."""
    kind = acfg.get("weight", "strategy")
    if kind == "strategy":
        return strat.staleness_discount
    if kind == "constant":
        return lambda s: 1.0
    if kind == "poly":
        a = float(acfg.get("poly_a", 0.5))
        return lambda s: (1.0 + float(max(0, s))) ** (-a)
    raise KeyError(f"unknown staleness weight {kind!r} "
                   "(have: strategy, constant, poly)")


def head_share(expected: int, k: int, cohort: int) -> int:
    """Flush trigger (in received messages) for a non-root duty: the
    cluster's proportional share of the K-of-N buffer.  With k = cohort
    this is exactly ``expected`` — the synchronous trigger."""
    return max(1, min(int(expected), -(-int(expected) * int(k)
                                       // max(int(cohort), 1))))


# ---------------------------------------------------------------------------
# The FedBuff admission gate
# ---------------------------------------------------------------------------

class AsyncBuffer:
    """Bounded-staleness admission metadata over ONE streaming accumulator
    (``core.client._Accumulator``).  The tensors live in the accumulator's
    preallocated flat buffer; this class only tracks how many *leaf*
    contributions the buffer represents, the oldest admitted stamp, and the
    rejection count — enough for K-of-N triggering and stamped partials."""

    __slots__ = ("acc", "contribs", "min_stamp", "rejected_stale", "flushes",
                 "discount")

    def __init__(self, acc, acfg: Optional[dict] = None, strat=None):
        self.acc = acc
        self.rejected_stale = 0        # lifetime, across cycles
        self.flushes = 0
        # resolved once per duty, not per message (admission hot path)
        self.discount: Callable[[int], float] = (
            resolve_discount(acfg, strat) if acfg is not None
            else (lambda s: 1.0))
        self.start_cycle()

    def start_cycle(self) -> None:
        self.contribs = 0              # leaf contributions this cycle
        self.min_stamp: Optional[int] = None

    def note_stamp(self, stamp: int) -> None:
        self.min_stamp = stamp if self.min_stamp is None \
            else min(self.min_stamp, stamp)


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

@dataclass
class AsyncReport:
    """Counters of one ``run_async`` drive (all on the virtual clock)."""
    updates: int = 0                  # global versions minted
    admitted: int = 0                 # leaf contributions admitted
    rejected_stale: int = 0           # contributions past the bound
    gossip_sent: int = 0
    gossip_adopts: int = 0            # newer-version adoptions
    gossip_merges: int = 0            # same-version site-model averages
    site_updates: int = 0             # site models minted by heads
    virtual_time_s: float = 0.0
    final_state: str = ""
    stalled: bool = False             # no event left before termination
    timed_out: bool = False           # max_time_s exhausted
    partition_held: int = 0
    partition_dropped: int = 0
    timeline: list = field(default_factory=list)   # (t, version)


# ---------------------------------------------------------------------------
# The session handle
# ---------------------------------------------------------------------------

class AsyncFederatedSession(FederatedSession):
    """Handle to one asynchronous FL session.  Create it through
    ``Federation.create_session(..., async_mode=AsyncConfig(...))`` (or a
    plain dict of the same fields), then drive it with ``run_async``::

        session = fed.create_session("s", "m", rounds=20, participants=cs,
                                     async_mode=dict(buffer_k=3,
                                                     staleness_bound=4))
        report = session.run_async(train, initial_params=init)

    ``rounds`` becomes the target number of *global versions*: the
    coordinator watches the global topic and terminates the session once
    version ``rounds`` has been minted."""

    def __init__(self, federation, session_id: str, model_name: str,
                 strategy, cfg: AsyncConfig):
        super().__init__(federation, session_id, model_name, strategy)
        self.cfg = cfg
        self._pacers: dict = {}
        self._gossipers: dict = {}
        self._train_fn: Optional[TrainFn] = None

    # -- the synchronous round loop does not apply ------------------------
    def run_round(self, *a, **kw):  # pragma: no cover - guard rail
        raise RuntimeError("async session: drive it with run_async() "
                           "(there is no synchronous round barrier)")

    run_round_async = run_round
    run = run_round

    # ------------------------------------------------------------------
    # Per-client pacing
    # ------------------------------------------------------------------
    def _period_for(self, cid: str) -> float:
        return float(self.cfg.periods.get(cid, self.cfg.base_period_s))

    def _jitter_for(self, cid: str) -> Optional[Callable[[], float]]:
        if self.cfg.period_jitter_s <= 0:
            return None
        rng = random.Random(f"{self.cfg.seed}/pace/{cid}")
        return lambda: rng.uniform(0.0, self.cfg.period_jitter_s)

    def _fire(self, cid: str):
        """One pacing tick: train against the client's current model view
        (global or gossip site model), publish stamped with the version the
        training started from.  Returning False cancels the timer series."""
        if self.state != "running" or cid not in self.participants:
            return False
        cl = self.participants[cid]
        ctx = cl.models.sessions.get(self.session_id)
        if ctx is None or ctx.terminated:
            return False
        base = ctx.view_params if ctx.view_params is not None else self._initial
        obs = self.federation.obs
        if obs is not None:
            obs.trace("train", session=self.session_id, client=cid,
                      version=ctx.global_version)
        params, n_samples = self._train_fn(cid, base, ctx.global_version)
        cl.set_model(self.session_id, params, n_samples=n_samples)
        cl.send_local(self.session_id)
        return True

    def start_pacing(self, train_fn: Optional[TrainFn] = None) -> None:
        """Arm (or re-arm after churn) every participant's pacing timer.
        Idempotent: live timers are left untouched, so mid-run joiners get
        paced without disturbing existing cadences."""
        if train_fn is not None:
            self._train_fn = train_fn
        assert self._train_fn is not None, "start_pacing needs a train_fn"
        clock = self.federation.clock
        for cid in sorted(self.participants):
            t = self._pacers.get(cid)
            if t is not None and not t.cancelled:
                continue
            jf = self._jitter_for(cid)
            first = clock.now + (jf() if jf else 0.0)
            self._pacers[cid] = clock.schedule_periodic(
                self._period_for(cid), lambda c=cid: self._fire(c),
                first_at=first, jitter_fn=jf)

    # ------------------------------------------------------------------
    # Head gossip
    # ------------------------------------------------------------------
    def _gossip_fire(self, cid: str):
        if self.state != "running":
            return False
        cl = self.participants.get(cid)
        if cl is None:
            return False
        if cl.arbiter.is_aggregator:        # only current heads publish
            cl.gossip_publish(self.session_id)
        return True                          # stay armed across role churn

    def start_gossip(self) -> None:
        if self.cfg.gossip_period_s <= 0:
            return
        clock = self.federation.clock
        for cid in sorted(self.participants):
            t = self._gossipers.get(cid)
            if t is not None and not t.cancelled:
                continue
            self._gossipers[cid] = clock.schedule_periodic(
                self.cfg.gossip_period_s, lambda c=cid: self._gossip_fire(c))

    # ------------------------------------------------------------------
    # The drive loop
    # ------------------------------------------------------------------
    def run_async(self, train_fn: TrainFn,
                  target_version: Optional[int] = None,
                  max_time_s: float = 600.0,
                  events: Sequence = (),
                  initial_params=None) -> AsyncReport:
        """Hold the clock, pace every client, and advance virtual time
        event by event until the session terminates (coordinator observed
        ``rounds`` global versions), ``target_version`` is reached, or
        ``max_time_s`` virtual seconds elapse.  ``events`` are
        ``repro_torch.api.scenarios`` events; round-driven ones (churn) fire per
        minted *version*."""
        if initial_params is not None:
            self._initial = initial_params
        fed = self.federation
        clock = fed.clock
        report = AsyncReport()
        tv = target_version if target_version is not None \
            else self._session.fl_rounds
        for ev in events:
            ev.arm(self)
        t_end = clock.now + float(max_time_s)
        with clock.hold():
            self.start_pacing(train_fn)
            self.start_gossip()
            last_v = self.global_version()
            while self.state == "running":
                if tv and self.global_version() >= tv:
                    break
                nxt = clock.next_event_time()
                if nxt is None:
                    report.stalled = True
                    break
                if nxt > t_end:
                    report.timed_out = True
                    break
                clock.advance_to(nxt)
                v = self.global_version()
                rearmed = False
                while last_v < v:
                    last_v += 1
                    report.timeline.append((round(clock.now, 6), last_v))
                    for ev in events:
                        ev.apply_round(self, last_v)
                        rearmed = True
                if rearmed:
                    self.start_pacing()      # pace clients churned in
                    self.start_gossip()
            if self.state == "running":
                # exiting with the session still live (target version,
                # timeout, stall): cancel the timer series so the shared
                # clock goes quiet — a later drive re-arms via start_pacing
                self.stop_pacing()
        fed.deliver()
        self._fill_report(report)
        if fed.obs is not None:
            # trace-derived timeline (same events /metrics sees): replaces
            # the bare (t, version) breadcrumbs with labeled control-plane
            # events — mints, partitions, heals, gossip — in virtual-time
            # order.  The breadcrumb shape is preserved when metrics are
            # off, keeping the default bit-identical.
            report.timeline = fed.obs.tracer.timeline()
        return report

    def stop_pacing(self) -> None:
        for t in list(self._pacers.values()) + list(self._gossipers.values()):
            t.cancel()
        self._pacers.clear()
        self._gossipers.clear()

    # ------------------------------------------------------------------
    def _fill_report(self, report: AsyncReport) -> None:
        report.updates = self.global_version()
        report.final_state = self.state
        report.virtual_time_s = self.federation.clock.now
        for cl in self.participants.values():
            ctx = cl.models.sessions.get(self.session_id)
            if ctx is None:
                continue
            report.admitted += ctx.async_admitted
            report.rejected_stale += ctx.async_rejected
            report.gossip_sent += ctx.gossip_sent
            report.gossip_adopts += ctx.gossip_adopts
            report.gossip_merges += ctx.gossip_merges
            report.site_updates += ctx.site_updates
        transport = self.federation.transport
        report.partition_held = getattr(transport, "partition_held", 0)
        report.partition_dropped = getattr(transport, "partition_dropped", 0)
