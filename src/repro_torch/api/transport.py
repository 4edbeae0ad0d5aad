"""Transport abstraction: the interface SDFLMQ actually needs from a broker.

``Transport`` is the protocol extracted from SimBroker — MQTTFC, clients,
the coordinator, and the parameter server depend on this surface only, so a
real paho-mqtt backend (or a multi-broker bridge fabric) can slot in behind
the same federation code.

``SimClock`` is a discrete-event virtual clock: a priority queue of
timestamped events drained strictly in ``(time, insertion)`` order.  Two
event classes live on it:

  * **message events** — in-flight deliveries scheduled by transports and
    broker bridges; drained by ``run_until_idle()`` and by any time advance;
  * **timer events** — control-plane alarms (round deadlines, waiting-time
    expiry, scenario triggers); they fire *only* when time is explicitly
    advanced (``advance_to``/``advance``), never during a plain message
    drain, so legacy synchronous flows are untouched.

``LatencyTransport`` decorates any Transport with a per-link edge-network
model (base delay + jitter + loss probability per publishing client) and an
**event-driven delivery queue**: each publish is enqueued with its modeled
arrival time instead of pumping immediately, so

  * two clients' updates published A,B can genuinely arrive B,A under
    asymmetric link delay (hold the clock, then drain);
  * QoS 0 publishes are *really* dropped with probability ``drop_p``;
  * QoS >= 1 publishes always arrive (at-least-once) but a drawn drop
    counts as a retransmission and the message arrives *late* (2x latency)
    — genuinely after messages sent later on faster links;
  * ``partition(groups)`` holds QoS>=1 traffic between clients in
    different groups until ``heal()`` (QoS 0 cross-partition traffic is
    lost, as a real broker outage would lose it);
  * with the clock un-held (the default), every top-level publish drains
    the queue to idle immediately, which is behaviorally identical to the
    old synchronous pump — zero-delay models stay bit-identical.

Randomness is drawn from a *per-link* seeded ``random.Random`` stream
(keyed on ``(seed, sender)``), so a link's jitter/drop sequence is
reproducible regardless of how messages from other links interleave, and
parallel tests never share RNG state.
"""
from __future__ import annotations

import heapq
import itertools
import random
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Protocol, runtime_checkable


@runtime_checkable
class Transport(Protocol):
    """What the control/data planes require from a message broker."""

    name: str

    def connect(self, client_id: str, on_message: Callable,
                will: Optional[Any] = None,
                clean_session: Optional[bool] = None) -> Any: ...

    def disconnect(self, client_id: str, graceful: bool = True) -> None: ...

    def subscribe(self, client_id: str, topic_filter: str,
                  qos: int = 0) -> None: ...

    def unsubscribe(self, client_id: str, topic_filter: str) -> None: ...

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False, sender: str = "") -> int: ...

    def sys_stats(self) -> dict: ...


# ---------------------------------------------------------------------------
# Virtual time
# ---------------------------------------------------------------------------

@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)
    timer: bool = field(compare=False, default=False)
    cancelled: bool = field(compare=False, default=False)

    def cancel(self) -> None:
        self.cancelled = True


class SimClock:
    """Discrete-event virtual clock shared by transports, brokers, and the
    coordinator.  ``schedule`` enqueues an event; draining fires events in
    strict ``(time, insertion)`` order and advances ``now`` to each event's
    timestamp — time never flows backwards.

    >>> from repro_torch.api.transport import SimClock
    >>> clock, order = SimClock(), []
    >>> _ = clock.schedule(2.0, lambda: order.append("late"))
    >>> _ = clock.schedule(1.0, lambda: order.append("early"))
    >>> clock.run_until_idle()      # messages drain in timestamp order
    >>> order, clock.now
    (['early', 'late'], 2.0)
    >>> _ = clock.schedule(5.0, lambda: order.append("alarm"), timer=True)
    >>> clock.run_until_idle()      # timers wait for an explicit advance
    >>> _ = clock.advance_to(5.0)
    >>> order[-1]
    'alarm'
    """

    def __init__(self, now: float = 0.0):
        self.now = float(now)
        # Message events live in per-shard heaps (one per broker site in a
        # fleet fabric; the anonymous ``None`` shard otherwise) and timer
        # events in their own heap.  The global ``(time, seq)`` order is
        # reconstructed by popping the minimum head across heaps, so the
        # split is invisible to callers — but a message-only drain never
        # touches armed timers (the old single heap popped and re-pushed
        # every earlier timer on each delivery: O(timers log n) per event),
        # and each site's backlog stays in its own smaller heap.
        self._mheaps: dict[Any, list[_Event]] = {None: []}
        self._theap: list[_Event] = []
        self._seq = itertools.count()
        self._held = 0
        self._draining = False
        self._idle_cbs: list[Callable] = []
        # external event sources (real-network transports): polled during
        # drains so "idle" also means "no real traffic in flight"
        self._sources: list[Callable[[bool], bool]] = []

    # ---- external sources ------------------------------------------------
    def add_source(self, poll: Callable[[bool], bool]) -> None:
        """Register an external event source — ``poll(block)`` must
        dispatch any pending external events (e.g. inbound frames from a
        real MQTT connection) and return whether it made progress.  With
        ``block=True`` the source may wait for in-flight traffic to
        surface (``PahoTransport`` runs its flush-barrier quiescence
        protocol there).  Sources are polled during every drain, so
        ``run_until_idle`` / ``advance_to`` transparently include real
        network traffic, and idle callbacks fire only once both the event
        heap AND every source are quiet."""
        if poll not in self._sources:
            self._sources.append(poll)

    def remove_source(self, poll: Callable[[bool], bool]) -> None:
        try:
            self._sources.remove(poll)
        except ValueError:
            pass

    def _poll_sources(self, block: bool) -> bool:
        progressed = False
        for poll in list(self._sources):
            if poll(block):
                progressed = True
        return progressed

    # ---- scheduling ------------------------------------------------------
    def schedule(self, t: float, fn: Callable, timer: bool = False,
                 shard: Any = None) -> _Event:
        """Schedule ``fn`` to run at virtual time ``t`` (clamped to now).
        ``timer=True`` marks a control-plane alarm: it fires only on
        explicit time advances, never during a message drain.  ``shard``
        names the event-loop shard (e.g. a broker site) whose heap the
        event rides; unknown shards are created on first use."""
        ev = _Event(max(float(t), self.now), next(self._seq), fn, timer)
        if timer:
            heapq.heappush(self._theap, ev)
        else:
            h = self._mheaps.get(shard)
            if h is None:
                h = self._mheaps[shard] = []
            heapq.heappush(h, ev)
        return ev

    def call_when_idle(self, fn: Callable) -> None:
        """Run ``fn`` (once) the next time the message queue is empty —
        i.e. after every in-flight delivery cascade has settled."""
        self._idle_cbs.append(fn)

    def schedule_periodic(self, period: float, fn: Callable,
                          first_at: Optional[float] = None,
                          jitter_fn: Optional[Callable] = None) -> "_PeriodicTimer":
        """Arm a recurring *timer* event every ``period`` virtual seconds
        (first firing at ``first_at``, default ``now + period``).  The
        returned handle's ``cancel()`` stops the series; ``fn`` returning
        ``False`` also stops it.  ``jitter_fn()`` (if given) is added to
        each inter-fire gap — pass a seeded callable for reproducible
        jitter.  Used by async-FL per-client pacing and head-gossip timers."""
        return _PeriodicTimer(self, float(period), fn, first_at, jitter_fn)

    # ---- hold: manual mode ----------------------------------------------
    @property
    def held(self) -> bool:
        return self._held > 0

    @contextmanager
    def hold(self):
        """While held, transports stop auto-draining after each publish:
        deliveries accumulate in the queue and are released only by
        ``advance_to``/``advance``/``run_until_idle`` — this is what lets
        messages genuinely arrive out of publish order."""
        self._held += 1
        try:
            yield self
        finally:
            self._held -= 1

    # ---- introspection ---------------------------------------------------
    def pending(self, timers: bool = True) -> int:
        n = sum(1 for h in self._mheaps.values()
                for e in h if not e.cancelled)
        if timers:
            n += sum(1 for e in self._theap if not e.cancelled)
        return n

    def shards(self) -> dict:
        """Live message-event count per event-loop shard (introspection)."""
        return {k: sum(1 for e in h if not e.cancelled)
                for k, h in self._mheaps.items() if h}

    @staticmethod
    def _head(h: list) -> Optional[_Event]:
        while h and h[0].cancelled:
            heapq.heappop(h)                 # lazy cleanup: O(1) amortized
        return h[0] if h else None

    def next_event_time(self) -> Optional[float]:
        times = [e.time for e in map(self._head, self._mheaps.values()) if e]
        th = self._head(self._theap)
        if th is not None:
            times.append(th.time)
        return min(times) if times else None

    # ---- draining --------------------------------------------------------
    def _pop_due(self, limit: float, timers: bool) -> Optional[_Event]:
        # pop the globally-earliest due event: scan shard heads (K small),
        # never touching the timer heap during message-only drains
        best_h = None
        best = None
        for h in self._mheaps.values():
            e = self._head(h)
            if e and (best is None or (e.time, e.seq) < (best.time, best.seq)):
                best, best_h = e, h
        if timers:
            e = self._head(self._theap)
            if e and (best is None or (e.time, e.seq) < (best.time, best.seq)):
                best, best_h = e, self._theap
        if best is None or best.time > limit:
            return None
        return heapq.heappop(best_h)

    def _fire_idle_cbs(self) -> bool:
        if self._idle_cbs and self.pending(timers=False) == 0:
            cbs, self._idle_cbs = self._idle_cbs, []
            for cb in cbs:
                cb()
            return True
        return False

    def _drain(self, limit: float, timers: bool) -> None:
        if self._draining:
            return
        self._draining = True
        try:
            while True:
                # external sources first (cheap non-blocking poll): inbound
                # real-network frames dispatch before anything else, like
                # queued SimBroker deliveries would
                if self._sources and self._poll_sources(block=False):
                    continue
                # idle callbacks fire the moment no message events remain —
                # checked before the next (possibly later) timer pops, so
                # "the cascade settled" is observed at the right instant.
                # With external sources, "settled" must include traffic
                # still in flight on real sockets: block on the sources'
                # quiescence protocol before declaring idle.
                if self._idle_cbs and self._sources \
                        and self.pending(timers=False) == 0 \
                        and self._poll_sources(block=True):
                    continue
                if self._fire_idle_cbs():
                    continue
                ev = self._pop_due(limit, timers)
                if ev is None:
                    if self._sources and self._poll_sources(block=True):
                        continue
                    break
                self.now = max(self.now, ev.time)
                ev.fn()
        finally:
            self._draining = False

    def run_until_idle(self) -> None:
        """Deliver every queued *message* event in timestamp order (timers
        stay armed), advancing ``now`` along the way."""
        self._drain(float("inf"), timers=False)

    def advance_to(self, t: float) -> float:
        """Advance virtual time to ``t``, firing every event (messages AND
        timers) scheduled at or before ``t`` in exact timestamp order."""
        self._drain(float(t), timers=True)
        self.now = max(self.now, float(t))
        return self.now

    def advance(self, dt: float) -> float:
        return self.advance_to(self.now + dt)


class _PeriodicTimer:
    """Self-rescheduling timer series on a SimClock (see
    ``SimClock.schedule_periodic``)."""

    __slots__ = ("clock", "period", "fn", "jitter_fn", "cancelled", "_ev",
                 "fires")

    def __init__(self, clock: SimClock, period: float, fn: Callable,
                 first_at: Optional[float], jitter_fn: Optional[Callable]):
        self.clock = clock
        self.period = period
        self.fn = fn
        self.jitter_fn = jitter_fn
        self.cancelled = False
        self.fires = 0
        t0 = clock.now + period if first_at is None else float(first_at)
        self._ev = clock.schedule(t0, self._fire, timer=True)

    def _fire(self) -> None:
        if self.cancelled:
            return
        self.fires += 1
        keep = self.fn()
        if keep is False or self.cancelled:
            self.cancelled = True
            return
        gap = self.period + (self.jitter_fn() if self.jitter_fn else 0.0)
        self._ev = self.clock.schedule(self.clock.now + max(gap, 1e-9),
                                       self._fire, timer=True)

    def cancel(self) -> None:
        self.cancelled = True
        if self._ev is not None:
            self._ev.cancel()


@dataclass
class LinkModel:
    """Per-link network parameters (seconds / probability).  ``dup_p`` is
    the probability that a QoS>=1 publish is *redelivered* — the broker's
    at-least-once duplicate, arriving as a genuine second copy after the
    original (possibly after newer frames), exercising receiver dedup."""
    delay_s: float = 0.0
    jitter_s: float = 0.0
    drop_p: float = 0.0
    dup_p: float = 0.0


@dataclass
class _LinkStats:
    messages: int = 0
    dropped: int = 0
    retransmits: int = 0
    duplicates: int = 0
    latency_s: float = 0.0
    max_latency_s: float = 0.0

    def observe(self, lat: float) -> None:
        self.messages += 1
        self.latency_s += lat
        self.max_latency_s = max(self.max_latency_s, lat)


class LatencyTransport:
    """Event-driven per-link delay/jitter/drop/partition decorator over a
    Transport, scheduling deliveries on a shared ``SimClock``.

    >>> from repro_torch.api.transport import LatencyTransport
    >>> from repro_torch.core.broker import SimBroker
    >>> t = LatencyTransport(SimBroker(), delay_s=0.05)
    >>> got = []
    >>> _ = t.connect("sub", lambda m: got.append(bytes(m.payload)))
    >>> t.subscribe("sub", "sensors/+", qos=1)
    >>> _ = t.publish("sensors/t1", b"21.5", qos=1, sender="edge-node")
    >>> got                      # clock un-held: publish drained to idle
    [b'21.5']
    >>> t.clock.now              # ... after the modeled link delay
    0.05
    """

    def __init__(self, inner: Transport, delay_s: float = 0.0,
                 jitter_s: float = 0.0, drop_p: float = 0.0,
                 dup_p: float = 0.0, seed: int = 0,
                 clock: Optional[SimClock] = None):
        self.inner = inner
        self.default = LinkModel(delay_s, jitter_s, drop_p, dup_p)
        # event-loop shard this transport's deliveries ride (a fleet fabric
        # sets one per broker site; None = the clock's anonymous shard)
        self.shard: Any = None
        self.links: dict[str, LinkModel] = {}
        self.seed = seed
        self._rngs: dict[str, random.Random] = {}
        self.clock = clock if clock is not None else SimClock()
        # real-network inner transports (PahoTransport) register themselves
        # as an external event source so clock drains pump their traffic
        attach = getattr(inner, "attach_clock", None)
        if attach is not None:
            attach(self.clock)
        self.link_stats: dict[str, _LinkStats] = {}
        # partition state: list of disjoint client-id groups; traffic
        # between different groups is cut (ungrouped actors reach everyone)
        self._groups: Optional[list[set]] = None
        self._held_msgs: list[tuple[str, Any]] = []     # (receiver, Message)
        self._callbacks: dict[str, Callable] = {}
        self._current_sender: Optional[str] = None
        self._last_arrival: dict[str, float] = {}       # per-sender FIFO
        self.partition_held = 0
        self.partition_dropped = 0
        # optional telemetry facade (repro_torch.obs.Telemetry); set by
        # Federation(metrics=...).  None = zero-overhead default.
        self.obs = None

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def virtual_time_s(self) -> float:
        return self.clock.now

    def set_link(self, client_id: str, delay_s: float = 0.0,
                 jitter_s: float = 0.0, drop_p: float = 0.0,
                 dup_p: float = 0.0) -> None:
        self.links[client_id] = LinkModel(delay_s, jitter_s, drop_p, dup_p)

    def clear_link(self, client_id: str) -> None:
        self.links.pop(client_id, None)

    def _rng_for(self, sender: str) -> random.Random:
        rng = self._rngs.get(sender)
        if rng is None:
            rng = self._rngs[sender] = random.Random(f"{self.seed}/{sender}")
        return rng

    # ---- partitions ------------------------------------------------------
    def partition(self, *groups) -> None:
        """Cut connectivity between clients in different ``groups`` (each an
        iterable of client ids).  Clients not named in any group keep full
        connectivity.  QoS>=1 and retained traffic across the cut is held;
        QoS 0 traffic is lost."""
        self._groups = [set(g) for g in groups]
        if self.obs is not None:
            self.obs.trace("partition", groups=len(self._groups),
                           clients=sum(len(g) for g in self._groups))

    def heal(self) -> None:
        """Restore connectivity and release held messages (delivered at the
        heal time, in the order they were originally routed)."""
        self._groups = None
        held, self._held_msgs = self._held_msgs, []
        if self.obs is not None:
            self.obs.trace("heal", released=len(held))
        for receiver, msg in held:
            self.clock.schedule(
                self.clock.now,
                lambda r=receiver, m=msg: self._deliver_direct(r, m),
                shard=self.shard)
        if not self.clock.held:
            self.clock.run_until_idle()

    def _cut(self, sender: str, receiver: str) -> bool:
        if self._groups is None or sender == receiver:
            return False
        gs = gr = None
        for g in self._groups:
            if sender in g:
                gs = g
            if receiver in g:
                gr = g
        return gs is not None and gr is not None and gs is not gr

    def _deliver_direct(self, receiver: str, msg) -> None:
        fn = self._callbacks.get(receiver)
        if fn is not None:
            fn(msg)

    # ---- Transport surface ----------------------------------------------
    def connect(self, client_id, on_message, will=None,
                clean_session: Optional[bool] = None):
        self._callbacks[client_id] = on_message

        def guarded(msg, _cid=client_id, _fn=on_message):
            snd = self._current_sender
            if snd is not None and self._cut(snd, _cid):
                if msg.qos >= 1 or msg.retain:
                    self.partition_held += 1
                    self._held_msgs.append((_cid, msg))
                else:
                    self.partition_dropped += 1
                return
            _fn(msg)

        return self.inner.connect(client_id, guarded, will=will,
                                  clean_session=clean_session)

    def disconnect(self, client_id, graceful: bool = True):
        self._callbacks.pop(client_id, None)
        return self.inner.disconnect(client_id, graceful=graceful)

    def subscribe(self, client_id, topic_filter, qos: int = 0):
        return self.inner.subscribe(client_id, topic_filter, qos=qos)

    def unsubscribe(self, client_id, topic_filter):
        return self.inner.unsubscribe(client_id, topic_filter)

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False, sender: str = "") -> int:
        link = self.links.get(sender, self.default)
        st = self.link_stats.setdefault(sender or "<anon>", _LinkStats())
        rng = self._rng_for(sender or "<anon>")
        lat = link.delay_s + rng.uniform(0.0, link.jitter_s)
        if link.drop_p and rng.random() < link.drop_p:
            if qos == 0:
                st.dropped += 1
                return -1                     # fire-and-forget: lost
            st.retransmits += 1               # at-least-once: resend once,
            lat *= 2.0                        # arriving genuinely late
        st.observe(lat)
        # per-sender FIFO: one client's messages ride one ordered MQTT
        # connection, so a later publish never overtakes an earlier one
        # (cross-sender reordering is real; same-sender reordering is not)
        key = sender or "<anon>"
        arrival = max(self.clock.now + lat, self._last_arrival.get(key, 0.0))
        self._last_arrival[key] = arrival
        if self.obs is not None:
            self.obs.trace("publish", topic=topic, sender=key, qos=qos,
                           bytes=len(payload), arrival=round(arrival, 6))
        self.clock.schedule(
            arrival,
            lambda: self._deliver(topic, payload, qos, retain, sender),
            shard=self.shard)
        if link.dup_p and qos >= 1 and not retain \
                and rng.random() < link.dup_p:
            # broker at-least-once redelivery: a genuine second copy of the
            # same frame, arriving after the original — deliberately NOT
            # clamped to the per-sender FIFO horizon, so it can land after
            # newer frames, exactly like a real broker's retransmit
            st.duplicates += 1
            dup_arrival = arrival + max(lat, 1e-6) \
                + rng.uniform(0.0, link.jitter_s + link.delay_s)
            self.clock.schedule(
                dup_arrival,
                lambda: self._deliver(topic, payload, qos, retain, sender),
                shard=self.shard)
        if not self.clock.held:
            self.clock.run_until_idle()
        return 0

    def _deliver(self, topic, payload, qos, retain, sender) -> None:
        if self.obs is not None:
            self.obs.trace("deliver", topic=topic, sender=sender or "<anon>",
                           bytes=len(payload))
        prev, self._current_sender = self._current_sender, sender or None
        try:
            self.inner.publish(topic, payload, qos=qos, retain=retain,
                               sender=sender)
        finally:
            self._current_sender = prev

    def sys_stats(self) -> dict:
        out = dict(self.inner.sys_stats())
        out["virtual_time_s"] = round(self.clock.now, 6)
        out["pending_deliveries"] = self.clock.pending(timers=False)
        out["partition_held"] = self.partition_held
        out["partition_dropped"] = self.partition_dropped
        out["links"] = {
            k: {"messages": s.messages, "dropped": s.dropped,
                "retransmits": s.retransmits, "duplicates": s.duplicates,
                "mean_latency_ms": round(
                    1e3 * s.latency_s / s.messages, 3) if s.messages else 0.0,
                "max_latency_ms": round(1e3 * s.max_latency_s, 3)}
            for k, s in self.link_stats.items()}
        return out

    # anything else (bridge, retained_topics, delivery_log, ...) passes
    # through to the wrapped broker
    def __getattr__(self, item):
        return getattr(self.inner, item)
