"""The SDFLMQ facade: one entry point for running federations.

``Federation`` wires the infrastructure (transport/broker(s), coordinator,
parameter server) once; ``FederatedSession`` handles run the paper's round
protocol (create/join, local train, send, global update, readiness) so that
examples, benchmarks, and drivers stop hand-rolling the loop::

    from repro_torch.api import Federation

    fed = Federation()
    clients = [fed.client(f"c{i}") for i in range(5)]
    session = fed.create_session("s1", model_name="mlp", rounds=3,
                                 participants=clients,
                                 strategy="trimmed_mean")

    def train(client_id, global_params, round_idx):
        local = my_local_training(global_params)
        return local, n_samples

    session.run(train, initial_params=init)
    final = session.global_params()

Edge-network scenarios: pass ``latency=dict(delay_s=..., jitter_s=...,
drop_p=...)`` (or a prebuilt LatencyTransport) to model per-link delay and
loss on the control/model plane.

Virtual time: every federation owns a ``SimClock`` shared by its transport
and coordinator.  By default the clock auto-drains (each publish delivers
to idle — identical to a synchronous pump); inside ``fed.clock.hold()``
deliveries queue at their modeled arrival times and ``session.step_time``
(or ``repro_torch.api.scenarios.play``) releases them in timestamp order, so
reordering, partitions, straggler deadlines, and churn become exercisable.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

from repro_torch.api.strategies import AggregationStrategy, get_strategy
from repro_torch.api.transport import LatencyTransport, SimClock, Transport
from repro_torch.core.broker import SimBroker
from repro_torch.core.client import Params, SDFLMQClient
from repro_torch.core.coordinator import Coordinator, CoordinatorConfig
from repro_torch.core.parameter_server import ParameterServer
from repro_torch.core.stats import ClientStats

TrainFn = Callable[[str, Optional[Params], int], tuple[Params, int]]


class Federation:
    """Owns the infrastructure of one federation: a transport, the
    coordinator service, and the parameter server.

    The default transport is an in-process ``SimBroker`` (deterministic,
    synchronous); pass ``transport=PahoTransport(...)`` to run the same
    federation over a real MQTT broker, or ``latency=dict(...)`` to model
    per-link edge networks on virtual time — the session code is
    identical on all three.

    >>> import numpy as np
    >>> from repro_torch.api import Federation
    >>> fed = Federation()
    >>> clients = [fed.client(f"c{i}") for i in range(3)]
    >>> session = fed.create_session("demo", model_name="m", rounds=1,
    ...                              participants=clients)
    >>> def train(client_id, global_params, round_idx):
    ...     value = float(client_id[1:]) + 1.0     # c0 -> 1.0, c1 -> 2.0 ...
    ...     return {"w": np.full(2, value, np.float32)}, 1
    >>> _ = session.run(train, initial_params={"w": np.zeros(2, np.float32)})
    >>> session.global_params()["w"]               # fedavg mean of 1, 2, 3
    array([2., 2.], dtype=float32)
    >>> session.state, session.global_version()
    ('terminated', 1)
    """

    def __init__(self, transport: Optional[Transport] = None,
                 latency: Optional[dict] = None,
                 role_policy: str = "memory_aware",
                 aggregator_ratio: float = 0.3,
                 levels: int = 3,
                 round_deadline_s: float = 0.0,
                 flush_spacing_s: float = 0.0,
                 clock: Optional[SimClock] = None,
                 coordinator_cfg: Optional[CoordinatorConfig] = None,
                 wire_format: str = "tb",
                 uplink_codec: Optional[str] = None,
                 downlink_codec: Optional[str] = None,
                 update_filter=None,
                 topk_density: float = 0.01,
                 topk_warmup_rounds: int = 0,
                 metrics=None):
        #: model-plane wire format for clients created via ``client()``:
        #: "tb" = zero-copy TensorBundle (default), "legacy" = msgpack
        #: ExtType (bit-identity fallback).  ``uplink_codec="int8_ef"``
        #: turns on int8+error-feedback quantized leaf uplinks;
        #: ``uplink_codec="topk_int8_ef"`` adds magnitude top-k
        #: sparsification at ``topk_density`` (EF residual carries the
        #: un-sent mass; ``topk_warmup_rounds`` early rounds ship dense
        #: int8 so the first globals aren't starved to k coordinates).
        #: ``downlink_codec="int8"`` quantizes the retained
        #: global broadcast.  ``update_filter`` (ParamFilter or comma
        #: pattern string) ships only matching leaves — the LoRA-style
        #: partial-update path for large models.
        self.wire_format = wire_format
        self.uplink_codec = uplink_codec
        self.downlink_codec = downlink_codec
        self.update_filter = update_filter
        self.topk_density = topk_density
        self.topk_warmup_rounds = topk_warmup_rounds
        transport = transport if transport is not None else SimBroker()
        if not isinstance(transport, LatencyTransport):
            transport = LatencyTransport(transport, clock=clock or SimClock(),
                                         **(latency or {}))
        elif latency:
            transport = LatencyTransport(transport,
                                         clock=clock or transport.clock,
                                         **latency)
        elif clock is not None:
            # prebuilt LatencyTransport + explicit clock: rebase the (still
            # fresh) transport onto the caller's clock rather than silently
            # ignoring it (re-attaching any real-network inner transport)
            transport.clock = clock
            attach = getattr(transport.inner, "attach_clock", None)
            if attach is not None:
                attach(clock)
        self.transport = transport
        self.clock = transport.clock
        self.coordinator = Coordinator(
            transport,
            coordinator_cfg or CoordinatorConfig(
                role_policy=role_policy, aggregator_ratio=aggregator_ratio,
                levels=levels, round_deadline_s=round_deadline_s,
                flush_spacing_s=flush_spacing_s),
            clock=self.clock)
        self.param_server = ParameterServer(transport)
        self.clients: dict[str, SDFLMQClient] = {}
        self.cohorts: dict = {}          # cohort_id -> CohortClient
        self.sessions: dict[str, "FederatedSession"] = {}
        #: opt-in telemetry (repro_torch.obs).  ``metrics`` accepts ``None``/
        #: ``False`` (off — the zero-overhead, bit-identical default),
        #: ``True`` (fresh registry), a ``MetricsRegistry`` to mirror
        #: into, or a prebuilt ``Telemetry``.  Trace timestamps ride the
        #: federation's virtual clock.
        self.obs = None
        if metrics is not None and metrics is not False:
            from repro_torch.obs import MetricsRegistry, Telemetry
            if isinstance(metrics, Telemetry):
                self.obs = metrics
            else:
                reg = metrics if isinstance(metrics, MetricsRegistry) else None
                self.obs = Telemetry(registry=reg, clock=self.clock)
            self.obs.bind_federation(self)
            self.transport.obs = self.obs
            # a wrapped transport (LatencyTransport over PahoTransport)
            # traces reconnect/backoff events from the inner layer
            inner = getattr(self.transport, "inner", None)
            if inner is not None:
                inner.obs = self.obs
            self.coordinator.obs = self.obs

    def deliver(self) -> None:
        """Drain every in-flight delivery (no-op while the clock is held —
        then ``clock.advance_to``/``session.step_time`` controls release)."""
        if not self.clock.held:
            self.clock.run_until_idle()

    def close(self) -> None:
        """Tear down the federation's transport connections.  A no-op for
        the in-process simulators; against a real MQTT backend
        (``PahoTransport``) this gracefully disconnects the pooled client
        connections so the broker drops their sessions without firing
        LWTs."""
        close = getattr(self.transport, "close", None)
        if close is not None:
            close()

    # alias: the transport of a single-broker federation IS the broker
    @property
    def broker(self) -> Transport:
        return self.transport

    @property
    def metrics(self):
        """The federation's ``MetricsRegistry`` (None when metrics are off)."""
        return self.obs.registry if self.obs is not None else None

    @property
    def tracer(self):
        """The federation's ``Tracer`` (None when metrics are off)."""
        return self.obs.tracer if self.obs is not None else None

    def client(self, client_id: str, preferred_role: str = "trainer",
               stats: Optional[ClientStats] = None) -> SDFLMQClient:
        """Create (or return) a client endpoint attached to this federation."""
        if client_id not in self.clients:
            cl = SDFLMQClient(
                client_id, self.transport, preferred_role=preferred_role,
                stats=stats, wire_format=self.wire_format,
                uplink_codec=self.uplink_codec,
                downlink_codec=self.downlink_codec,
                update_filter=self.update_filter,
                topk_density=self.topk_density,
                topk_warmup_rounds=self.topk_warmup_rounds)
            cl.obs = self.obs
            self.clients[client_id] = cl
        return self.clients[client_id]

    def cohort(self, cohort_id: str, member_ids: Iterable[str],
               stats: Optional[ClientStats] = None,
               transport: Optional[Transport] = None):
        """Create (or return) a ``CohortClient`` endpoint fronting
        ``member_ids`` as logical clients over ONE connection (fleet-scale
        mode).  ``transport`` attaches the cohort to a different transport
        than the federation's own — e.g. a per-site broker shard in a
        multi-broker fabric (``repro_torch.api.fleet``) — as long as it shares
        the federation's clock."""
        if cohort_id not in self.cohorts:
            from repro_torch.core.cohort import CohortClient
            co = CohortClient(cohort_id, transport or self.transport,
                              list(member_ids), wire_format=self.wire_format,
                              stats=stats)
            co.obs = self.obs
            self.cohorts[cohort_id] = co
        return self.cohorts[cohort_id]

    def create_fleet_session(self, session_id: str, model_name: str,
                             rounds: int, cohorts: Iterable,
                             strategy: Union[str, AggregationStrategy] = "fedavg",
                             session_time_s: float = 3600.0,
                             waiting_time_s: float = 120.0,
                             initial_params: Optional[Params] = None,
                             ) -> "FleetSession":
        """Fleet-scale session over ``CohortClient`` endpoints: each cohort
        joins all of its fronted members in one RPC; capacity is the total
        member count, so the session starts once every cohort has joined.
        ``initial_params`` seeds round 0 (before any global exists)."""
        cohorts = list(cohorts)
        assert cohorts, "a fleet session needs at least one cohort"
        strat = get_strategy(strategy)
        total = sum(len(co.active) for co in cohorts)
        session = FleetSession(self, session_id, model_name, strat)
        if initial_params is not None:
            session._initial = initial_params
        self.sessions[session_id] = session
        for co in cohorts:
            co.join_fleet_session(session_id, model_name, fl_rounds=rounds,
                                  capacity_min=total, capacity_max=total,
                                  session_time_s=session_time_s,
                                  waiting_time_s=waiting_time_s,
                                  strategy=strat.name)
            session._admit_cohort(co)
        self.deliver()
        return session

    def create_session(self, session_id: str, model_name: str, rounds: int,
                       participants: Iterable[Union[str, SDFLMQClient]],
                       strategy: Union[str, AggregationStrategy] = "fedavg",
                       capacity: Optional[tuple[int, int]] = None,
                       session_time_s: float = 3600.0,
                       waiting_time_s: float = 120.0,
                       async_mode=None,
                       defense=None) -> "FederatedSession":
        """First participant creates the session, the rest join.  ``capacity``
        defaults to exactly the participant set (session starts immediately
        once everyone has joined); pass ``(min, max)`` to leave headroom for
        elastic joins — then call ``session.start()`` once quorum suffices.

        ``async_mode`` switches the session to asynchronous K-of-N
        federation (bounded-staleness FedBuff buffers, per-client pacing,
        optional head gossip): pass a ``repro_torch.api.async_fl.AsyncConfig``, a
        dict of its fields, or ``True`` for the defaults — the handle is
        then an ``AsyncFederatedSession`` driven by ``run_async`` and
        ``rounds`` becomes the global-version budget.

        ``defense`` switches on the self-defending control plane (heartbeat
        liveness, update-norm screening, reputation-weighted combines, and
        reputation-driven role rotation when the federation runs the
        ``reputation_aware`` role policy): pass a
        ``repro_torch.core.defense.DefenseConfig``, a dict of its fields, or
        ``True`` for the defaults.

        A client endpoint can hold aggregation *roles* in only one session
        at a time (the RoleArbiter tracks a single assignment, as in the
        paper); run concurrent sessions with disjoint client sets."""
        members = [p if isinstance(p, SDFLMQClient) else self.client(p)
                   for p in participants]
        assert members, "a session needs at least one participant"
        cap_min, cap_max = capacity or (len(members), len(members))
        # names pass through untouched (resolve from the shared registry);
        # tuned instances get a session-scoped registration in the client
        async_wire = None
        if async_mode:
            from repro_torch.api.async_fl import (AsyncConfig,
                                            AsyncFederatedSession)
            acfg = (async_mode if isinstance(async_mode, AsyncConfig)
                    else AsyncConfig() if async_mode is True
                    else AsyncConfig(**dict(async_mode)))
            session = AsyncFederatedSession(self, session_id, model_name,
                                            get_strategy(strategy), acfg)
            async_wire = acfg.to_wire()
        else:
            session = FederatedSession(self, session_id, model_name,
                                       get_strategy(strategy))
        defense_wire = None
        if defense:
            from repro_torch.core.defense import DefenseConfig
            defense_wire = DefenseConfig.from_wire(defense).to_wire()
            session._defense = defense_wire
        self.sessions[session_id] = session
        members[0].create_fl_session(
            session_id, model_name, fl_rounds=rounds,
            session_capacity_min=cap_min, session_capacity_max=cap_max,
            session_time_s=session_time_s, waiting_time_s=waiting_time_s,
            strategy=strategy, async_cfg=async_wire,
            defense_cfg=defense_wire)
        session._admit(members[0])
        for m in members[1:]:
            session.join(m, rounds=rounds)
        return session


class FederatedSession:
    """Handle to one FL session: the round loop, membership, callbacks."""

    def __init__(self, federation: Federation, session_id: str,
                 model_name: str, strategy: AggregationStrategy):
        self.federation = federation
        self.session_id = session_id
        self.model_name = model_name
        self.strategy = strategy
        self.participants: dict[str, SDFLMQClient] = {}
        self.on_global_update: Optional[Callable] = None
        self._on_round_start: Optional[Callable] = None
        self._initial: Optional[Params] = None
        self._seen_version = 0          # dedupe fan-in from many clients
        self._seen_round = -1
        self._defense: Optional[dict] = None   # defense wire cfg (or None)

    # ------------------------------------------------------------------
    # Callbacks
    # ------------------------------------------------------------------
    @property
    def on_round_start(self) -> Optional[Callable]:
        return self._on_round_start

    @on_round_start.setter
    def on_round_start(self, fn: Optional[Callable]) -> None:
        """Round 0 starts while create_session is still executing, before
        the caller can possibly assign this hook — replay the last seen
        round_start on assignment so round 0 is observable."""
        self._on_round_start = fn
        if fn is not None and self._seen_round >= 0:
            fn(self._seen_round)

    # ------------------------------------------------------------------
    # Membership
    # ------------------------------------------------------------------
    def _admit(self, client: SDFLMQClient) -> None:
        if client.client_id in self.participants:
            return
        self.participants[client.client_id] = client
        if self._defense is not None:
            self._arm_heartbeat(client)
        # chain, don't clobber: a client may deliver events for several
        # sessions (each hook filters on its own session id)
        prev_g, prev_r = client.on_global_update, client.on_round_start

        def g_hook(sid, params, version):
            if prev_g:
                prev_g(sid, params, version)
            self._client_global_update(sid, params, version)

        def r_hook(sid, round_idx):
            if prev_r:
                prev_r(sid, round_idx)
            self._client_round_start(sid, round_idx)

        client.on_global_update = g_hook
        client.on_round_start = r_hook

    def _arm_heartbeat(self, client: SDFLMQClient) -> None:
        """Defense: every participant beats the coordinator's liveness
        endpoint on the shared clock.  The series self-cancels when the
        client leaves/fails or the session ends — a silently-dead (or
        deliberately mute) client stops beating and takes reputation
        penalties from the coordinator's sweep."""
        period = float(self._defense.get("heartbeat_period_s", 1.0))
        if period <= 0:
            return
        cid = client.client_id

        def beat():
            if self.state != "running" and self.state != "waiting":
                return False
            cl = self.participants.get(cid)
            if cl is None:
                return False
            cl.heartbeat(self.session_id)
            return True

        self.federation.clock.schedule_periodic(period, beat)

    def join(self, client: Union[str, SDFLMQClient], rounds: int = 0,
             preferred_role: Optional[str] = None) -> bool:
        """Join (also mid-run: the coordinator rearranges roles).  Returns
        whether the coordinator admitted the client.  The admission
        handshake is synchronous: even on a held clock, queued deliveries
        are drained so the answer reflects the coordinator's decision."""
        cl = (client if isinstance(client, SDFLMQClient)
              else self.federation.client(client))
        cl.join_fl_session(self.session_id, self.model_name, fl_rounds=rounds,
                           preferred_role=preferred_role)
        self.federation.clock.run_until_idle()
        ok = cl.client_id in self._session.contributors
        if ok:
            self._admit(cl)
        return ok

    def leave(self, client_id: str) -> None:
        """Graceful leave: the coordinator rearranges the remaining tree."""
        cl = self.participants.pop(client_id, None)
        if cl is not None:
            cl.leave(self.session_id)

    def fail(self, client_id: str) -> None:
        """Abnormal death: the broker fires the LWT, the coordinator's
        failure detector removes the client and rearranges."""
        cl = self.participants.pop(client_id, None)
        if cl is not None:
            cl.fail()
            self.federation.clients.pop(client_id, None)

    def start(self) -> bool:
        """Waiting time elapsed: start at quorum even if not full."""
        return self.federation.coordinator.expire_waiting(self.session_id)

    # ------------------------------------------------------------------
    # Round loop
    # ------------------------------------------------------------------
    def run_round_async(self, train_fn: TrainFn,
                        stats_fn: Optional[Callable] = None) -> int:
        """Local training on every participant, models up the cluster tree,
        readiness signals (round-status updates, paper §III-E4) — without
        waiting for delivery.  With the clock held, every message sits in
        the delivery queue at its modeled arrival time; drive it with
        ``step_time``/``clock.advance_to`` (or ``scenarios.play``).
        Returns the round index the work was published for."""
        rnd = self.round_idx
        base = self.global_params()
        if base is None:
            base = self._initial
        obs = self.federation.obs
        for cid, cl in sorted(self.participants.items()):
            if obs is not None:
                obs.trace("train", session=self.session_id, client=cid,
                          round=rnd)
            params, n_samples = train_fn(cid, base, rnd)
            cl.set_model(self.session_id, params, n_samples=n_samples)
        for cid, cl in sorted(self.participants.items()):
            cl.send_local(self.session_id)
        for cid, cl in sorted(self.participants.items()):
            cl.signal_ready(self.session_id,
                            stats=stats_fn(cid, rnd) if stats_fn else None)
        return rnd

    def run_round(self, train_fn: TrainFn,
                  stats_fn: Optional[Callable] = None) -> Optional[Params]:
        """One federated round: ``run_round_async`` + drain all deliveries.
        ``stats_fn(client_id, round_idx) -> ClientStats`` feeds fresh system
        stats to the role optimizer.  Returns the new global."""
        self.run_round_async(train_fn, stats_fn=stats_fn)
        self.federation.deliver()
        return self.global_params()

    def step_time(self, dt: Optional[float] = None) -> float:
        """Advance the federation's virtual clock — firing queued deliveries
        AND timers (round deadlines, scenario triggers) in timestamp order.
        ``dt=None`` steps to the next pending event.  Returns ``clock.now``."""
        clock = self.federation.clock
        if dt is None:
            nxt = clock.next_event_time()
            if nxt is not None:
                clock.advance_to(nxt)
            return clock.now
        return clock.advance(dt)

    def run(self, train_fn: TrainFn, rounds: Optional[int] = None,
            initial_params: Optional[Params] = None,
            stats_fn: Optional[Callable] = None) -> list[Params]:
        """Round loop until the session terminates (or ``rounds`` done).
        ``initial_params`` seeds round 0 (before any global exists)."""
        if initial_params is not None:
            self._initial = initial_params
        globals_seen: list[Params] = []
        while self.state == "running" and (rounds is None
                                           or len(globals_seen) < rounds):
            g = self.run_round(train_fn, stats_fn=stats_fn)
            if g is not None:
                globals_seen.append(g)
        return globals_seen

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def _session(self):
        return self.federation.coordinator.sessions[self.session_id]

    @property
    def state(self) -> str:
        return self._session.state.value

    @property
    def round_idx(self) -> int:
        return self._session.round_idx

    def global_params(self) -> Optional[Params]:
        g = self.federation.param_server.get_global(self.session_id)
        return g["params"] if g else None

    def global_version(self) -> int:
        g = self.federation.param_server.get_global(self.session_id)
        return g["version"] if g else 0

    def tree(self):
        return self.federation.coordinator.tree_of(self.session_id)

    def contributors(self) -> list[str]:
        return sorted(self._session.contributors)

    # ------------------------------------------------------------------
    def _client_global_update(self, sid: str, params: Params,
                              version: int) -> None:
        # every participant's client fires this; emit once per version
        if sid == self.session_id and version > self._seen_version:
            self._seen_version = version
            if self.on_global_update:
                self.on_global_update(params, version)

    def _client_round_start(self, sid: str, round_idx: int) -> None:
        if sid == self.session_id and round_idx > self._seen_round:
            self._seen_round = round_idx
            if self.on_round_start:
                self.on_round_start(round_idx)


class FleetSession(FederatedSession):
    """Round loop over ``CohortClient`` endpoints (fleet-scale mode).

    The handle keeps the ``FederatedSession`` surface (state/round
    introspection, ``run``, scenario compatibility: cohorts register in
    ``participants`` so partitions/flaky links key on cohort ids), but the
    round loop trains struct-of-arrays parameter banks and publishes
    through each cohort's batched data plane.  Per-cohort member order is
    globally sorted, so a single-cohort fleet replays an individual-client
    federation bit-for-bit (see core/cohort.py).
    """

    def __init__(self, federation: Federation, session_id: str,
                 model_name: str, strategy: AggregationStrategy):
        super().__init__(federation, session_id, model_name, strategy)
        self.cohorts: dict = {}          # cohort_id -> CohortClient

    def _admit_cohort(self, co) -> None:
        if co.client_id in self.cohorts:
            return
        self.cohorts[co.client_id] = co
        # scenario events and report plumbing see the cohort endpoint as a
        # participant (it IS an SDFLMQClient); the overridden round loop
        # never iterates participants, so the two views don't collide
        self._admit(co)

    def member_count(self) -> int:
        return sum(len(co.active) for co in self.cohorts.values())

    def drop_members(self, cohort_id: str, member_ids) -> None:
        """Member-level churn: fronted logical ids leave mid-run (one
        batched RPC + one coordinator rearrangement per cohort)."""
        self.cohorts[cohort_id].drop_members(self.session_id, member_ids)
        self.federation.deliver()

    def run_round_async(self, train_fn: TrainFn,
                        stats_fn: Optional[Callable] = None) -> int:
        """Train every cohort's bank, replay the aggregation schedule, and
        report readiness — one batched message per cohort.  ``train_fn``
        keeps the individual-session signature ``(member_id, start_params,
        round_idx) -> (params, n_samples)``."""
        rnd = self.round_idx
        base = self.global_params()
        if base is None:
            base = self._initial
        sid = self.session_id
        for co_id, co in sorted(self.cohorts.items()):
            if sid not in co.banks:
                assert base is not None, "fleet round 0 needs initial_params"
                co.set_bank(sid, base)
            co.train_members(sid,
                             lambda cid, start: train_fn(cid, start, rnd))
        for co_id, co in sorted(self.cohorts.items()):
            co.run_local_round(sid)
        for co_id, co in sorted(self.cohorts.items()):
            co.signal_ready_all(sid)
        return rnd

    def run_round_vectorized(self, train_fn: Callable,
                             stats_fn: Optional[Callable] = None) -> int:
        """Fleet-scale round: ``train_fn(bank_data, weights, global_params)
        -> (bank_data, weights)`` updates a cohort's whole struct-of-arrays
        bank in ONE call (feed it ``fl_step.build_cohort_local_step`` output
        or plain numpy ufuncs over the leading member axis) — no per-member
        Python dispatch.  Aggregation/readiness are identical to
        ``run_round_async``; drain with ``federation.deliver()``."""
        rnd = self.round_idx
        base = self.global_params()
        if base is None:
            base = self._initial
        sid = self.session_id
        for co_id, co in sorted(self.cohorts.items()):
            if sid not in co.banks:
                assert base is not None, "fleet round 0 needs initial_params"
                co.set_bank(sid, base)
            co.train_vectorized(sid, train_fn)
        for co_id, co in sorted(self.cohorts.items()):
            co.run_local_round(sid)
        for co_id, co in sorted(self.cohorts.items()):
            co.signal_ready_all(sid)
        return rnd
