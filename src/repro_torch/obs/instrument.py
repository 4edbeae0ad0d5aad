"""Telemetry facade: binds a registry + tracer to a running federation.

``Federation(metrics=...)`` constructs one :class:`Telemetry` and threads
it through the stack.  Two mechanisms feed it:

* **Pull collectors** (zero hot-path cost): a registered collector walks
  the federation's existing stats surfaces — broker ``sys_stats()`` /
  TopicTrie cache counters, every ``MQTTFC.wire_stats()`` endpoint,
  per-session accumulator arenas and ``peak_acc_bytes``, async admission /
  gossip counters, and coordinator round bookkeeping — and mirrors them
  into labeled gauges at scrape/snapshot time.
* **Push hooks** (one ``if obs is not None`` branch each): control-plane
  event points (round start/complete, deadline cut, contribute, flush,
  mint, gossip, partition, heal, publish/deliver) call
  :meth:`Telemetry.trace`, and latency observations land in histograms
  (:meth:`observe_staleness`, :meth:`observe_round`).

Metric naming: ``sdflmq_<subsystem>_<stat>``; pulled source counters are
exposed as gauges (the source object owns monotonicity).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import Tracer

__all__ = ["Telemetry", "SYS_CORE"]

#: Canonical ``sys_stats()`` core schema every transport backend exposes
#: (SimBroker, LatencyTransport, MiniBroker, PahoTransport).  The metrics
#: layer — and the conformance suite — rely on exactly these names.
SYS_CORE = ("messages_received", "messages_sent", "bytes_received", "bytes_sent")

STALENESS_BUCKETS = (0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0)
ROUND_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Telemetry:
    """One registry + one tracer + the glue that feeds them."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock: Optional[object] = None,
                 trace_capacity: int = 4096) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(clock=clock, maxlen=trace_capacity)
        r = self.registry
        self._events = r.counter(
            "sdflmq_trace_events_total", "Trace events emitted", labels=("kind",))
        self._staleness = r.histogram(
            "sdflmq_async_staleness_versions",
            "Version staleness of async contributions at arrival",
            buckets=STALENESS_BUCKETS)
        self._round_virtual = r.histogram(
            "sdflmq_round_virtual_seconds", "Per-round virtual latency",
            labels=("session",), buckets=ROUND_BUCKETS)
        self._round_wall = r.histogram(
            "sdflmq_round_wall_seconds", "Per-round wall latency",
            labels=("session",), buckets=ROUND_BUCKETS)

    # -- push hooks ------------------------------------------------------
    def trace(self, kind: str, **fields: object) -> None:
        self.tracer.emit(kind, **fields)
        self._events.labels(kind=kind).inc()

    def observe_staleness(self, staleness: float) -> None:
        self._staleness.observe(staleness)

    def observe_round(self, session: str, virtual_s: Optional[float],
                      wall_s: Optional[float]) -> None:
        if virtual_s is not None:
            self._round_virtual.labels(session=session).observe(virtual_s)
        if wall_s is not None:
            self._round_wall.labels(session=session).observe(wall_s)

    # -- pull collectors -------------------------------------------------
    def bind_federation(self, fed: object) -> None:
        """Register a collector mirroring the federation's stats surfaces."""
        reg = self.registry

        def set_numeric(name: str, help: str, value: object, **labels) -> None:
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                return
            g = reg.gauge(name, help, labels=tuple(sorted(labels)))
            (g.labels(**labels) if labels else g).set(value)

        def collect() -> None:
            # Broker / transport ($SYS + latency-sim + trie cache stats).
            stats = fed.transport.sys_stats()
            for k, v in stats.items():
                if k == "per_topic_class" and isinstance(v, dict):
                    for tc, n in v.items():
                        set_numeric("sdflmq_broker_topic_class_messages",
                                    "Messages routed per topic class", n,
                                    topic_class=tc)
                elif k == "links" and isinstance(v, dict):
                    for cid, link in v.items():
                        for lk, lv in link.items():
                            set_numeric(f"sdflmq_link_{lk}",
                                        "Per-client simulated link stat", lv,
                                        client=cid)
                else:
                    set_numeric(f"sdflmq_broker_{k}", "Broker $SYS stat", v)

            # Wire endpoints (coordinator, parameter server, every client).
            endpoints = []
            coord = getattr(fed, "coordinator", None)
            if coord is not None and getattr(coord, "fc", None) is not None:
                endpoints.append((coord.fc.client_id, coord.fc))
            ps = getattr(fed, "param_server", None)
            if ps is not None and getattr(ps, "fc", None) is not None:
                endpoints.append(("param_server", ps.fc))
            for cid, cl in getattr(fed, "clients", {}).items():
                endpoints.append((cid, cl.fc))
            for cid, fc in endpoints:
                for k, v in fc.wire_stats().items():
                    set_numeric(f"sdflmq_wire_{k}", "MQTTFC wire stat", v,
                                client=cid)

            # Codec stats (uplink bytes, error-feedback residual, top-k
            # density).  Exported for every client even with codecs off —
            # the series sit at their defaults so dashboards and the CI
            # scrape gate always see them.
            for cid, cl in getattr(fed, "clients", {}).items():
                cs = getattr(cl, "codec_stats", None)
                if cs is None:
                    continue
                codec = getattr(cl, "uplink_codec", None) or "none"
                set_numeric("sdflmq_wire_uplink_bytes",
                            "Model-update uplink payload bytes shipped",
                            cs.get("uplink_bytes", 0), client=cid, codec=codec)
                set_numeric("sdflmq_codec_ef_residual_norm",
                            "Error-feedback residual L2 norm after last uplink",
                            cs.get("ef_residual_norm", 0.0), client=cid)
                set_numeric("sdflmq_topk_density",
                            "Fraction of update entries shipped last uplink",
                            cs.get("topk_density", 1.0), client=cid)

            # Per-duty accumulator arenas + async counters (client contexts).
            for cid, cl in getattr(fed, "clients", {}).items():
                for sid, ctx in cl.models.sessions.items():
                    acc_bytes = sum(a.alloc_bytes for a in ctx.accs.values())
                    set_numeric("sdflmq_acc_alloc_bytes",
                                "Live accumulator arena bytes", acc_bytes,
                                client=cid, session=sid)
                    set_numeric("sdflmq_acc_peak_bytes",
                                "Peak accumulator arena bytes",
                                ctx.peak_acc_bytes, client=cid, session=sid)
                    set_numeric("sdflmq_sync_stale_dropped",
                                "Stale sync contributions dropped",
                                ctx.stale_dropped, client=cid, session=sid)
                    for k in ("async_admitted", "async_rejected",
                              "gossip_sent", "gossip_adopts",
                              "gossip_merges", "site_updates"):
                        set_numeric(f"sdflmq_{k}", "Async-FL counter",
                                    getattr(ctx, k, 0), client=cid, session=sid)
                    set_numeric("sdflmq_defense_rejected_updates",
                                "Updates this aggregator rejected (defense)",
                                getattr(ctx, "defense_rejected", 0),
                                client=cid, session=sid)

            # Coordinator control-plane bookkeeping.
            if coord is not None:
                for k in ("rearrangement_messages", "arrangement_messages",
                          "deadline_cuts"):
                    set_numeric(f"sdflmq_coordinator_{k}",
                                "Coordinator control-plane counter",
                                getattr(coord, k, 0))
                set_numeric("sdflmq_roles_rotations",
                            "Aggregator-set rotations (moving-target defense)",
                            getattr(coord, "roles_rotations", 0))
                for sid, s in coord.sessions.items():
                    set_numeric("sdflmq_coordinator_round",
                                "Current round index", s.round_idx, session=sid)
                    # trust scores are exported for every contributor even
                    # with the defense off (they sit at the default 1.0),
                    # so dashboards and the CI scrape gate always see the
                    # series
                    for cid, st in s.contributors.items():
                        set_numeric("sdflmq_defense_reputation",
                                    "Coordinator trust score per client",
                                    getattr(st, "reputation", 1.0),
                                    client=cid, session=sid)

            # Clock.
            clock = getattr(fed, "clock", None)
            if clock is not None:
                set_numeric("sdflmq_clock_virtual_seconds",
                            "Simulated virtual time", clock.now)
                set_numeric("sdflmq_clock_pending_events",
                            "Events waiting in the simulated clock",
                            clock.pending())

            # Tracer ring health.
            set_numeric("sdflmq_trace_ring_dropped",
                        "Trace events evicted from the bounded ring",
                        self.tracer.dropped)

        reg.register_collector(collect)
