"""Real-MQTT implementation of the ``repro_torch.api.transport.Transport`` protocol.

:class:`PahoTransport` runs the federation's control and model planes over
an actual MQTT 3.1.1 broker — the bundled
:class:`repro_torch.api.mini_broker.MiniBroker`, a local Mosquitto, or a managed
EMQX/HiveMQ endpoint — while ``Federation`` / ``AsyncFederatedSession``
run unchanged on top.  Three pieces make that possible:

**A connection pool, one MQTT connection per logical client id.**
``connect(client_id, ...)`` opens a dedicated broker connection (so LWT,
per-sender FIFO ordering, and per-client subscriptions behave exactly as
they do against ``SimBroker``), and ``publish(..., sender=cid)`` rides that
client's connection.  The underlying MQTT client is `paho-mqtt
<https://pypi.org/project/paho-mqtt/>`_ when the ``repro[mqtt]`` extra is
installed, with a bundled pure-stdlib fallback (``backend="builtin"``)
that speaks the same MQTT 3.1.1 subset — CI and air-gapped machines need
no wheel to exercise the real-network path.

**A background-thread → SimClock-safe delivery bridge.**  Network threads
never call application handlers.  Inbound PUBLISHes land in a thread-safe
inbox; ``settle()`` (or the clock source installed by ``attach_clock``)
dispatches them on the caller's thread, so every coordinator/client
callback runs exactly where SimBroker would have run it.  A
``clock.run_until_idle()`` — the facade's "drain everything" primitive —
transparently includes real network traffic.

**A flush-barrier quiescence protocol.**  "Drained" against a real broker
means *no message is in flight anywhere*, which a timed sleep can only
approximate.  Every connection subscribes to a private marker topic
(``$flush/<client id>`` by default — a ``$``-topic, so application
wildcard subscriptions never see it [MQTT-4.7.2-1]).  A barrier round
publishes a marker on **every** connection and waits for each echo; MQTT's
per-connection FIFO guarantees the broker has routed everything published
before the marker, and anything routed concurrently is observably on some
socket by the *next* round.  Two consecutive barrier rounds that dispatch
nothing therefore prove quiescence — deterministically, with no
timing-dependent grace window.  Brokers that reject ``$``-topic publishes
(some managed deployments) are detected — a barrier timeout before any
echo was ever observed — and the transport degrades to a timed-grace
settle; a timeout after echoes have worked is treated as transient and
the barrier retried.

Example (hermetic, against the bundled mini-broker)::

    from repro_torch.api import Federation
    from repro_torch.api.mini_broker import MiniBroker
    from repro_torch.api.mqtt_transport import PahoTransport

    broker = MiniBroker(port=0).start()
    fed = Federation(transport=PahoTransport(port=broker.port))
    ...                       # identical Federation code from here on
    fed.close()
    broker.stop()

What does *not* transfer from the simulators: ``LatencyTransport``'s
partition/drop modeling applies to *outbound* publishes only (inbound
frames arrive from a real socket and are delivered as-is), and multi-part
retained payloads replay only their final part to late subscribers — size
retained topics under ``max_batch_bytes`` (see ``docs/deployment.md``).
"""
from __future__ import annotations

import queue
import random
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from repro_torch.api.mini_broker import (CONNACK, CONNECT, DISCONNECT, PINGREQ,
                                   PUBACK, PUBLISH, SUBACK, SUBSCRIBE,
                                   UNSUBACK, UNSUBSCRIBE, ProtocolError,
                                   _Cursor, encode_utf8, packet,
                                   publish_packet)
from repro_torch.core.broker import Message

try:                                    # optional extra: repro[mqtt]
    import paho.mqtt.client as _paho
except Exception:                       # pragma: no cover - env dependent
    _paho = None


def paho_available() -> bool:
    """Whether the optional ``paho-mqtt`` wheel is importable."""
    return _paho is not None


# ---------------------------------------------------------------------------
# MQTT client backends: one socket, one reader thread, same tiny surface
# ---------------------------------------------------------------------------

_INFLIGHT_LIMIT = 2048          # unacked QoS-1 publishes kept for retransmit


class _BuiltinClient:
    """Bundled MQTT 3.1.1 client (stdlib only): blocking writes under a
    lock, a reader thread that parses inbound packets and forwards
    PUBLISHes to ``on_message(topic, payload, qos, retain, dup)``.
    SUBSCRIBE / UNSUBSCRIBE block until the broker acks, so a subscription
    is live (broker-side) when the call returns — matching SimBroker's
    synchronous semantics.

    At-least-once sending: every QoS-1 publish enters an in-flight window
    (ordered by send) and leaves it on PUBACK; ``reconnect()`` re-dials,
    resumes or rebuilds the session (re-SUBSCRIBE when the broker reports
    no stored session), and retransmits the window with the DUP flag —
    same packet ids, original order, so per-sender FIFO survives the
    outage."""

    def __init__(self, client_id: str):
        self.client_id = client_id
        self.on_message: Callable = lambda *a: None
        # fired from the dying reader thread on an UNEXPECTED connection
        # loss (never on a deliberate disconnect) — the transport's
        # reconnect machinery hangs off this
        self.on_disconnect_cb: Optional[Callable] = None
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._wlock = threading.Lock()
        # mid allocation, the ack table, and the in-flight window are
        # shared with the reader thread and with concurrent app/timer
        # threads — all mutations go through _mid_lock
        self._mid_lock = threading.Lock()
        self._mid = 0
        self._acks: dict[int, threading.Event] = {}
        self._inflight: "OrderedDict[int, tuple]" = OrderedDict()
        self._subs: dict[str, int] = {}       # filter -> qos (for resume)
        self._reader: Optional[threading.Thread] = None
        self._reader_dead = False
        self._pinger: Optional[threading.Thread] = None
        self._stop_ping = threading.Event()
        self._closing = False
        self.session_present = False
        self.dropped_sends = 0
        self.retransmits = 0

    # ---- connection -----------------------------------------------------
    def connect(self, host: str, port: int, will=None,
                keepalive: int = 0, timeout: float = 10.0,
                clean_session: bool = True) -> None:
        self._host, self._port, self._will = host, port, will
        self._keepalive, self._timeout = keepalive, timeout
        self._clean_session = clean_session
        self._dial()

    def _dial(self) -> None:
        self._sock = socket.create_connection((self._host, self._port),
                                              timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        flags = 0x02 if self._clean_session else 0x00
        body = encode_utf8("MQTT") + bytes((4,))
        tail = encode_utf8(self.client_id)
        will = self._will
        if will is not None:
            flags |= 0x04 | ((will.qos & 0x03) << 3) \
                | (0x20 if getattr(will, "retain", False) else 0)
            payload = bytes(will.payload)
            tail += encode_utf8(will.topic)
            tail += len(payload).to_bytes(2, "big") + payload
        body += bytes((flags,)) + self._keepalive.to_bytes(2, "big") + tail
        self._send(packet(CONNECT, 0, body))
        ptype, _, ack = self._read_packet()
        if ptype != CONNACK or ack[1] != 0:
            raise ConnectionError(f"CONNECT refused: {ack!r}")
        self.session_present = bool(ack[0] & 0x01)
        self._sock.settimeout(None)
        self._reader_dead = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"mqtt-{self.client_id}",
                                        daemon=True)
        self._reader.start()
        if self._keepalive > 0:
            # the CONNECT advertised a keepalive: a spec-compliant broker
            # drops the connection (and fires the LWT) after 1.5x that
            # interval of silence, so honor it with a PINGREQ heartbeat
            self._pinger = threading.Thread(
                target=self._ping_loop, args=(self._keepalive / 2.0,),
                name=f"mqtt-ping-{self.client_id}", daemon=True)
            self._pinger.start()

    @property
    def connected(self) -> bool:
        return (self._sock is not None and not self._reader_dead
                and not self._closing)

    def reconnect(self, retransmit: bool = True) -> bool:
        """One reconnect attempt.  On success the session is live again:
        subscriptions re-established when the broker kept no state (the
        SUBACK round-trip completes before this returns), and — unless the
        caller defers it — the QoS-1 in-flight window retransmitted (DUP,
        same packet ids, send order).  Returns ``False`` on any failure —
        caller backs off."""
        if self._closing:
            return False
        self._stop_ping.set()               # orphan the old ping thread
        self._stop_ping = threading.Event()
        with self._mid_lock:
            # stale SUBACK waiters were woken by the dying reader; their
            # mids must not capture acks of the new session
            self._acks.clear()
        try:
            self._dial()
            if not self.session_present:
                for filt, q in list(self._subs.items()):
                    self.subscribe(filt, qos=q)
            if retransmit:
                self.retransmit_inflight()
            return True
        except (ConnectionError, OSError, TimeoutError, ProtocolError):
            return False

    def retransmit_inflight(self) -> None:
        """Replay every unacked QoS-1 publish (DUP, original packet ids,
        send order).  A send failure leaves the rest in the window — the
        next reconnect replays them again."""
        with self._mid_lock:
            pending = list(self._inflight.items())
        for mid, (topic, payload, q, retain) in pending:
            self.retransmits += 1
            try:
                self._send(publish_packet(topic, payload, q, retain, mid,
                                          dup=True))
            except (ConnectionError, OSError):
                return

    def _ping_loop(self, interval: float) -> None:
        while not self._stop_ping.wait(interval):
            try:
                self._send(packet(PINGREQ, 0))
            except (ConnectionError, OSError):
                return

    def disconnect(self, graceful: bool = True) -> None:
        """Graceful sends DISCONNECT (no LWT); abrupt just kills the socket
        — the broker observes a network failure and fires the LWT."""
        self._closing = True
        self._stop_ping.set()
        sock, self._sock = self._sock, None
        if sock is None:
            return
        try:
            if graceful:
                with self._wlock:
                    sock.sendall(packet(DISCONNECT, 0))
        except OSError:
            pass
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()
        if self._reader is not None and \
                self._reader is not threading.current_thread():
            self._reader.join(timeout=5.0)

    # ---- MQTT ops -------------------------------------------------------
    def subscribe(self, topic_filter: str, qos: int = 0,
                  timeout: float = 10.0) -> None:
        # cached first: an offline subscribe is re-established on reconnect
        self._subs[topic_filter] = qos
        mid, ev = self._next_mid()
        body = mid.to_bytes(2, "big") + encode_utf8(topic_filter) \
            + bytes((qos & 0x03,))
        self._send(packet(SUBSCRIBE, 0x02, body))
        if not ev.wait(timeout):
            raise TimeoutError(f"SUBACK timeout for {topic_filter!r}")
        self._check_alive(f"SUBSCRIBE {topic_filter!r}")

    def unsubscribe(self, topic_filter: str, timeout: float = 10.0) -> None:
        self._subs.pop(topic_filter, None)
        mid, ev = self._next_mid()
        self._send(packet(UNSUBSCRIBE, 0x02,
                          mid.to_bytes(2, "big") + encode_utf8(topic_filter)))
        if not ev.wait(timeout):
            raise TimeoutError(f"UNSUBACK timeout for {topic_filter!r}")
        self._check_alive(f"UNSUBSCRIBE {topic_filter!r}")

    def _check_alive(self, what: str) -> None:
        # the reader's death wakes every ack waiter so nothing hangs; a
        # waiter woken that way must fail, not report a phantom ack
        if self._reader_dead and not self._closing:
            raise ConnectionError(
                f"{self.client_id}: connection lost during {what}")

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False) -> None:
        payload = bytes(payload)
        qos = min(qos, 1)
        mid = 0
        if qos > 0:
            with self._mid_lock:
                mid = self._next_mid_locked()
                # window entry BEFORE the send: a socket death mid-write
                # still leaves the frame eligible for retransmit
                self._inflight[mid] = (topic, payload, qos, retain)
                while len(self._inflight) > _INFLIGHT_LIMIT:
                    self._inflight.popitem(last=False)
                    self.dropped_sends += 1
        try:
            self._send(publish_packet(topic, payload, qos, retain, mid))
        except (ConnectionError, OSError):
            if qos == 0:
                self.dropped_sends += 1   # fire-and-forget: legitimately lost
                raise
            # QoS 1 while offline: stays in the window, goes out on reconnect

    # ---- internals ------------------------------------------------------
    def _next_mid_locked(self) -> int:
        # caller holds _mid_lock; skip ids still owned by an unacked
        # publish or a pending SUB/UNSUB ack
        while True:
            self._mid = (self._mid % 0xFFFF) + 1
            if self._mid not in self._inflight and self._mid not in self._acks:
                return self._mid

    def _next_mid(self) -> tuple[int, threading.Event]:
        with self._mid_lock:
            mid = self._next_mid_locked()
            ev = self._acks[mid] = threading.Event()
        return mid, ev

    def _send(self, frame: bytes) -> None:
        sock = self._sock
        if sock is None:
            raise ConnectionError(f"{self.client_id}: not connected")
        with self._wlock:
            sock.sendall(frame)

    def _read_packet(self) -> tuple[int, int, bytes]:
        first = self._rfile.read(1)
        if not first:
            raise ConnectionError("EOF")
        length, mult = 0, 1
        for _ in range(4):
            b = self._rfile.read(1)
            if not b:
                raise ConnectionError("EOF")
            length += (b[0] & 0x7F) * mult
            if not b[0] & 0x80:
                break
            mult *= 128
        else:
            raise ProtocolError("bad remaining-length varint")
        body = self._rfile.read(length) if length else b""
        if len(body) != length:
            raise ConnectionError("EOF")
        return first[0] >> 4, first[0] & 0x0F, body

    def _read_loop(self) -> None:
        try:
            while True:
                ptype, flags, body = self._read_packet()
                if ptype == PUBLISH:
                    cur = _Cursor(body)
                    qos = (flags >> 1) & 0x03
                    topic = cur.utf8()
                    mid = cur.u16() if qos else 0
                    payload = cur.rest()
                    if qos:
                        self._send(packet(PUBACK, 0, mid.to_bytes(2, "big")))
                    self.on_message(topic, payload, qos, bool(flags & 0x01),
                                    bool(flags & 0x08))
                elif ptype in (SUBACK, UNSUBACK):
                    with self._mid_lock:
                        ev = self._acks.pop(
                            int.from_bytes(body[:2], "big"), None)
                    if ev is not None:
                        ev.set()
                elif ptype == PUBACK:
                    with self._mid_lock:
                        self._inflight.pop(
                            int.from_bytes(body[:2], "big"), None)
                # PINGRESP: heartbeat bookkeeping only
        except (ConnectionError, OSError, ValueError, ProtocolError):
            pass                      # socket died (or we closed it)
        finally:
            self._reader_dead = True  # flag first: woken waiters must fail
            with self._mid_lock:
                waiters = list(self._acks.values())
            for ev in waiters:
                ev.set()              # unblock anyone waiting on an ack
            cb = self.on_disconnect_cb
            if cb is not None and not self._closing:
                cb()


class _PahoClient:
    """paho-mqtt adapter presenting the same surface as ``_BuiltinClient``
    (requires the ``repro[mqtt]`` extra).  Works with paho 1.x and 2.x.

    Reconnection rides paho's own network loop (``reconnect_delay_set``
    gives it the transport's backoff bounds; paho retransmits its QoS-1
    in-flight window itself).  This adapter re-establishes subscriptions
    when the broker reports no stored session and surfaces connection
    state through ``on_disconnect_cb`` / ``on_reconnect_cb``."""

    def __init__(self, client_id: str, clean_session: bool = True):
        assert _paho is not None, "paho-mqtt is not installed"
        self.client_id = client_id
        self.on_message: Callable = lambda *a: None
        self.on_disconnect_cb: Optional[Callable] = None
        self.on_reconnect_cb: Optional[Callable] = None   # (session_present)
        self.auto_reconnect = False
        self.session_present = False
        try:            # paho >= 2.0 requires an explicit callback version
            c = _paho.Client(_paho.CallbackAPIVersion.VERSION1,
                             client_id=client_id,
                             clean_session=clean_session)
        except AttributeError:          # paho 1.x
            c = _paho.Client(client_id=client_id,
                             clean_session=clean_session)
        c.on_message = self._on_message
        c.on_connect = self._on_connect
        c.on_disconnect = self._on_disconnect
        c.on_subscribe = self._on_ack
        c.on_unsubscribe = self._on_ack
        self._c = c
        self._connected = threading.Event()
        self._connect_rc = 0
        self._first_connect = True
        self._subs: dict[str, int] = {}
        self._ack_lock = threading.Lock()
        self._acks: dict[int, threading.Event] = {}
        self._early_acks: set[int] = set()

    @property
    def connected(self) -> bool:
        return bool(self._c.is_connected())

    def configure_reconnect(self, min_delay_s: float,
                            max_delay_s: float) -> None:
        self.auto_reconnect = True
        # paho's backoff is integer seconds, doubling from min to max
        self._c.reconnect_delay_set(
            min_delay=max(1, int(min_delay_s)),
            max_delay=max(1, int(max_delay_s)))

    # paho callbacks (network-loop thread)
    def _on_message(self, _c, _ud, msg) -> None:
        self.on_message(msg.topic, bytes(msg.payload), msg.qos, msg.retain,
                        bool(getattr(msg, "dup", False)))

    def _on_connect(self, _c, _ud, flags, rc=0, *_rest) -> None:
        # rc is an int in paho 1.x and a ReasonCode in 2.x
        self._connect_rc = int(getattr(rc, "value", rc))
        if isinstance(flags, dict):
            self.session_present = bool(flags.get("session present", 0))
        else:
            self.session_present = bool(getattr(flags, "session_present", 0))
        if self._connect_rc == 0 and not self._first_connect:
            if not self.session_present:
                for filt, q in list(self._subs.items()):
                    self._c.subscribe(filt, q)
            cb = self.on_reconnect_cb
            if cb is not None:
                cb(self.session_present)
        self._first_connect = False
        self._connected.set()

    def _on_disconnect(self, _c, _ud, rc=0, *_rest) -> None:
        rc = int(getattr(rc, "value", rc))
        if rc == 0:
            return                       # deliberate disconnect
        if not self.auto_reconnect:
            # stop paho's implicit retry loop: mark the teardown deliberate
            try:
                self._c.disconnect()
            except Exception:
                pass
        cb = self.on_disconnect_cb
        if cb is not None:
            cb()

    def _on_ack(self, _c, _ud, mid, *_rest) -> None:
        # the SUBACK can beat the caller to registering its event (paho
        # only reveals the mid AFTER the packet is on the wire) — remember
        # early acks so _await_ack never waits for one already received
        with self._ack_lock:
            ev = self._acks.pop(mid, None)
            if ev is None:
                self._early_acks.add(mid)
            else:
                ev.set()

    def _await_ack(self, rc: int, mid, what: str, timeout: float) -> None:
        if rc != 0 or mid is None:
            raise ConnectionError(f"{self.client_id}: {what} failed rc={rc}")
        ev = threading.Event()
        with self._ack_lock:
            if mid in self._early_acks:
                self._early_acks.discard(mid)
                return
            self._acks[mid] = ev
        if not ev.wait(timeout):
            raise TimeoutError(f"{what} ack timeout")

    def connect(self, host: str, port: int, will=None,
                keepalive: int = 60, timeout: float = 10.0,
                clean_session: bool = True) -> None:
        # clean_session is fixed at Client construction for paho; the
        # parameter is accepted for surface parity with _BuiltinClient
        if will is not None:
            self._c.will_set(will.topic, bytes(will.payload), will.qos,
                             getattr(will, "retain", False))
        self._c.connect(host, port, keepalive=max(keepalive, 10))
        self._c.loop_start()
        if not self._connected.wait(timeout):
            raise ConnectionError(f"{self.client_id}: CONNACK timeout")
        if self._connect_rc != 0:
            self._c.loop_stop()
            raise ConnectionError(
                f"{self.client_id}: CONNECT refused rc={self._connect_rc}")

    def disconnect(self, graceful: bool = True) -> None:
        if graceful:
            self._c.disconnect()
            self._c.loop_stop()
        else:
            # abrupt death: stop the network loop first (so paho cannot
            # reconnect), then kill the socket — the broker fires the LWT
            self._c.loop_stop()
            sock = self._c.socket()
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                sock.close()

    def subscribe(self, topic_filter: str, qos: int = 0,
                  timeout: float = 10.0) -> None:
        self._subs[topic_filter] = qos
        rc, mid = self._c.subscribe(topic_filter, qos)
        self._await_ack(rc, mid, f"SUBSCRIBE {topic_filter!r}", timeout)

    def unsubscribe(self, topic_filter: str, timeout: float = 10.0) -> None:
        self._subs.pop(topic_filter, None)
        rc, mid = self._c.unsubscribe(topic_filter)
        try:
            self._await_ack(rc, mid, f"UNSUBSCRIBE {topic_filter!r}", timeout)
        except TimeoutError:
            pass                # UNSUBACK loss is benign; don't hard-fail

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False) -> None:
        self._c.publish(topic, bytes(payload), qos=min(qos, 1), retain=retain)


# ---------------------------------------------------------------------------
# the Transport implementation
# ---------------------------------------------------------------------------

class _Endpoint:
    """Pool entry: one logical client = one broker connection + its
    application callback + barrier/reconnect bookkeeping."""

    __slots__ = ("client_id", "client", "on_message", "markers",
                 "connected", "closed", "failed", "reconnecting",
                 "generation", "clean_session")

    def __init__(self, client_id: str, client, on_message: Callable,
                 clean_session: bool = True):
        self.client_id = client_id
        self.client = client
        self.on_message = on_message
        self.markers = threading.Semaphore(0)   # flush-marker echoes
        self.connected = False       # live broker connection right now?
        self.closed = False          # deliberately disconnected — stay down
        self.failed = False          # reconnect budget exhausted
        self.reconnecting = False    # a backoff loop is running for this ep
        self.generation = 0          # bumps per outage: keys the jitter rng
        self.clean_session = clean_session


class PahoTransport:
    """``repro_torch.api.transport.Transport`` over a real MQTT broker.

    Parameters:
        host, port:     broker endpoint (e.g. a started ``MiniBroker``'s
                        ``.port``, or 1883 for a local Mosquitto).
        backend:        ``"auto"`` (paho if installed, else builtin),
                        ``"paho"``, or ``"builtin"``.
        flush_root:     marker-topic root for the quiescence barrier.  The
                        default ``$flush`` is invisible to application
                        wildcard subscriptions; point it at a normal topic
                        for brokers that reject ``$``-topic publishes.
        settle_grace_s: per-wait window for the timed-grace fallback (only
                        used when the barrier is unavailable).
        settle_timeout_s: hard ceiling for one ``settle()`` call.
        keepalive_s:    MQTT keepalive (0 disables — fine for the bundled
                        mini-broker, which never expires connections).
        clean_session:  transport-wide default for ``connect()``;
                        ``False`` makes every pooled connection a
                        persistent MQTT session (broker keeps
                        subscriptions + queues QoS 1 across outages).
        reconnect:      ``"auto"`` (reconnect iff ``clean_session=False``
                        — resumption is what makes it lossless), ``True``,
                        or ``False``.  Dropped connections are re-dialed
                        under bounded exponential backoff with jitter;
                        the QoS-1 in-flight window is retransmitted (DUP)
                        and subscriptions restored when the broker kept no
                        session.
        backoff_*:      backoff schedule: delay starts at ``backoff_base_s``,
                        multiplies by ``backoff_factor`` per failure, is
                        capped at ``backoff_max_s``, and each wait is
                        stretched by up to ``backoff_jitter`` (relative,
                        from a per-(client, outage) seeded rng — the delay
                        sequence is deterministic for a given seed).
        max_reconnects: attempts per outage before the endpoint is marked
                        failed (``None`` = unbounded).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 1883,
                 backend: str = "auto", name: Optional[str] = None,
                 flush_root: str = "$flush",
                 settle_grace_s: float = 0.05,
                 settle_timeout_s: float = 60.0,
                 keepalive_s: int = 0,
                 connect_timeout_s: float = 10.0,
                 clean_session: bool = True,
                 reconnect: Any = "auto",
                 backoff_base_s: float = 0.05,
                 backoff_factor: float = 2.0,
                 backoff_max_s: float = 2.0,
                 backoff_jitter: float = 0.1,
                 max_reconnects: Optional[int] = None,
                 reconnect_seed: int = 0):
        assert backend in ("auto", "paho", "builtin"), backend
        assert reconnect in ("auto", True, False), reconnect
        if backend == "auto":
            backend = "paho" if paho_available() else "builtin"
        if backend == "paho" and not paho_available():
            raise ModuleNotFoundError(
                "paho-mqtt is not installed — pip install 'repro[mqtt]' "
                "or pass backend='builtin'")
        self.backend = backend
        self.host = host
        self.port = port
        self.name = name or f"mqtt://{host}:{port}"
        self.flush_root = flush_root
        self.settle_grace_s = settle_grace_s
        self.settle_timeout_s = settle_timeout_s
        self.keepalive_s = keepalive_s
        self.connect_timeout_s = connect_timeout_s
        self.clean_session = clean_session
        self.reconnect = reconnect
        self.backoff_base_s = backoff_base_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.max_reconnects = max_reconnects
        self.reconnect_seed = reconnect_seed
        self._endpoints: dict[str, _Endpoint] = {}
        self._lock = threading.Lock()
        # entries are (endpoint, message): keyed on the endpoint OBJECT so
        # a clean-session reconnect never sees the old session's frames
        self._inbox: "queue.SimpleQueue[tuple[_Endpoint, Message]]" = \
            queue.SimpleQueue()
        self._clock = None
        self._barrier_ok = True
        self._barrier_seen = False      # any marker echo ever received?
        self._mids = 0
        # optional telemetry facade (repro_torch.obs.Telemetry); set by
        # Federation(metrics=...).  None = zero-overhead default.
        self.obs = None
        # counters for sys_stats
        self.publishes = 0
        self.received = 0
        self.dispatched = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.barrier_rounds = 0
        self.connection_drops = 0
        self.reconnects = 0
        self.reconnect_failures = 0
        self.send_failures = 0

    @property
    def reconnect_enabled(self) -> bool:
        if self.reconnect == "auto":
            return not self.clean_session
        return bool(self.reconnect)

    # ---- Transport surface ----------------------------------------------
    def connect(self, client_id: str, on_message: Callable,
                will: Optional[Any] = None,
                clean_session: Optional[bool] = None) -> _Endpoint:
        """Open this client's dedicated broker connection.  ``will`` (any
        object with ``topic``/``payload``/``qos``/``retain``) becomes the
        connection's LWT — published by the *broker* if the connection dies
        without a graceful DISCONNECT.  ``clean_session=None`` uses the
        transport-wide default; ``False`` asks the broker to keep this
        client's session (subscriptions + offline QoS-1 queue) across
        disconnects."""
        clean = self.clean_session if clean_session is None \
            else bool(clean_session)
        old = self._endpoints.get(client_id)
        if old is not None:             # reconnect: old session's subs die
            self.disconnect(client_id, graceful=True)
        cl = (_PahoClient(client_id, clean_session=clean)
              if self.backend == "paho" else _BuiltinClient(client_id))
        ep = _Endpoint(client_id, cl, on_message, clean_session=clean)
        cl.on_message = self._receiver(ep)
        cl.on_disconnect_cb = lambda _ep=ep: self._on_conn_lost(_ep)
        if self.backend == "paho":
            cl.on_reconnect_cb = lambda sp, _ep=ep: self._on_conn_up(_ep, sp)
            if self.reconnect_enabled:
                cl.configure_reconnect(self.backoff_base_s,
                                       self.backoff_max_s)
        cl.connect(self.host, self.port, will=will,
                   keepalive=self.keepalive_s,
                   timeout=self.connect_timeout_s, clean_session=clean)
        ep.connected = True
        cl.subscribe(self._marker_topic(client_id), qos=0)
        with self._lock:
            self._endpoints[client_id] = ep
        return ep

    def disconnect(self, client_id: str, graceful: bool = True) -> None:
        with self._lock:
            ep = self._endpoints.pop(client_id, None)
        if ep is not None:
            ep.closed = True            # stops any reconnect loop for good
            ep.connected = False
            ep.client.disconnect(graceful=graceful)

    def subscribe(self, client_id: str, topic_filter: str,
                  qos: int = 0) -> None:
        try:
            self._endpoint(client_id).client.subscribe(topic_filter, qos=qos)
        except (ConnectionError, OSError):
            if not self.reconnect_enabled:
                raise
            # offline: the client cached the filter; it is re-subscribed
            # (and the broker-side session restored) on reconnect

    def unsubscribe(self, client_id: str, topic_filter: str) -> None:
        ep = self._endpoints.get(client_id)
        if ep is not None:
            try:
                ep.client.unsubscribe(topic_filter)
            except (ConnectionError, OSError):
                if not self.reconnect_enabled:
                    raise

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False, sender: str = "") -> int:
        """Publish on ``sender``'s connection (per-sender FIFO, exactly as
        a fleet of real clients would).  An empty ``sender`` rides a shared
        utility connection.  During an outage, QoS-1 publishes enter the
        client's in-flight window and go out on reconnect; QoS-0 publishes
        are dropped (fire-and-forget semantics) and counted."""
        ep = self._endpoints.get(sender) if sender else None
        if ep is None:
            ep = self._tx_endpoint()
        try:
            ep.client.publish(topic, payload, qos=qos, retain=retain)
        except (ConnectionError, OSError):
            self.send_failures += 1
        self.publishes += 1
        self.bytes_out += len(payload)
        self._mids += 1
        return self._mids

    # ---- reconnect machinery ---------------------------------------------
    def _on_conn_lost(self, ep: _Endpoint) -> None:
        """Unexpected connection loss (network thread).  Marks the endpoint
        down and — for the builtin backend — starts one backoff loop."""
        if ep.closed or not ep.connected:
            return
        ep.connected = False
        self.connection_drops += 1
        if self.obs is not None:
            self.obs.trace("mqtt_connection_lost", client=ep.client_id)
        if not self.reconnect_enabled or self.backend == "paho":
            return                      # paho's loop re-dials on its own
        with self._lock:
            if ep.reconnecting:
                return
            ep.reconnecting = True
        threading.Thread(target=self._reconnect_loop, args=(ep,),
                         name=f"mqtt-reconnect-{ep.client_id}",
                         daemon=True).start()

    def _on_conn_up(self, ep: _Endpoint, session_present: bool) -> None:
        ep.failed = False
        ep.connected = True
        self.reconnects += 1
        if self.obs is not None:
            self.obs.trace("mqtt_reconnected", client=ep.client_id,
                           session_present=bool(session_present))

    def _reconnect_loop(self, ep: _Endpoint) -> None:
        """Bounded exponential backoff with jitter, seeded per (client,
        outage) so the wait sequence is deterministic for a given
        ``reconnect_seed``."""
        rng = random.Random(
            f"{self.reconnect_seed}/{ep.client_id}/{ep.generation}")
        ep.generation += 1
        delay = self.backoff_base_s
        attempts = 0
        try:
            while not ep.closed and self._endpoints.get(ep.client_id) is ep:
                if self.max_reconnects is not None \
                        and attempts >= self.max_reconnects:
                    ep.failed = True
                    self.reconnect_failures += 1
                    if self.obs is not None:
                        self.obs.trace("mqtt_reconnect_failed",
                                       client=ep.client_id,
                                       attempts=attempts)
                    return
                time.sleep(min(delay * (1.0 + self.backoff_jitter
                                        * rng.random()),
                               self.backoff_max_s))
                attempts += 1
                if ep.closed or self._endpoints.get(ep.client_id) is not ep:
                    return
                if ep.client.reconnect(retransmit=False):
                    ep.reconnecting = False
                    self._on_conn_up(ep, ep.client.session_present)
                    if not ep.client.session_present:
                        # amnesiac broker: every peer's subscriptions died
                        # with it.  Retransmitting now would feed frames to
                        # a subscriber-less broker (PUBACKed, routed to
                        # nobody, gone) — hold the window until the rest of
                        # this pool has re-subscribed (bounded, so a peer
                        # that never recovers can't block delivery forever)
                        self._await_pool_recovery()
                    ep.client.retransmit_inflight()
                    return
                delay = min(delay * self.backoff_factor, self.backoff_max_s)
        finally:
            ep.reconnecting = False

    def _await_pool_recovery(self, timeout: Optional[float] = None) -> None:
        deadline = time.monotonic() + (
            timeout if timeout is not None else max(4 * self.backoff_max_s,
                                                    1.0))
        while time.monotonic() < deadline and self._recovery_pending():
            time.sleep(0.005)

    def sys_stats(self) -> dict:
        return {
            "backend": self.backend,
            "broker": f"{self.host}:{self.port}",
            "connections": len(self._endpoints),
            "publishes": self.publishes,
            "received": self.received,
            "dispatched": self.dispatched,
            "pending_dispatch": self.received - self.dispatched,
            "bytes_out": self.bytes_out,
            "bytes_in": self.bytes_in,
            "barrier_rounds": self.barrier_rounds,
            "barrier_supported": self._barrier_ok,
            "connection_drops": self.connection_drops,
            "reconnects": self.reconnects,
            "reconnect_failures": self.reconnect_failures,
            "send_failures": self.send_failures,
            "reconnect_enabled": self.reconnect_enabled,
            "clean_session": self.clean_session,
            # canonical core schema (repro_torch.obs.SYS_CORE), from this
            # transport's perspective: sent = published to the broker,
            # received = delivered by the broker to pooled subscribers
            "messages_sent": self.publishes,
            "messages_received": self.received,
            "bytes_sent": self.bytes_out,
            "bytes_received": self.bytes_in,
        }

    def close(self) -> None:
        """Gracefully disconnect every pooled connection."""
        with self._lock:
            eps, self._endpoints = list(self._endpoints.values()), {}
        for ep in eps:
            ep.closed = True
            ep.connected = False
            ep.client.disconnect(graceful=True)

    def __enter__(self) -> "PahoTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- inbound bridge --------------------------------------------------
    def _receiver(self, ep: _Endpoint) -> Callable:
        marker = self._marker_topic(ep.client_id)

        def on_net_message(topic: str, payload: bytes, qos: int,
                           retain: bool, dup: bool = False) -> None:
            # network-loop thread: never run application code here
            if topic == marker:
                self._barrier_seen = True
                ep.markers.release()
                return
            self.received += 1
            self.bytes_in += len(payload)
            self._inbox.put((ep, Message(topic, payload, qos, retain,
                                         duplicate=dup)))
        return on_net_message

    def _dispatch_one(self, ep: _Endpoint, msg: Message) -> bool:
        self.dispatched += 1
        # frames for a disconnected (or takeover-replaced) session drop:
        # a clean-session reconnect must not inherit the old inbox
        if self._endpoints.get(ep.client_id) is not ep:
            return False
        ep.on_message(msg)
        return True

    def _dispatch_available(self) -> int:
        """Deliver everything currently in the inbox on *this* thread."""
        n = 0
        while True:
            try:
                ep, msg = self._inbox.get_nowait()
            except queue.Empty:
                return n
            if self._dispatch_one(ep, msg):
                n += 1

    def settle(self, block: bool = True,
               timeout: Optional[float] = None) -> int:
        """Dispatch in-flight traffic to the registered callbacks on the
        calling thread; returns the number of messages delivered.

        ``block=False`` drains only what has already arrived.
        ``block=True`` runs flush-barrier rounds (or timed-grace waits if
        the broker rejected the marker topic) until two consecutive rounds
        deliver nothing — i.e. the whole publish/react cascade has
        quiesced."""
        total = self._dispatch_available()
        if not block:
            return total
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.settle_timeout_s)
        quiet = 0
        while quiet < 2:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{self.name}: settle() exceeded its deadline with "
                    f"traffic still flowing")
            n = self._settle_round(deadline)
            if n:
                total += n
                quiet = 0
            elif self._recovery_pending():
                # endpoints are mid-reconnect: frames may still be parked
                # in their in-flight windows, so an empty round proves
                # nothing yet — wait for the backoff loops to finish
                quiet = 0
                time.sleep(min(self.settle_grace_s,
                               max(deadline - time.monotonic(), 0.001)))
            else:
                quiet += 1
        return total

    def _recovery_pending(self) -> bool:
        if not self.reconnect_enabled:
            return False
        with self._lock:
            eps = list(self._endpoints.values())
        return any(not ep.connected and not ep.closed and not ep.failed
                   for ep in eps)

    def _settle_round(self, deadline: float) -> int:
        if self._barrier_ok and self._barrier(deadline):
            return self._dispatch_available()
        # grace fallback: wait a fixed window for anything to arrive
        try:
            ep, msg = self._inbox.get(
                timeout=min(self.settle_grace_s,
                            max(deadline - time.monotonic(), 0.001)))
        except queue.Empty:
            return 0
        # dispatch the probed head directly — re-queuing it would put it
        # behind frames that arrived meanwhile, breaking per-sender FIFO
        n = 1 if self._dispatch_one(ep, msg) else 0
        return n + self._dispatch_available()

    def _barrier(self, deadline: float) -> bool:
        """One flush-barrier round: a marker on every connection, wait for
        every echo.  A timeout before ANY echo was ever observed means the
        broker eats the marker topic — the transport latches into
        timed-grace mode.  A timeout after echoes have worked is treated
        as transient (slow link, tight caller deadline): this settle round
        falls back to the grace wait and the next round retries the
        barrier."""
        with self._lock:
            eps = [ep for ep in self._endpoints.values() if ep.connected]
        if not eps:
            return False
        self.barrier_rounds += 1
        sent = []
        for ep in eps:
            # drain echoes of earlier (timed-out) rounds: a stale token
            # must not satisfy THIS round's happens-before proof
            while ep.markers.acquire(blocking=False):
                pass
            try:
                ep.client.publish(self._marker_topic(ep.client_id), b"",
                                  qos=0)
            except (ConnectionError, OSError):
                continue        # endpoint died mid-round: reconnect handles
            sent.append(ep)
        if not sent:
            return False
        budget = min(5.0, max(deadline - time.monotonic(), 0.001))
        for ep in sent:
            if not ep.markers.acquire(timeout=budget):
                if not self._barrier_seen and ep.connected \
                        and self._endpoints.get(ep.client_id) is ep:
                    self._barrier_ok = False    # broker eats marker topics
                return False
        return True

    # ---- SimClock bridge -------------------------------------------------
    def attach_clock(self, clock) -> None:
        """Install this transport as an external event source on a
        ``SimClock``: any clock drain (``run_until_idle``, ``advance_to``,
        an unheld publish) then also pumps real network traffic, and the
        clock's idle callbacks only fire once the network is quiet.
        ``Federation`` calls this automatically."""
        if self._clock is not None:
            self._clock.remove_source(self._clock_source)
        self._clock = clock
        clock.add_source(self._clock_source)

    def _clock_source(self, block: bool) -> bool:
        if not block:
            return self._dispatch_available() > 0
        if not self._endpoints:
            return False
        return self.settle(block=True) > 0

    # ---- helpers ---------------------------------------------------------
    def _marker_topic(self, client_id: str) -> str:
        return f"{self.flush_root}/{client_id}"

    def _endpoint(self, client_id: str) -> _Endpoint:
        ep = self._endpoints.get(client_id)
        if ep is None:
            raise KeyError(f"unknown client {client_id!r}: connect() first")
        return ep

    def _tx_endpoint(self) -> _Endpoint:
        """Lazy shared utility connection for publishes with no (or a
        not-yet-connected) ``sender`` — matching SimBroker, where
        ``sender`` is routing metadata and needs no session.  Note the
        per-sender FIFO guarantee only holds for publishes issued after
        the sender's own ``connect()``."""
        ep = self._endpoints.get("__tx__")
        if ep is None:
            ep = self.connect("__tx__", lambda msg: None)
        return ep


__all__ = ["PahoTransport", "paho_available"]
