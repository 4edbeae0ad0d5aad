"""Hermetic in-process MQTT 3.1.1 mini-broker (asyncio TCP).

The paper's deployment story assumes a real MQTT broker (Mosquitto, EMQX,
HiveMQ, ...) between the coordinator and the fleet.  CI can't assume
external infrastructure, so this module bundles a small broker speaking
actual MQTT 3.1.1 over TCP — enough of the spec for everything SDFLMQ
exercises, so ``repro_torch.api.mqtt_transport.PahoTransport`` (and any stock
MQTT client) is testable with zero setup:

  * CONNECT / CONNACK (protocol level 4, clean-session, client takeover),
  * PUBLISH QoS 0 and QoS 1 (+ PUBACK both directions),
  * SUBSCRIBE / SUBACK, UNSUBSCRIBE / UNSUBACK with ``+``/``#`` wildcards
    and the MQTT-4.7.2-1 ``$``-topic exclusion rule,
  * retained messages (replayed to late subscribers, cleared by an empty
    retained publish),
  * last-will testament, published when a connection dies without a
    DISCONNECT packet (and on session takeover, per [MQTT-3.1.4-2]),
  * PINGREQ / PINGRESP, DISCONNECT.

Topic dispatch reuses :class:`repro_torch.core.broker.TopicTrie` — the same
routing structure (and therefore the same wildcard semantics) as
``SimBroker``, so the two backends can be certified against one
conformance contract (``tests/transport_conformance.py``).

Persistent sessions are supported: a CONNECT with ``clean_session=0``
stores the session — subscriptions survive the connection, QoS-1 messages
routed while the client is offline are queued (bounded), unacked PUBLISHes
are redelivered with the DUP flag (same packet ids) on resume, and the
CONNACK reports ``session present``.  MQTT 5-style shared subscriptions
(``$share/<group>/<filter>``) round-robin each message across the group.
Session state lives in process memory only — a broker restart starts
empty, exactly like an unpersisted Mosquitto.

Not implemented (rejected or degraded cleanly): QoS 2 (granted as QoS 1)
and authentication (username/password bytes are parsed and ignored).

The broker runs its asyncio loop on a daemon thread; ``start()`` returns
once the socket is bound (``port=0`` picks a free port, exposed as
``.port``)::

    from repro_torch.api.mini_broker import MiniBroker

    broker = MiniBroker(port=0).start()
    ...  # point any MQTT client at 127.0.0.1:broker.port
    broker.stop()

Or standalone, for a `mosquitto`-style workflow::

    python -m repro_torch.api.mini_broker --port 1883
"""
from __future__ import annotations

import argparse
import asyncio
import threading
from collections import OrderedDict, defaultdict, deque
from typing import Optional

from repro_torch.core.broker import (Message, RetainedSeq, TopicTrie, parse_share,
                               retain_message, topic_matches)

# MQTT 3.1.1 control-packet types (spec §2.2.1)
CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14

_MAX_REMAINING_LEN = 268_435_455      # spec §2.2.3: 4 varint bytes


class ProtocolError(Exception):
    """Malformed or unsupported MQTT packet — the connection is closed."""


# ---------------------------------------------------------------------------
# wire encoding helpers
# ---------------------------------------------------------------------------

def encode_varint(n: int) -> bytes:
    """MQTT remaining-length varint (7 bits per byte, LSB first)."""
    if not 0 <= n <= _MAX_REMAINING_LEN:
        raise ProtocolError(f"remaining length out of range: {n}")
    out = bytearray()
    while True:
        n, b = divmod(n, 128)
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def encode_utf8(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ProtocolError("utf-8 string too long")
    return len(raw).to_bytes(2, "big") + raw


def packet(ptype: int, flags: int, body: bytes = b"") -> bytes:
    return bytes(((ptype << 4) | flags,)) + encode_varint(len(body)) + body


def publish_packet(topic: str, payload: bytes, qos: int = 0,
                   retain: bool = False, mid: int = 0,
                   dup: bool = False) -> bytes:
    flags = (0x08 if dup else 0) | (qos << 1) | (0x01 if retain else 0)
    body = encode_utf8(topic)
    if qos > 0:
        body += mid.to_bytes(2, "big")
    return packet(PUBLISH, flags, body + payload)


class _Cursor:
    """Sequential reader over a packet body."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ProtocolError("truncated packet")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return int.from_bytes(self.take(2), "big")

    def utf8(self) -> str:
        return self.take(self.u16()).decode("utf-8")

    def rest(self) -> bytes:
        out = self.data[self.pos:]
        self.pos = len(self.data)
        return out

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.data)


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------

class _Conn:
    """One live client connection (all state touched only on the broker's
    event loop)."""

    __slots__ = ("client_id", "writer", "session", "will_topic",
                 "will_payload", "will_qos", "will_retain", "graceful",
                 "closed")

    def __init__(self, writer: asyncio.StreamWriter):
        self.client_id = ""
        self.writer = writer
        self.session: Optional["_Session"] = None
        self.will_topic: Optional[str] = None
        self.will_payload = b""
        self.will_qos = 0
        self.will_retain = False
        self.graceful = False                   # DISCONNECT packet seen
        self.closed = False

    def send(self, frame: bytes) -> None:
        if not self.closed:
            try:
                self.writer.write(frame)
            except Exception:       # peer vanished mid-write
                self.closed = True


class _Session:
    """Per-client-id broker session state.  Clean sessions die with their
    connection; persistent ones (CONNECT clean_session=0) keep their
    subscriptions, queue QoS-1 traffic while offline, and track unacked
    PUBLISHes for DUP redelivery on resume [MQTT-3.1.2-4..7]."""

    __slots__ = ("client_id", "clean", "subs", "queued", "inflight",
                 "next_mid", "conn")

    def __init__(self, client_id: str, clean: bool):
        self.client_id = client_id
        self.clean = clean
        self.subs: dict[str, int] = {}          # topic filter -> granted qos
        # (topic, payload, qos, retain) routed while offline
        self.queued: deque = deque()
        # mid -> (topic, payload, qos, retain): sent but not PUBACKed
        self.inflight: "OrderedDict[int, tuple]" = OrderedDict()
        self.next_mid = 0
        self.conn: Optional[_Conn] = None

    @property
    def online(self) -> bool:
        return self.conn is not None and not self.conn.closed


class MiniBroker:
    """In-process MQTT 3.1.1 broker on a background asyncio thread.

    Routing mirrors ``SimBroker``: a :class:`TopicTrie` keyed on
    ``(client_id, filter)``, first matching filter per client wins, an
    effective QoS of ``min(publish qos, subscription qos)``, and
    ``$``-topics invisible to wildcard-rooted filters.

    >>> from repro_torch.api.mini_broker import MiniBroker
    >>> from repro_torch.api.mqtt_transport import PahoTransport
    >>> broker = MiniBroker(port=0).start()      # real TCP, ephemeral port
    >>> t = PahoTransport(port=broker.port, backend="builtin")
    >>> got = []
    >>> _ = t.connect("sub", lambda m: got.append(bytes(m.payload)))
    >>> t.subscribe("sub", "fleet/#", qos=1)
    >>> _ = t.publish("fleet/telemetry", b"42", qos=1, sender="sub")
    >>> _ = t.settle()                           # flush-barrier quiescence
    >>> got
    [b'42']
    >>> t.close(); broker.stop()
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 name: str = "mini0", offline_queue_limit: int = 10_000):
        self.name = name
        self.host = host
        self.port = port
        self.offline_queue_limit = offline_queue_limit
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._sessions: dict[str, _Session] = {}
        self._retained: dict[str, RetainedSeq] = {}
        self._trie = TopicTrie()
        # per-(group, real-filter) round-robin cursor for $share routing
        self._share_rr: dict[tuple, int] = {}
        # $SYS-style counters (same keys as SimBroker's SysStats snapshot)
        self.messages_received = 0
        self.messages_sent = 0
        self.bytes_received = 0
        self.bytes_sent = 0
        self.dropped_no_subscriber = 0
        self.pings = 0
        self.sessions_resumed = 0
        self.queued_offline = 0
        self.dropped_offline = 0
        self.redeliveries = 0
        self.shared_deliveries = 0
        self.queue_overflow = 0
        self.per_topic_class: dict[str, int] = defaultdict(int)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "MiniBroker":
        """Bind and serve on a daemon thread; returns once listening."""
        assert self._thread is None, "broker already started"
        ready = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(ready,),
                                        name=f"mini-broker-{self.name}",
                                        daemon=True)
        self._thread.start()
        if not ready.wait(timeout=10.0):
            raise RuntimeError("mini-broker failed to start")
        return self

    def _run(self, ready: threading.Event) -> None:
        loop = self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def serve():
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
            ready.set()

        loop.run_until_complete(serve())
        try:
            loop.run_forever()
        finally:
            loop.close()

    def stop(self) -> None:
        """Close every connection and stop the loop (idempotent)."""
        loop, self._loop = self._loop, None
        if loop is None or not loop.is_running():
            return

        async def _shutdown():
            for sess in list(self._sessions.values()):
                if sess.conn is not None:
                    sess.conn.graceful = True   # shutdown fires no wills
                    self._drop(sess.conn)
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
            me = asyncio.current_task()
            handlers = [t for t in asyncio.all_tasks() if t is not me]
            for t in handlers:
                t.cancel()
            await asyncio.gather(*handlers, return_exceptions=True)
            loop.stop()

        asyncio.run_coroutine_threadsafe(_shutdown(), loop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def kill(self) -> None:
        """Abrupt broker death (SIGKILL semantics): every socket is aborted
        mid-flight — no DISCONNECTs, no wills, no graceful teardown.
        Clients observe a dead TCP connection, exactly as if the broker
        process was killed.  The broker object can be ``start()``-ed again
        afterwards; in-memory session state does NOT survive the kill
        (sessions/retained are wiped), matching an unpersisted broker."""
        loop, self._loop = self._loop, None
        if loop is None or not loop.is_running():
            return

        async def _die():
            for sess in list(self._sessions.values()):
                conn = sess.conn
                if conn is not None and not conn.closed:
                    conn.closed = True      # suppress _drop bookkeeping
                    try:
                        conn.writer.transport.abort()
                    except Exception:
                        pass
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
            me = asyncio.current_task()
            handlers = [t for t in asyncio.all_tasks() if t is not me]
            for t in handlers:
                t.cancel()
            await asyncio.gather(*handlers, return_exceptions=True)
            loop.stop()

        asyncio.run_coroutine_threadsafe(_die(), loop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # a killed broker lost its RAM: fresh state for any restart
        self._sessions.clear()
        self._retained.clear()
        self._trie = TopicTrie()
        self._share_rr.clear()
        self._server = None

    def __enter__(self) -> "MiniBroker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    # ---- connection handling --------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Conn(writer)
        try:
            ptype, flags, body = await self._read_packet(reader)
            if ptype != CONNECT:
                raise ProtocolError("first packet must be CONNECT")
            self._on_connect(conn, _Cursor(body))
            while True:
                ptype, flags, body = await self._read_packet(reader)
                if ptype == DISCONNECT:
                    conn.graceful = True
                    break
                self._dispatch(conn, ptype, flags, _Cursor(body))
                await writer.drain()    # backpressure on this client's acks
        except (asyncio.IncompleteReadError, ConnectionError,
                ProtocolError, OSError):
            pass
        finally:
            self._drop(conn)

    async def _read_packet(self, reader) -> tuple[int, int, bytes]:
        first = (await reader.readexactly(1))[0]
        length, mult = 0, 1
        for _ in range(4):
            b = (await reader.readexactly(1))[0]
            length += (b & 0x7F) * mult
            if not b & 0x80:
                break
            mult *= 128
        else:
            raise ProtocolError("remaining-length varint too long")
        body = await reader.readexactly(length) if length else b""
        return first >> 4, first & 0x0F, body

    def _dispatch(self, conn: _Conn, ptype: int, flags: int,
                  cur: _Cursor) -> None:
        if ptype == PUBLISH:
            self._on_publish(conn, flags, cur)
        elif ptype == SUBSCRIBE:
            self._on_subscribe(conn, cur)
        elif ptype == UNSUBSCRIBE:
            self._on_unsubscribe(conn, cur)
        elif ptype == PINGREQ:
            self.pings += 1
            conn.send(packet(PINGRESP, 0))
        elif ptype == PUBACK:
            mid = cur.u16()
            if conn.session is not None:            # settles DUP redelivery
                conn.session.inflight.pop(mid, None)
        elif ptype == CONNECT:
            raise ProtocolError("duplicate CONNECT")
        else:
            raise ProtocolError(f"unsupported packet type {ptype}")

    # ---- packet handlers -------------------------------------------------
    def _on_connect(self, conn: _Conn, cur: _Cursor) -> None:
        proto = cur.utf8()
        level = cur.u8()
        if proto not in ("MQTT", "MQIsdp") or level not in (3, 4):
            conn.send(packet(CONNACK, 0, bytes((0, 0x01))))  # bad proto
            raise ProtocolError(f"unsupported protocol {proto!r} v{level}")
        cflags = cur.u8()
        clean = bool(cflags & 0x02)
        cur.u16()                                   # keepalive: not enforced
        conn.client_id = cur.utf8() or f"anon-{id(conn):x}"
        if cflags & 0x04:                           # will flag
            conn.will_topic = cur.utf8()
            conn.will_payload = cur.take(cur.u16())
            conn.will_qos = (cflags >> 3) & 0x03
            conn.will_retain = bool(cflags & 0x20)
        if cflags & 0x80:
            cur.utf8()                              # username: ignored
        if cflags & 0x40:
            cur.take(cur.u16())                     # password: ignored
        sess = self._sessions.get(conn.client_id)
        if sess is not None and sess.conn is not None:
            # session takeover [MQTT-3.1.4-2]: the old connection is closed
            # as a network failure, so its will (if any) IS published
            self._drop(sess.conn)
            sess = self._sessions.get(conn.client_id)  # _drop may forget it
        session_present = False
        if clean or sess is None or sess.clean:
            if sess is not None:
                self._forget_session(sess)
            sess = _Session(conn.client_id, clean)
            self._sessions[conn.client_id] = sess
        else:
            session_present = True
            self.sessions_resumed += 1
        sess.conn = conn
        conn.session = sess
        conn.send(packet(CONNACK, 0,
                         bytes((0x01 if session_present else 0x00, 0))))
        if session_present:
            # unacked QoS-1 publishes first — same packet ids, DUP set
            # [MQTT-4.4.0-1] — then traffic queued while offline
            for mid, (topic, payload, qos, retain) in list(
                    sess.inflight.items()):
                self.redeliveries += 1
                self.messages_sent += 1
                self.bytes_sent += len(payload)
                conn.send(publish_packet(topic, payload, qos, retain,
                                         mid=mid, dup=True))
            queued, sess.queued = sess.queued, deque()
            for topic, payload, qos, retain in queued:
                self._send_to(sess, topic, payload, qos, retain)

    def _on_publish(self, conn: _Conn, flags: int, cur: _Cursor) -> None:
        qos = (flags >> 1) & 0x03
        retain = bool(flags & 0x01)
        if qos > 1:
            raise ProtocolError("QoS 2 not supported")
        topic = cur.utf8()
        if "+" in topic or "#" in topic:
            raise ProtocolError("wildcards are not allowed in topic names")
        mid = cur.u16() if qos > 0 else 0
        payload = cur.rest()
        self.messages_received += 1
        self.bytes_received += len(payload)
        self.per_topic_class[
            topic.split("/")[1] if "/" in topic else topic] += 1
        if qos == 1:
            conn.send(packet(PUBACK, 0, mid.to_bytes(2, "big")))
        self._route(topic, payload, qos, retain)

    def _on_subscribe(self, conn: _Conn, cur: _Cursor) -> None:
        sess = conn.session
        mid = cur.u16()
        granted = bytearray()
        fresh: list[tuple[str, str, Optional[str]]] = []
        while not cur.exhausted:
            filt = cur.utf8()
            qos = min(cur.u8() & 0x03, 1)           # QoS 2 granted as QoS 1
            group, real = parse_share(filt)
            sess.subs[filt] = qos
            self._trie.insert(real, (sess.client_id, filt))
            granted.append(qos)
            fresh.append((filt, real, group))
        conn.send(packet(SUBACK, 0, mid.to_bytes(2, "big") + bytes(granted)))
        # retained replay — after the SUBACK, with the retain bit set, for
        # the filters of THIS packet only [MQTT-3.3.1-6]: earlier
        # subscriptions already received their replay.  Shared
        # subscriptions get NO retained replay (MQTT 5 §4.8.2).
        for filt, real, group in fresh:
            if group is not None:
                continue
            for topic, seq in list(self._retained.items()):
                if topic_matches(real, topic):
                    # full frame sequence, in part order (multi-part
                    # fleet-control calls retain every frame, not just
                    # the last one)
                    for m in seq.messages():
                        self._send_to(sess, topic, m.payload,
                                      min(m.qos, sess.subs[filt]),
                                      retain=True)

    def _on_unsubscribe(self, conn: _Conn, cur: _Cursor) -> None:
        sess = conn.session
        mid = cur.u16()
        while not cur.exhausted:
            filt = cur.utf8()
            if sess.subs.pop(filt, None) is not None:
                self._trie.remove(parse_share(filt)[1],
                                  (sess.client_id, filt))
        conn.send(packet(UNSUBACK, 0, mid.to_bytes(2, "big")))

    # ---- routing ---------------------------------------------------------
    def _route(self, topic: str, payload: bytes, qos: int,
               retain: bool) -> None:
        if retain:
            if payload:
                retain_message(self._retained,
                               Message(topic, payload, qos, retain=True))
            else:
                self._retained.pop(topic, None)     # empty payload clears
        matched = False
        seen: set[str] = set()
        shared: dict[tuple, list] = {}
        for client_id, filt in self._trie.match(topic):
            sess = self._sessions.get(client_id)
            if sess is None:
                continue
            sub_qos = sess.subs.get(filt)
            if sub_qos is None:
                continue
            group, real = parse_share(filt)
            eff = min(qos, sub_qos)
            if group is not None:
                shared.setdefault((group, real), []).append((sess, eff))
                continue
            if client_id in seen:           # first matching filter wins
                continue
            seen.add(client_id)
            if sess.online:
                # [MQTT-3.3.1-9]: the retain flag is 0 on routed
                # (non-replay) deliveries — only retained replay at
                # subscribe time sets it
                self._send_to(sess, topic, payload, eff)
                matched = True
            elif not sess.clean and eff >= 1:
                self._queue_offline(sess, topic, payload, eff)
                matched = True
            else:
                self.dropped_offline += 1
        for key, members in shared.items():
            if self._deliver_shared(key, members, topic, payload):
                matched = True
        if not matched:
            self.dropped_no_subscriber += 1

    def _deliver_shared(self, key: tuple, members: list, topic: str,
                        payload: bytes) -> bool:
        """Deliver one message to exactly one member of a $share group,
        round-robin over live members; if the whole group is offline, a
        durable member (persistent session, effective QoS >= 1) queues it."""
        live = [(s, q) for s, q in members if s.online]
        if live:
            k = self._share_rr.get(key, 0)
            self._share_rr[key] = k + 1
            sess, eff = live[k % len(live)]
            self.shared_deliveries += 1
            self._send_to(sess, topic, payload, eff)
            return True
        durable = [(s, q) for s, q in members if not s.clean and q >= 1]
        if durable:
            k = self._share_rr.get(key, 0)
            self._share_rr[key] = k + 1
            sess, eff = durable[k % len(durable)]
            self._queue_offline(sess, topic, payload, eff)
            return True
        self.dropped_offline += 1
        return False

    def _queue_offline(self, sess: _Session, topic: str, payload: bytes,
                       qos: int) -> None:
        if len(sess.queued) >= self.offline_queue_limit:
            sess.queued.popleft()           # bounded: oldest message loses
            self.queue_overflow += 1
        sess.queued.append((topic, payload, qos, False))
        self.queued_offline += 1

    def _send_to(self, sess: _Session, topic: str, payload: bytes, qos: int,
                 retain: bool = False) -> None:
        mid = 0
        if qos:
            sess.next_mid = (sess.next_mid % 0xFFFF) + 1
            while sess.next_mid in sess.inflight:   # ids still unacked
                sess.next_mid = (sess.next_mid % 0xFFFF) + 1
            mid = sess.next_mid
            if not sess.clean:
                sess.inflight[mid] = (topic, payload, qos, retain)
        frame = publish_packet(topic, payload, qos, retain, mid=mid)
        self.messages_sent += 1
        self.bytes_sent += len(payload)
        if sess.conn is not None:
            sess.conn.send(frame)

    def _drop(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        sess = conn.session
        if sess is not None and sess.conn is conn:
            sess.conn = None
        if not conn.graceful and conn.will_topic is not None:
            self._route(conn.will_topic, conn.will_payload,
                        conn.will_qos, conn.will_retain)
        if sess is not None and sess.clean and sess.conn is None \
                and self._sessions.get(sess.client_id) is sess:
            self._forget_session(sess)
        try:
            conn.writer.close()
        except Exception:
            pass

    def _forget_session(self, sess: _Session) -> None:
        for filt in sess.subs:
            self._trie.remove(parse_share(filt)[1], (sess.client_id, filt))
        self._sessions.pop(sess.client_id, None)

    # ---- introspection (thread-safe reads of loop-owned counters) --------
    def sys_stats(self) -> dict:
        return {
            "messages_received": self.messages_received,
            "messages_sent": self.messages_sent,
            "bytes_received": self.bytes_received,
            "bytes_sent": self.bytes_sent,
            "dropped_no_subscriber": self.dropped_no_subscriber,
            "pings": self.pings,
            "per_topic_class": dict(self.per_topic_class),
            "connected_clients": sum(
                1 for s in self._sessions.values() if s.online),
            "persistent_sessions": sum(
                1 for s in self._sessions.values() if not s.clean),
            "sessions_resumed": self.sessions_resumed,
            "queued_offline": self.queued_offline,
            "dropped_offline": self.dropped_offline,
            "redeliveries": self.redeliveries,
            "shared_deliveries": self.shared_deliveries,
            "queue_overflow": self.queue_overflow,
            "retained_messages": len(self._retained),
            "trie_cache_hits": self._trie.cache_hits,
            "trie_cache_misses": self._trie.cache_misses,
            "subscriptions": self._trie.size,
        }

    def retained_topics(self) -> list[str]:
        return sorted(self._retained)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="SDFLMQ bundled MQTT 3.1.1 mini-broker")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=1883)
    args = ap.parse_args(argv)
    broker = MiniBroker(args.host, args.port).start()
    print(f"mini-broker listening on {broker.host}:{broker.port} "
          f"(ctrl-c to stop)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        broker.stop()


if __name__ == "__main__":
    main()
