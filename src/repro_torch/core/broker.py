"""SimBroker — an in-process, deterministic MQTT-semantics message broker.

Implements the MQTT features SDFLMQ relies on:
  * topic trie with ``+`` (single-level) and ``#`` (multi-level) wildcards,
  * QoS 0 (fire-and-forget) and QoS 1 (at-least-once with acks + dedup),
  * retained messages (late subscribers immediately receive the last value),
  * last-will testament (published on abnormal disconnect -> the
    coordinator's failure detector),
  * ``$SYS``-style load counters (message/byte counts per topic class),
  * broker **bridging** (paper §III-F): brokers forward matching topics to
    each other with loop prevention via origin-broker tagging.

Delivery is a reentrancy-safe FIFO pump: handlers may publish from within
handlers; messages are processed in deterministic order.  This is the
control-plane transport; tensors never travel through it in the TPU
deployment (see DESIGN.md), though the host-side FedAvg path used by the
paper-replication benchmarks does move (small) model payloads here exactly
like the paper does over MQTT.
"""
from __future__ import annotations

import itertools
import random
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import msgpack


@dataclass
class Message:
    topic: str
    payload: bytes
    qos: int = 0
    retain: bool = False
    mid: int = 0
    origin_broker: str = ""
    duplicate: bool = False


@dataclass
class Subscription:
    client_id: str
    topic_filter: str
    qos: int = 0


def parse_share(topic_filter: str) -> tuple[Optional[str], str]:
    """Split an MQTT 5 shared-subscription filter.

    ``$share/<group>/<real filter>`` -> ``(group, real_filter)``; anything
    else -> ``(None, topic_filter)``.  Malformed ``$share`` filters (no
    group or no real filter) are treated as ordinary filters — they then
    fall under the ``$``-topic rule and simply never match."""
    if not topic_filter.startswith("$share/"):
        return None, topic_filter
    rest = topic_filter[len("$share/"):]
    group, sep, real = rest.partition("/")
    if not group or not sep or not real:
        return None, topic_filter
    return group, real


def topic_matches(topic_filter: str, topic: str) -> bool:
    """MQTT 3.1.1 wildcard matching: ``+`` one level, ``#`` trailing
    multi-level (also covering the parent level), and topics whose first
    level starts with ``$`` (e.g. ``$SYS``) are never matched by a filter
    that *starts* with a wildcard [MQTT-4.7.2-1]."""
    f_parts = topic_filter.split("/")
    t_parts = topic.split("/")
    if t_parts[0].startswith("$") and f_parts[0] in ("+", "#"):
        return False
    for i, f in enumerate(f_parts):
        if f == "#":
            return i == len(f_parts) - 1
        if i >= len(t_parts):
            return False
        if f != "+" and f != t_parts[i]:
            return False
    return len(f_parts) == len(t_parts)


class _TrieNode:
    __slots__ = ("children", "values", "hash_values")

    def __init__(self):
        self.children: dict[str, _TrieNode] = {}
        self.values: dict = {}       # value -> insertion seq (exact end)
        self.hash_values: dict = {}  # value -> seq ('#' at this level)


class TopicTrie:
    """Subscription trie with a per-topic match cache.

    ``insert``/``remove`` take a topic filter and an opaque hashable value;
    ``match(topic)`` returns matching values ordered by first insertion —
    the same tie-break a linear scan over insertion-ordered subscriptions
    produces.  Matches are memoized per concrete topic; any mutation
    invalidates the cache (subscribe/unsubscribe are rare, publishes are
    the hot path).  The MQTT-4.7.2-1 ``$``-topic rule is honored: filters
    beginning with a wildcard never match topics whose first level starts
    with ``$``.
    """

    __slots__ = ("_root", "_seq", "_cache", "size",
                 "cache_hits", "cache_misses")

    def __init__(self):
        self._root = _TrieNode()
        self._seq = itertools.count()
        self._cache: dict[str, tuple] = {}
        self.size = 0
        self.cache_hits = 0
        self.cache_misses = 0

    def insert(self, topic_filter: str, value) -> None:
        node = self._root
        for part in topic_filter.split("/"):
            if part == "#":
                if value not in node.hash_values:
                    node.hash_values[value] = next(self._seq)
                    self.size += 1
                self._cache.clear()
                return
            node = node.children.setdefault(part, _TrieNode())
        if value not in node.values:
            node.values[value] = next(self._seq)
            self.size += 1
        self._cache.clear()

    def remove(self, topic_filter: str, value) -> None:
        # walk down, then prune empty nodes on the way back up
        node = self._root
        path = []
        parts = topic_filter.split("/")
        for i, part in enumerate(parts):
            if part == "#":
                if node.hash_values.pop(value, None) is not None:
                    self.size -= 1
                    self._cache.clear()
                break
            nxt = node.children.get(part)
            if nxt is None:
                return
            path.append((node, part))
            node = nxt
        else:
            if node.values.pop(value, None) is not None:
                self.size -= 1
                self._cache.clear()
        for parent, part in reversed(path):
            child = parent.children[part]
            if child.children or child.values or child.hash_values:
                break
            del parent.children[part]

    def match(self, topic: str) -> tuple:
        """Values whose filter matches ``topic``, ordered by insertion."""
        hit = self._cache.get(topic)
        if hit is not None:
            self.cache_hits += 1
            return hit
        self.cache_misses += 1
        parts = topic.split("/")
        found: dict = {}          # value -> min seq
        sys_topic = parts[0].startswith("$")

        def _collect(vals):
            for v, s in vals.items():
                if v not in found or s < found[v]:
                    found[v] = s

        def _walk(node: _TrieNode, i: int, root_wild_ok: bool):
            if node.hash_values and (root_wild_ok or i > 0):
                _collect(node.hash_values)
            if i == len(parts):
                _collect(node.values)
                return
            nxt = node.children.get(parts[i])
            if nxt is not None:
                _walk(nxt, i + 1, root_wild_ok)
            if i > 0 or root_wild_ok:
                plus = node.children.get("+")
                if plus is not None:
                    _walk(plus, i + 1, root_wild_ok)

        # at the root level, wildcard branches ('+'/'#') are skipped for
        # $-topics; an exact first level starting with '$' still matches
        if sys_topic:
            nxt = self._root.children.get(parts[0])
            if nxt is not None:
                _walk(nxt, 1, False)
        else:
            _walk(self._root, 0, True)
        out = tuple(sorted(found, key=found.get))
        self._cache[topic] = out
        return out

    def invalidate(self) -> None:
        self._cache.clear()


def frame_part_info(payload) -> Optional[tuple]:
    """Best-effort sniff of an MQTTFC frame header: returns ``(sender,
    call_id, part_idx, n_parts)`` when ``payload`` looks like a fleet-
    control frame, ``None`` for opaque payloads.  Brokers use this to keep
    the FULL frame sequence of a retained multi-part message (one retained
    slot per topic holds every part of the latest call) instead of the
    classic single-slot behavior that would replay only the last frame."""
    try:
        mv = memoryview(payload)
        if len(mv) < 5:
            return None
        hlen = int.from_bytes(mv[:4], "big")
        if hlen <= 0 or hlen > 512 or 4 + hlen > len(mv):
            return None
        header = msgpack.unpackb(bytes(mv[4:4 + hlen]))
        if not isinstance(header, (list, tuple)) or len(header) < 6:
            return None
        sender, call_id, idx, n_parts = header[0], header[1], header[2], header[3]
        if not isinstance(sender, str):
            return None
        if not all(isinstance(x, int) and not isinstance(x, bool)
                   for x in (call_id, idx, n_parts)):
            return None
        if n_parts < 1 or not 0 <= idx < n_parts:
            return None
        return sender, call_id, idx, n_parts
    except Exception:
        return None


class RetainedSeq:
    """The retained state of one topic: either a single opaque message or
    the (possibly still accumulating) frame sequence of one multi-part
    fleet-control call, keyed by ``(sender, call_id)``."""

    __slots__ = ("key", "n_parts", "parts")

    def __init__(self, key: Optional[tuple], n_parts: int):
        self.key = key
        self.n_parts = n_parts
        self.parts: dict[int, Message] = {}

    def messages(self) -> list[Message]:
        return [self.parts[i] for i in sorted(self.parts)]


def retain_message(store: dict, msg: Message,
                   info: Optional[tuple] = None) -> None:
    """Shared retained-store update (SimBroker + MiniBroker semantics):
    opaque or single-part payloads replace the slot (last value wins); a
    part of a NEW multi-part call replaces the slot; further parts of the
    SAME call accumulate into it."""
    if info is None:
        info = frame_part_info(msg.payload)
    if info is None or info[3] <= 1:
        seq = RetainedSeq(None, 1)
        seq.parts[0] = msg
        store[msg.topic] = seq
        return
    sender, call_id, idx, n_parts = info
    key = (sender, call_id)
    cur = store.get(msg.topic)
    if cur is None or cur.key != key:
        cur = RetainedSeq(key, n_parts)
        store[msg.topic] = cur
    cur.parts[idx] = msg


@dataclass
class _ClientSession:
    client_id: str
    on_message: Callable[[Message], None]
    will: Optional[Message] = None
    subscriptions: dict[str, int] = field(default_factory=dict)
    connected: bool = True
    clean_session: bool = True
    # QoS-1 messages routed while a persistent session is offline, replayed
    # in order on resume: (msg, effective_qos)
    queued: deque = field(default_factory=deque)
    inflight_acks: set = field(default_factory=set)
    seen_mids: set = field(default_factory=set)


class SysStats:
    """$SYS-style counters."""

    def __init__(self):
        self.messages_received = 0
        self.messages_sent = 0
        self.bytes_received = 0
        self.bytes_sent = 0
        self.dropped_no_subscriber = 0
        self.per_topic_class: dict[str, int] = defaultdict(int)
        self.bridge_forwards = 0
        self.sessions_resumed = 0
        self.queued_offline = 0
        self.dropped_offline = 0
        self.shared_deliveries = 0

    def snapshot(self) -> dict:
        return {
            "messages_received": self.messages_received,
            "messages_sent": self.messages_sent,
            "bytes_received": self.bytes_received,
            "bytes_sent": self.bytes_sent,
            "dropped_no_subscriber": self.dropped_no_subscriber,
            "bridge_forwards": self.bridge_forwards,
            "sessions_resumed": self.sessions_resumed,
            "queued_offline": self.queued_offline,
            "dropped_offline": self.dropped_offline,
            "shared_deliveries": self.shared_deliveries,
            "per_topic_class": dict(self.per_topic_class),
        }


@dataclass
class _BridgeLink:
    """One directed broker-to-broker bridge with its own network model."""
    other: "SimBroker"
    filters: list[str]
    delay_s: float = 0.0
    jitter_s: float = 0.0
    drop_p: float = 0.0
    clock: Optional[object] = None         # SimClock-like: .now / .schedule
    rng: random.Random = field(default_factory=random.Random)
    forwarded: int = 0
    dropped: int = 0
    retransmitted: int = 0
    # inter-broker partition: while down, QoS>=1 / retained traffic is held
    # (the bridge's persistent session), QoS 0 is lost — healed bridges
    # release the backlog in original order
    down: bool = False
    held: list = field(default_factory=list)

    def release(self, src: "SimBroker") -> None:
        self.down = False
        backlog, self.held = self.held, []
        for msg in backlog:
            self.forward(src, msg)

    def forward(self, src: "SimBroker", msg: Message) -> None:
        if self.down:
            if msg.qos >= 1 or msg.retain:
                self.held.append(msg)
            else:
                self.dropped += 1
            return
        lat = self.delay_s + (self.rng.uniform(0.0, self.jitter_s)
                              if self.jitter_s else 0.0)
        if self.drop_p and self.rng.random() < self.drop_p:
            if msg.qos == 0:
                self.dropped += 1          # fire-and-forget: lost in transit
                return
            self.retransmitted += 1        # at-least-once across the bridge:
            lat *= 2.0                     # resend once, arriving late
        src.stats.bridge_forwards += 1
        self.forwarded += 1
        # re-originate per hop: the receiver sees the message as coming from
        # the broker that forwarded it (not the first broker on the path).
        # Each receiver then skips only its bridge back toward the sender,
        # which is loop-free on any TREE fabric (hub-and-spoke, chains —
        # the multi-broker shapes §III-F describes) of any size.  A cyclic
        # broker graph (full mesh of >= 3) would duplicate and is not
        # supported by this scheme.
        origin = src.name
        if self.clock is not None and lat > 0:
            self.clock.schedule(
                self.clock.now + lat,
                lambda: self.other.publish(msg.topic, msg.payload, msg.qos,
                                           msg.retain, _origin=origin))
        else:
            self.other.publish(msg.topic, msg.payload, msg.qos, msg.retain,
                               _origin=origin)


class SimBroker:
    """Reference implementation of the ``repro_torch.api.transport.Transport``
    protocol (the surface MQTTFC, clients, and the coordinator depend on)."""

    def __init__(self, name: str = "broker0"):
        self.name = name
        # per-instance message-id counter: QoS-1 dedup and delivery logs are
        # isolated between brokers and deterministic across runs
        self._ids = itertools.count(1)
        self._clients: dict[str, _ClientSession] = {}
        self._retained: dict[str, RetainedSeq] = {}
        self._queue: deque = deque()
        self._pumping = False
        self._bridges: list[_BridgeLink] = []
        # subscription trie: value = (client_id, filter); match(topic) is
        # O(topic levels), memoized per topic, invalidated on sub changes
        self._trie = TopicTrie()
        # per-(group, real-filter) round-robin cursor for $share delivery
        self._share_rr: dict[tuple, int] = {}
        self.stats = SysStats()
        self.delivery_log: list[tuple[str, str, int]] = []  # (topic, client, size)
        self.log_deliveries = False

    # ---- connection lifecycle -------------------------------------------
    def connect(self, client_id: str, on_message: Callable[[Message], None],
                will: Optional[Message] = None,
                clean_session: Optional[bool] = None) -> _ClientSession:
        """``clean_session=False`` opts into MQTT persistent-session
        semantics: subscriptions survive a disconnect, and QoS-1 messages
        routed while the client is offline are queued and replayed in order
        when it reconnects with ``clean_session=False`` again.  ``None``
        (the default) means the backend default — a clean session."""
        clean = True if clean_session is None else bool(clean_session)
        old = self._clients.get(client_id)
        if old is not None and not clean and not old.clean_session:
            # resume the stored session: subscriptions stay in the trie
            was_offline = not old.connected
            old.on_message = on_message
            old.will = will
            old.connected = True
            if was_offline:
                self.stats.sessions_resumed += 1
                while old.queued:
                    msg, eff = old.queued.popleft()
                    self._deliver(old, msg, eff)
            return old
        if old is not None:        # clean reconnect: the old session's subs die
            for filt in old.subscriptions:
                self._trie.remove(parse_share(filt)[1], (client_id, filt))
        sess = _ClientSession(client_id, on_message, will, clean_session=clean)
        self._clients[client_id] = sess
        return sess

    def disconnect(self, client_id: str, graceful: bool = True) -> None:
        sess = self._clients.get(client_id)
        if sess is None:
            return
        will = sess.will
        if sess.clean_session:
            self._clients.pop(client_id, None)
            sess.connected = False
            for filt in sess.subscriptions:
                self._trie.remove(parse_share(filt)[1], (client_id, filt))
        else:
            # persistent session: keep subscriptions, start queueing QoS 1
            sess.connected = False
            sess.will = None       # the will belongs to the dead connection
        if not graceful and will is not None:
            self.publish(will.topic, will.payload,
                         qos=will.qos, retain=will.retain)

    # ---- subscriptions ---------------------------------------------------
    def subscribe(self, client_id: str, topic_filter: str, qos: int = 0) -> None:
        sess = self._clients[client_id]
        sess.subscriptions[topic_filter] = qos
        group, real = parse_share(topic_filter)
        self._trie.insert(real, (client_id, topic_filter))
        if group is not None:
            return      # retained messages are not sent to shared subs
        # retained delivery: the full frame sequence, in part order
        for topic, seq in list(self._retained.items()):
            if topic_matches(real, topic):
                for msg in seq.messages():
                    self._deliver(sess, msg)

    def unsubscribe(self, client_id: str, topic_filter: str) -> None:
        sess = self._clients.get(client_id)
        if sess is None:
            return
        if sess.subscriptions.pop(topic_filter, None) is not None:
            self._trie.remove(parse_share(topic_filter)[1],
                              (client_id, topic_filter))

    def subscriptions_of(self, client_id: str) -> list[str]:
        return list(self._clients[client_id].subscriptions)

    # ---- publishing ------------------------------------------------------
    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False, sender: str = "",
                _origin: str = "") -> int:
        """``sender`` (the publishing client id) is accepted for Transport
        compatibility; decorators like LatencyTransport key per-link network
        models on it.  The sim broker itself only routes on the topic."""
        mid = next(self._ids)
        msg = Message(topic, payload, qos, retain, mid,
                      _origin or self.name)
        self.stats.messages_received += 1
        self.stats.bytes_received += len(payload)
        self.stats.per_topic_class[topic.split("/")[1] if "/" in topic else topic] += 1
        self._queue.append(msg)
        self._pump()
        return mid

    def _pump(self) -> None:
        if self._pumping:
            return
        self._pumping = True
        try:
            while self._queue:
                msg = self._queue.popleft()
                self._route(msg)
        finally:
            self._pumping = False

    def _route(self, msg: Message) -> None:
        if msg.retain:
            if msg.payload:
                retain_message(self._retained, msg)
            else:
                self._retained.pop(msg.topic, None)
        matched = False
        seen: set[str] = set()      # first matching filter per client wins
        shared: dict[tuple, list] = {}   # (group, real) -> [(sess, eff_qos)]
        for client_id, filt in self._trie.match(msg.topic):
            sess = self._clients.get(client_id)
            if sess is None:
                continue
            sub_qos = sess.subscriptions.get(filt)
            if sub_qos is None:
                continue
            eff_qos = min(msg.qos, sub_qos)
            group, real = parse_share(filt)
            if group is not None:
                shared.setdefault((group, real), []).append((sess, eff_qos))
                continue
            if client_id in seen:
                continue
            seen.add(client_id)
            if not sess.connected:
                if not sess.clean_session and eff_qos >= 1:
                    sess.queued.append((msg, eff_qos))
                    self.stats.queued_offline += 1
                    matched = True
                else:
                    self.stats.dropped_offline += 1
                continue
            self._deliver(sess, msg, eff_qos)
            matched = True
        for key, members in shared.items():
            if self._deliver_shared(key, members, msg):
                matched = True
        if not matched:
            self.stats.dropped_no_subscriber += 1
        # bridge forwarding with loop prevention
        for br in self._bridges:
            if msg.origin_broker == br.other.name:
                continue
            if any(topic_matches(f, msg.topic) for f in br.filters):
                br.forward(self, msg)

    def _deliver_shared(self, key: tuple, members: list,
                        msg: Message) -> bool:
        """One delivery per ``$share`` group: round-robin over the live
        members (in subscribe order); with every member offline, queue to
        the next persistent member instead so no QoS-1 message is lost."""
        live = [(s, q) for s, q in members if s.connected]
        if live:
            k = self._share_rr.get(key, 0)
            sess, eff_qos = live[k % len(live)]
            self._share_rr[key] = k + 1
            self.stats.shared_deliveries += 1
            self._deliver(sess, msg, eff_qos)
            return True
        durable = [(s, q) for s, q in members
                   if not s.clean_session and q >= 1]
        if durable:
            k = self._share_rr.get(key, 0)
            sess, eff_qos = durable[k % len(durable)]
            self._share_rr[key] = k + 1
            sess.queued.append((msg, eff_qos))
            self.stats.queued_offline += 1
            return True
        self.stats.dropped_offline += 1
        return False

    def _deliver(self, sess: _ClientSession, msg: Message, eff_qos: int = 0) -> None:
        if eff_qos >= 1:
            # at-least-once: dedup on (mid); ack bookkeeping
            if msg.mid in sess.seen_mids:
                return
            sess.seen_mids.add(msg.mid)
            sess.inflight_acks.add(msg.mid)
        self.stats.messages_sent += 1
        self.stats.bytes_sent += len(msg.payload)
        if self.log_deliveries:
            self.delivery_log.append((msg.topic, sess.client_id, len(msg.payload)))
        sess.on_message(msg)
        if eff_qos >= 1:
            sess.inflight_acks.discard(msg.mid)  # implicit PUBACK

    # ---- bridging --------------------------------------------------------
    def bridge(self, other: "SimBroker", topics: Optional[list[str]] = None,
               bidirectional: bool = True, delay_s: float = 0.0,
               jitter_s: float = 0.0, drop_p: float = 0.0,
               clock=None, seed: int = 0) -> None:
        """Forward matching topics to ``other`` (paper §III-F).  A bridge
        may carry its own link model: with a ``clock`` (a
        ``repro_torch.api.transport.SimClock``, duck-typed — anything with
        ``now``/``schedule``) forwards are enqueued at their modeled
        cross-broker arrival time instead of pumping synchronously, so
        multi-broker federations see realistic inter-region lag."""
        filters = topics or ["#"]
        link = _BridgeLink(other, filters, delay_s, jitter_s, drop_p, clock,
                           random.Random(f"{seed}/{self.name}->{other.name}"))
        self._bridges.append(link)
        if bidirectional:
            back = _BridgeLink(self, filters, delay_s, jitter_s, drop_p,
                               clock,
                               random.Random(
                                   f"{seed}/{other.name}->{self.name}"))
            other._bridges.append(back)

    def set_bridge_down(self, other_name: Optional[str] = None,
                        down: bool = True) -> None:
        """Partition (or heal) this broker's bridges toward ``other_name``
        (all bridges when ``None``).  While down, reliable traffic queues on
        the bridge; healing replays the backlog in order."""
        for br in self._bridges:
            if other_name is not None and br.other.name != other_name:
                continue
            if down:
                br.down = True
            elif br.down:
                br.release(self)

    # ---- introspection ---------------------------------------------------
    def sys_stats(self) -> dict:
        out = self.stats.snapshot()
        out["trie_cache_hits"] = self._trie.cache_hits
        out["trie_cache_misses"] = self._trie.cache_misses
        out["subscriptions"] = self._trie.size
        out["retained_messages"] = len(self._retained)
        return out

    def retained_topics(self) -> list[str]:
        return sorted(self._retained)
