"""MQTT Fleet Control (MQTTFC) — the RFC layer SDFLMQ is built on
(paper §III-B1, §IV).

Remotely executable functions are bound to MQTT topics; any client can
publish to the function topic with arguments in the payload, and the bound
function runs on every subscriber.  Large payloads (model parameter sets)
ride the zero-copy TensorBundle wire format (repro_torch.core.wire): tensors are
flattened once into the frame's data region, chunked into fixed-size parts
via memoryview slices (no per-part copies), reassembled into one
preallocated buffer at the receiver, and decoded as zero-copy views.  The
legacy msgpack-ExtType format remains as a fallback codec
(``wire_format="legacy"``) so every change is bit-identity-testable.

Frame layout (one wire message)::

    [4B header len][msgpack header][chunk]
    header = (sender, call_id, part_idx, n_parts, flags, codec,
              total_len, chunk_offset)            # 6-tuple = legacy frames
    flags:  1 = compressed   2 = TensorBundle body   4 = quantized payload

Compression defaults to zstd when the ``zstandard`` wheel is importable
(zlib — the paper's baseline — otherwise); bodies flagged as
int8-quantized skip the recompression attempt entirely, and incompressible
tensor bodies are detected with a cheap sample probe before paying for a
full-body compress.
"""
from __future__ import annotations

import itertools
import zlib
from collections import OrderedDict
from typing import Any, Callable, Optional

import msgpack
import numpy as np

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None

from typing import TYPE_CHECKING

from repro_torch.core import wire
from repro_torch.core.broker import Message, TopicTrie

if TYPE_CHECKING:  # protocol import for typing only (no runtime cycle)
    from repro_torch.api.transport import Transport

_NUMPY_EXT = 42

# frame flag bits
F_COMPRESSED = 1
F_TENSORBUNDLE = 2
F_QUANTIZED = 4


def default_codec() -> str:
    """zstd when the wheel is importable, else the paper's zlib baseline."""
    return "zstd" if _zstd is not None else "zlib"


def _default(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_NUMPY_EXT, msgpack.packb(
            (obj.dtype.str, obj.shape, obj.tobytes())))
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _ext_hook(code, data):
    if code == _NUMPY_EXT:
        dtype, shape, buf = msgpack.unpackb(data)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    return msgpack.ExtType(code, data)


def encode(obj: Any) -> bytes:
    """Legacy msgpack+ExtType body codec (fallback wire format)."""
    return msgpack.packb(obj, default=_default, use_bin_type=True)


def decode(data: bytes) -> Any:
    return msgpack.unpackb(data, ext_hook=_ext_hook, raw=False,
                           strict_map_key=False)


_FAST_LEVEL_BYTES = 1 << 20


def _build_control_dict() -> bytes:
    """Preset dictionary for SMALL control frames, derived from canonical
    SDFLMQ control payloads (join/create/heartbeat/topology shapes).  The
    corpus is hardcoded, so every endpoint derives the IDENTICAL
    dictionary — no wire negotiation, and the frame header's codec string
    is all a receiver needs.  zlib reads preset dictionaries back-to-front
    (most common substrings last)."""
    stats = {"cpu": 1.0, "memory_mb": 1024.0, "bandwidth_mbps": 10.0,
             "samples": 128, "battery": 1.0}
    samples = [
        {"a": ["train_session", "c0", "model", 0, "trainer", stats],
         "k": {}, "s": "c0"},
        {"a": ["train_session", "model", "c0", 8, 2, 64, 3600.0, 120.0,
               "aggregator", stats],
         "k": {"strategy": "fedavg", "async_cfg": None,
               "defense_cfg": None}, "s": "c0"},
        {"a": ["train_session", "c1"], "k": {}, "s": "c1"},
        {"a": [{"session_id": "train_session", "round": 1, "version": 1,
                "clusters": {"cluster_0": ["c0", "c1", "c2"]},
                "heads": ["c0"], "root": "c0", "strategy": "fedavg",
                "weight": 1.0, "sender": "coordinator",
                "partial": False}], "k": {}, "s": "coordinator"},
        {"a": ["sdflmq/session/train_session/cluster/cluster_0/agg",
               "sdflmq/session/train_session/global",
               "sdflmq/client/c0/ctrl"], "k": {}, "s": "param_server"},
    ]
    return b"".join(encode(s) for s in samples)[-32768:]


_CONTROL_DICT = _build_control_dict()
_ZSTD_DICT = (_zstd.ZstdCompressionDict(_CONTROL_DICT)
              if _zstd is not None else None)
# frames below this never try the dict codec (header + adler32 overhead)
DICT_MIN_BYTES = 48


def dict_codec() -> str:
    """Dictionary-trained codec for small control frames: zstd+dict when
    the wheel is importable, zlib's preset-dictionary mode otherwise."""
    return "zstd+dict" if _zstd is not None else "zlib+dict"


def compress(data, codec: str) -> bytes:
    # zlib/zstd accept any buffer-protocol object: no staging copy.
    # Large bodies (multi-MB float64 partial sums) drop to level 1: ~30%
    # less CPU for ~4% worse ratio on float-mantissa data.
    level = 1 if len(data) > _FAST_LEVEL_BYTES else 3
    if codec == "zlib":
        return zlib.compress(data, level=level)
    if codec == "zstd" and _zstd is not None:
        return _zstd.ZstdCompressor(level=level).compress(data)
    if codec == "zlib+dict":
        c = zlib.compressobj(3, zlib.DEFLATED, zlib.MAX_WBITS, 8,
                             zlib.Z_DEFAULT_STRATEGY, _CONTROL_DICT)
        return c.compress(data) + c.flush()
    if codec == "zstd+dict" and _zstd is not None:
        return _zstd.ZstdCompressor(level=3,
                                    dict_data=_ZSTD_DICT).compress(data)
    return data


def decompress(data, codec: str) -> bytes:
    # dispatch is on the FRAME header's codec string, so receivers decode
    # dictionary frames regardless of their own knobs
    if codec == "zlib":
        return zlib.decompress(data)
    if codec == "zstd" and _zstd is not None:
        return _zstd.ZstdDecompressor().decompress(data)
    if codec == "zlib+dict":
        d = zlib.decompressobj(zdict=_CONTROL_DICT)
        return d.decompress(data) + d.flush()
    if codec == "zstd+dict" and _zstd is not None:
        return _zstd.ZstdDecompressor(
            dict_data=_ZSTD_DICT).decompress(data)
    return data


_PROBE_BYTES = 4096
_PROBE_RATIO = 0.85


def _worth_compressing(body) -> bool:
    """Cheap entropy probe: compress small samples from the head, middle,
    and tail of the body; bail out early for high-entropy tensor payloads
    (random float mantissas probe at ~0.9, where a full-body compress
    costs ~16ms/MB for a marginal size win).  Three spread samples keep a
    mostly-zero body with one dense random region from skipping
    compression it would benefit from."""
    n = len(body)
    if n <= 3 * _PROBE_BYTES:
        return True
    mv = memoryview(body)
    k = _PROBE_BYTES
    sample = bytes(mv[:k]) + bytes(mv[n // 2:n // 2 + k]) + bytes(mv[n - k:])
    return len(zlib.compress(sample, 1)) < len(sample) * _PROBE_RATIO


class _FrameAssembly:
    """Multi-part frame reassembly into ONE preallocated buffer: each
    chunk is written at its header-declared offset (a single memcpy per
    part — the only copy on the receive path)."""

    __slots__ = ("buf", "n_parts", "got")

    def __init__(self, total_len: int, n_parts: int):
        self.buf = bytearray(total_len)
        self.n_parts = n_parts
        self.got: set[int] = set()

    def add(self, idx: int, offset: int, chunk) -> Optional[bytearray]:
        if idx not in self.got:
            self.got.add(idx)
            self.buf[offset:offset + len(chunk)] = chunk
        if len(self.got) == self.n_parts:
            return self.buf
        return None

    def has(self, idx: int) -> bool:
        return idx in self.got

    @property
    def nbytes(self) -> int:
        return len(self.buf)


class _LegacyAssembly:
    """Legacy reassembly (no total length on the wire): parts are kept and
    joined on completion."""

    __slots__ = ("n_parts", "parts")

    def __init__(self, n_parts: int):
        self.n_parts = n_parts
        self.parts: dict[int, bytes] = {}

    def add(self, idx: int, offset: int, chunk) -> Optional[bytes]:
        self.parts[idx] = bytes(chunk)
        if len(self.parts) == self.n_parts:
            return b"".join(self.parts[i] for i in range(self.n_parts))
        return None

    def has(self, idx: int) -> bool:
        return idx in self.parts

    @property
    def nbytes(self) -> int:
        return sum(len(p) for p in self.parts.values())


class MQTTFC:
    """Per-client fleet-control endpoint.  ``broker`` is any object
    implementing the ``repro_torch.api.transport.Transport`` protocol (the sim
    broker, a LatencyTransport decorator, a real MQTT backend, ...).

    ``wire_format`` selects the body codec for tensor-bearing payloads:
    ``"tb"`` (default) is the zero-copy TensorBundle format, ``"legacy"``
    the original msgpack-ExtType path.  Receivers always understand both
    (the frame flags carry the format), so mixed fleets interoperate.
    """

    def __init__(self, broker: "Transport", client_id: str,
                 max_batch_bytes: int = 64 * 1024,
                 codec: Optional[str] = None,
                 compress_threshold: int = 4 * 1024,
                 will_topic: Optional[str] = None,
                 will_payload: bytes = b"",
                 wire_format: str = "tb",
                 max_assemblies: int = 256,
                 control_dict: bool = True):
        assert wire_format in ("tb", "legacy"), wire_format
        self.broker = broker
        self.client_id = client_id
        self._call_ids = itertools.count(1)   # per-endpoint: deterministic
        self.max_batch_bytes = max_batch_bytes
        self.codec = codec if codec is not None else default_codec()
        self.compress_threshold = compress_threshold
        # dictionary-trained codec for small control frames (below the
        # compress threshold, which plain compression never touches)
        self.control_dict = control_dict
        self.wire_format = wire_format
        self.max_assemblies = max_assemblies
        self._fns: dict[str, Callable] = {}
        self._filter_trie = TopicTrie()       # wildcard-bound handlers
        self._dispatch_cache: dict[str, Optional[Callable]] = {}
        # incomplete multi-part frames, LRU-ordered; key=(sender, topic),
        # value = {call_id: assembly} — per-sender FIFO delivery means a
        # part for call N+1 proves call N's missing parts were lost
        self._buffers: "OrderedDict[tuple, dict[int, Any]]" = OrderedDict()
        # at-least-once dedup: highest COMPLETED call_id per (sender,
        # topic).  call_ids are monotonic per endpoint and delivery is
        # per-sender FIFO, so one highwater integer detects any broker
        # redelivery of an already-processed call; duplicate parts inside
        # a still-assembling call are caught by the assembly itself.
        # Retained replays are exempt (a re-SUBSCRIBE legitimately
        # re-delivers the same call; routed deliveries carry retain=0).
        self._dedup_hw: "OrderedDict[tuple, int]" = OrderedDict()
        self._dedup_cap = 4096
        will = Message(will_topic, will_payload, qos=1) if will_topic else None
        self.session = broker.connect(client_id, self._on_message, will=will)
        # reusable encode buffer for tensor-bearing bodies: steady-state
        # rounds re-encode the same model size, so the second call onward
        # allocates nothing for the body
        self._arena = wire.FrameArena()
        # wire-stats (paper evaluates load): logical calls vs wire messages
        self.calls_sent = 0
        self.parts_sent = 0
        self.bytes_sent = 0
        self.raw_bytes_sent = 0
        self.reassembly_evictions = 0
        self.calls_received = 0
        self.parts_received = 0
        self.bytes_received = 0
        self.duplicate_drops = 0
        self.compress_attempts = 0
        self.compress_wins = 0
        self.dict_compress_wins = 0
        self.dict_bytes_saved = 0

    # ---- binding ---------------------------------------------------------
    def bind(self, topic: str, fn: Callable, qos: int = 1) -> None:
        """Bind a remotely executable function to a topic."""
        self._fns[topic] = fn
        if "+" in topic or "#" in topic:
            self._filter_trie.insert(topic, topic)
        self._dispatch_cache.clear()
        self.broker.subscribe(self.client_id, topic, qos=qos)

    def unbind(self, topic: str) -> None:
        if self._fns.pop(topic, None) is not None and (
                "+" in topic or "#" in topic):
            self._filter_trie.remove(topic, topic)
        self._dispatch_cache.clear()
        self.broker.unsubscribe(self.client_id, topic)

    def subscribe_raw(self, topic_filter: str, fn: Callable, qos: int = 1) -> None:
        """Subscribe with wildcard support; fn receives (topic, payload)."""
        if not getattr(fn, "_raw", False):
            fn = raw_handler(fn)
        self._fns[topic_filter] = fn
        if "+" in topic_filter or "#" in topic_filter:
            self._filter_trie.insert(topic_filter, topic_filter)
        self._dispatch_cache.clear()
        self.broker.subscribe(self.client_id, topic_filter, qos=qos)

    # ---- calling ---------------------------------------------------------
    def call(self, topic: str, *args, qos: int = 1, retain: bool = False,
             quantized: bool = False, **kwargs) -> None:
        """Invoke the function bound to ``topic`` on all subscribers.
        ``quantized=True`` marks the payload as already int8-compressed:
        the recompression attempt is skipped and the frame flagged."""
        obj = {"a": list(args), "k": kwargs, "s": self.client_id}
        flags = 0
        arena_view = None
        if self.wire_format == "tb" and wire.is_wire_payload(obj):
            body = arena_view = wire.encode_body(obj, arena=self._arena)
            flags |= F_TENSORBUNDLE
        else:
            body = encode(obj)
        self.raw_bytes_sent += len(body)
        frame_codec = self.codec
        if quantized:
            flags |= F_QUANTIZED
        elif len(body) >= self.compress_threshold and _worth_compressing(body):
            self.compress_attempts += 1
            comp = compress(body, self.codec)
            if len(comp) < len(body):
                body = comp
                flags |= F_COMPRESSED
                self.compress_wins += 1
                # the compressed copy supersedes the arena body
                if arena_view is not None:
                    self._arena.release(arena_view)
                    arena_view = None
        elif self.control_dict and DICT_MIN_BYTES <= len(body):
            # small control frame: plain compression never engages below
            # the threshold, but a shared preset dictionary seeded with
            # canonical SDFLMQ control shapes routinely halves these
            comp = compress(body, dict_codec())
            if len(comp) < len(body):
                self.dict_compress_wins += 1
                self.dict_bytes_saved += len(body) - len(comp)
                body = comp
                flags |= F_COMPRESSED
                frame_codec = dict_codec()
                if arena_view is not None:
                    self._arena.release(arena_view)
                    arena_view = None
        call_id = next(self._call_ids)
        total = len(body)
        n_parts = max(1, -(-total // self.max_batch_bytes))
        self.calls_sent += 1
        # Each frame copies its chunk out of the body before publishing, so
        # handlers re-entering call() from a synchronous broker delivery
        # only ever see completed frames.  The arena checkout stays open
        # until the last chunk is copied: a re-entrant take() falls back to
        # a fresh buffer, and the ownership-checked release below ignores
        # the nested caller releasing that fallback.
        mv = memoryview(body)
        for i in range(n_parts):
            off = i * self.max_batch_bytes
            chunk = mv[off:off + self.max_batch_bytes]
            header = msgpack.packb((self.client_id, call_id, i, n_parts,
                                    flags, frame_codec, total, off))
            frame = bytearray(4 + len(header) + len(chunk))
            frame[0:4] = len(header).to_bytes(4, "big")
            frame[4:4 + len(header)] = header
            frame[4 + len(header):] = chunk
            self.parts_sent += 1
            self.bytes_sent += len(frame)
            self.broker.publish(topic, frame, qos=qos, retain=retain,
                                sender=self.client_id)
        if arena_view is not None:
            self._arena.release(arena_view)

    # ---- reassembly ------------------------------------------------------
    def _assembly_for(self, key: tuple, call_id: int, total: int,
                      n_parts: int, legacy: bool):
        calls = self._buffers.get(key)
        if calls is None:
            calls = self._buffers[key] = {}
        else:
            self._buffers.move_to_end(key)
        asm = calls.get(call_id)
        if asm is None:
            # per-sender FIFO: a part of a NEWER call proves every missing
            # part of an older incomplete call was dropped — evict them
            stale = [c for c in calls if c < call_id]
            for c in stale:
                del calls[c]
                self.reassembly_evictions += 1
            asm = calls[call_id] = (_LegacyAssembly(n_parts) if legacy
                                    else _FrameAssembly(total, n_parts))
            self._evict_lru()
        return asm

    def _evict_lru(self) -> None:
        while sum(len(c) for c in self._buffers.values()) > self.max_assemblies:
            key, calls = next(iter(self._buffers.items()))
            calls.pop(next(iter(calls)))
            self.reassembly_evictions += 1
            if not calls:
                del self._buffers[key]

    def reassembly_pending(self) -> int:
        return sum(len(c) for c in self._buffers.values())

    def wire_stats(self) -> dict:
        return {
            "calls_sent": self.calls_sent,
            "parts_sent": self.parts_sent,
            "bytes_sent": self.bytes_sent,
            "raw_bytes_sent": self.raw_bytes_sent,
            "calls_received": self.calls_received,
            "parts_received": self.parts_received,
            "bytes_received": self.bytes_received,
            "duplicate_drops": self.duplicate_drops,
            "compress_attempts": self.compress_attempts,
            "compress_wins": self.compress_wins,
            "dict_compress_wins": self.dict_compress_wins,
            "dict_bytes_saved": self.dict_bytes_saved,
            "arena_reuse_hits": self._arena.reuse_hits,
            "arena_grows": self._arena.grows,
            "arena_busy_allocs": self._arena.busy_allocs,
            "arena_capacity_bytes": len(self._arena),
            "reassembly_pending": self.reassembly_pending(),
            "reassembly_evictions": self.reassembly_evictions,
            "codec": self.codec,
            "wire_format": self.wire_format,
        }

    # ---- dispatch --------------------------------------------------------
    def _on_message(self, msg: Message) -> None:
        payload = memoryview(msg.payload)
        self.parts_received += 1
        self.bytes_received += len(payload)
        hlen = int.from_bytes(payload[:4], "big")
        header = msgpack.unpackb(payload[4:4 + hlen])
        if len(header) >= 8:
            sender, call_id, idx, n_parts, flags, codec, total, off = header[:8]
            legacy_frame = False
        else:   # legacy 6-tuple frame
            sender, call_id, idx, n_parts, flags, codec = header
            total, off = 0, 0
            legacy_frame = True
        chunk = payload[4 + hlen:]
        fresh = not msg.retain
        if fresh:
            hw = self._dedup_hw.get((sender, msg.topic))
            if hw is not None and call_id <= hw:
                # broker redelivery of an already-completed call
                self.duplicate_drops += 1
                return
        if n_parts == 1:
            body = chunk
        else:
            key = (sender, msg.topic)
            asm = self._assembly_for(key, call_id, total, n_parts,
                                     legacy_frame)
            if fresh and asm.has(idx):
                self.duplicate_drops += 1   # duplicate part, call still open
                return
            body = asm.add(idx, off, chunk)
            if body is None:
                return
            del self._buffers[key][call_id]
            if not self._buffers[key]:
                del self._buffers[key]
        if fresh:
            self._mark_completed(sender, msg.topic, call_id)
        self.calls_received += 1
        if flags & F_COMPRESSED:
            body = decompress(body, codec)
        fn = self._dispatch(msg.topic)
        if fn is None:
            return
        if flags & F_TENSORBUNDLE:
            obj = wire.decode_body(body)
        else:
            obj = decode(body if isinstance(body, bytes) else bytes(body))
        if getattr(fn, "_raw", False):
            fn(msg.topic, obj)
        else:
            fn(*obj["a"], **obj["k"])

    def _mark_completed(self, sender: str, topic: str, call_id: int) -> None:
        key = (sender, topic)
        cur = self._dedup_hw.get(key)
        if cur is None or call_id > cur:
            self._dedup_hw[key] = call_id
        self._dedup_hw.move_to_end(key)
        while len(self._dedup_hw) > self._dedup_cap:
            self._dedup_hw.popitem(last=False)

    def _dispatch(self, topic: str) -> Optional[Callable]:
        """Handler lookup: exact map hit, then the wildcard trie through a
        per-topic cache (invalidated on bind/unbind)."""
        fn = self._fns.get(topic)
        if fn is not None:
            return fn
        if topic in self._dispatch_cache:
            return self._dispatch_cache[topic]
        filts = self._filter_trie.match(topic)
        fn = self._fns.get(filts[0]) if filts else None
        self._dispatch_cache[topic] = fn
        return fn

    def close(self, graceful: bool = True) -> None:
        self.broker.disconnect(self.client_id, graceful=graceful)


def raw_handler(fn):
    """Mark a handler as wanting (topic, payload) instead of (*args)."""
    def wrapper(topic, payload):
        return fn(topic, payload)
    wrapper._raw = True
    return wrapper
