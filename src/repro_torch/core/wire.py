"""TensorBundle — the zero-copy model wire format (SDFLMQ data plane).

The legacy msgpack path copies every model ~5x per tree hop: ExtType
``tobytes()`` per array, whole-body compression, per-part chunk slicing,
``frombuffer().copy()`` on receive, and fresh float64 dicts in the
aggregator.  This module replaces that with a flatten-once layout:

  * ``TensorBundle.from_params`` flattens a params dict into ONE contiguous
    buffer + a compact schema (name/dtype/shape/offset per tensor).  Each
    source array is copied exactly once, into its slot.
  * ``TensorStack`` is n bundle-rows laid out back to back (one schema),
    the unit "stack"-reduction strategies gather up the tree.  Heads
    forward collected rows as a single memoryview slice — leaves are never
    re-serialized.
  * ``encode_body``/``decode_body`` carry arbitrary msgpack-able call
    payloads whose tensors live in a trailing data region; encode writes
    everything into one preallocated buffer, decode returns zero-copy
    ``np.frombuffer`` views over the received body.

Layout of an encoded body::

    [4B table len][msgpack tensor table][4B meta len][msgpack meta][data]

where the meta is the payload with each tensor replaced by an ExtType
placeholder indexing the table, and table entries hold (kind, dtype/schema,
shape/n, offset, nbytes) with offsets relative to the data region.
Dtype strings keep their byte order (e.g. ``<f4``/``>f4``), so a decoded
view is correct on any endianness.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

import msgpack
import numpy as np

# ExtType codes in the meta document
_EXT_ARRAY = 43
_EXT_BUNDLE = 44
_EXT_STACK = 45


def _dtype_str(dt: np.dtype) -> str:
    # '|' (not applicable) stays; native '=' is resolved to an explicit
    # byte order so the wire is unambiguous between hosts
    return dt.str


class TensorBundle:
    """A params dict flattened once into one contiguous buffer.

    ``schema`` is a tuple of ``(name, dtype_str, shape, offset, nbytes)``;
    ``buffer`` is any contiguous bytes-like (bytes/bytearray/memoryview).
    ``views()`` returns zero-copy ndarray views over the buffer.
    """

    __slots__ = ("schema", "buffer", "_views")

    def __init__(self, schema, buffer):
        self.schema = tuple(
            (n, d, tuple(s), o, b) for n, d, s, o, b in schema)
        self.buffer = buffer
        self._views: Optional[dict[str, np.ndarray]] = None

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_params(cls, params: dict) -> "TensorBundle":
        """Flatten once: one allocation, one memcpy per tensor."""
        schema = []
        off = 0
        arrs = []
        for name in params:
            # asarray(order="C"), not ascontiguousarray: the latter
            # promotes 0-d arrays to 1-d and would corrupt the schema
            a = np.asarray(params[name], order="C")
            if a.dtype.hasobject:
                raise TypeError(f"cannot wire-encode object dtype: {name!r}")
            schema.append((name, _dtype_str(a.dtype), a.shape, off, a.nbytes))
            arrs.append(a)
            off += a.nbytes
        buf = bytearray(off)
        mv = memoryview(buf)
        for (name, _d, _s, o, nb), a in zip(schema, arrs):
            if nb:
                mv[o:o + nb] = memoryview(a).cast("B")
        return cls(schema, buf)

    # ---- access ----------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return sum(b for *_x, b in self.schema)

    def keys(self):
        return [n for n, *_x in self.schema]

    def views(self) -> dict[str, np.ndarray]:
        """Zero-copy ndarray views over the underlying buffer."""
        if self._views is None:
            mv = memoryview(self.buffer)
            out = {}
            for name, dstr, shape, off, nb in self.schema:
                dt = np.dtype(dstr)
                n = nb // dt.itemsize if dt.itemsize else 0
                out[name] = np.frombuffer(mv, dtype=dt, count=n,
                                          offset=off).reshape(shape)
            self._views = out
        return self._views

    def view(self, name: str) -> np.ndarray:
        return self.views()[name]

    def to_params(self) -> dict[str, np.ndarray]:
        return dict(self.views())

    def layout_matches(self, other: "TensorBundle") -> bool:
        return self.schema == other.schema


class TensorStack:
    """``n`` TensorBundle rows (one shared ``schema``) laid out back to
    back in one buffer — the forwarding unit for stack-reduction
    strategies.  ``stacked_views()`` exposes per-tensor ``(n, *shape)``
    strided views without copying a byte."""

    __slots__ = ("schema", "n", "buffer")

    def __init__(self, schema, n: int, buffer):
        self.schema = tuple((nm, d, tuple(s), o, b) for nm, d, s, o, b in schema)
        self.n = int(n)
        self.buffer = buffer

    @property
    def row_nbytes(self) -> int:
        return sum(b for *_x, b in self.schema)

    @property
    def nbytes(self) -> int:
        return self.n * self.row_nbytes

    def stacked_views(self) -> dict[str, np.ndarray]:
        """Per-tensor zero-copy views of shape ``(n, *shape)``: one strided
        view over the row-major buffer per key — no per-key np.stack."""
        stride = self.row_nbytes
        mv = memoryview(self.buffer).cast("B")
        out = {}
        for name, dstr, shape, off, nb in self.schema:
            dt = np.dtype(dstr)
            if self.n == 0 or nb == 0:
                out[name] = np.empty((self.n,) + shape, dtype=dt)
                continue
            # row stride = whole-row bytes; within a row, the tensor is
            # C-contiguous at its schema offset
            elem_strides = tuple(
                np.empty(shape, dtype=dt).strides) if shape else ()
            out[name] = np.ndarray(shape=(self.n,) + shape, dtype=dt,
                                   buffer=mv, offset=off,
                                   strides=(stride,) + elem_strides)
        return out


# ---------------------------------------------------------------------------
# Body codec
# ---------------------------------------------------------------------------

class FrameArena:
    """Grow-only reusable encode buffer.

    ``take(n)`` hands out a writable ``memoryview`` over a per-instance
    bytearray, growing it only when ``n`` exceeds the current capacity —
    so steady-state encodes (the common FL case: same model, every round)
    stop allocating entirely.  The arena is single-checkout: while a view
    is outstanding (``release()`` not yet called), a nested ``take``
    falls back to a fresh allocation instead of corrupting the in-flight
    frame (re-entrant encodes happen when a broker delivers synchronously
    and the handler publishes through the same endpoint).  Pass that view
    back to ``release(view)`` to make the release ownership-checked: a
    re-entrant caller releasing its fallback buffer is then a no-op, so
    the outer checkout stays protected.
    """

    __slots__ = ("_buf", "_in_use", "reuse_hits", "grows", "busy_allocs")

    def __init__(self, initial: int = 0) -> None:
        self._buf = bytearray(initial)
        self._in_use = False
        self.reuse_hits = 0      # takes served from the existing buffer
        self.grows = 0           # takes that had to reallocate larger
        self.busy_allocs = 0     # re-entrant takes served off-arena

    def __len__(self) -> int:
        return len(self._buf)

    def take(self, n: int):
        if self._in_use:
            self.busy_allocs += 1
            return memoryview(bytearray(n))
        if len(self._buf) < n:
            self._buf = bytearray(n)
            self.grows += 1
        else:
            self.reuse_hits += 1
        self._in_use = True
        return memoryview(self._buf)[:n]

    def release(self, view=None) -> None:
        if view is None or getattr(view, "obj", None) is self._buf:
            self._in_use = False


def encode_body(obj: Any, arena: "FrameArena | None" = None) -> bytearray:
    """Encode a call payload into ONE preallocated buffer.  Tensors
    (ndarray / TensorBundle / TensorStack) are copied exactly once, into
    the trailing data region; everything else is msgpack.

    With ``arena`` the buffer is checked out of a reusable
    :class:`FrameArena` (returned as a writable memoryview; the caller
    must ``arena.release()`` once the frame bytes have been copied out)
    instead of freshly allocated.  Every byte of the returned buffer is
    written either way, so arena reuse cannot leak stale data."""
    table: list = []
    segments: list = []          # contiguous bytes-like per table entry
    data_len = 0

    def _hook(o):
        nonlocal data_len
        if isinstance(o, TensorBundle):
            idx = len(table)
            table.append(("b", list(o.schema), data_len, o.nbytes))
            segments.append(memoryview(o.buffer).cast("B"))
            data_len += o.nbytes
            return msgpack.ExtType(_EXT_BUNDLE, msgpack.packb(idx))
        if isinstance(o, TensorStack):
            idx = len(table)
            table.append(("s", list(o.schema), o.n, data_len, o.nbytes))
            segments.append(memoryview(o.buffer).cast("B"))
            data_len += o.nbytes
            return msgpack.ExtType(_EXT_STACK, msgpack.packb(idx))
        if isinstance(o, np.ndarray):
            a = np.asarray(o, order="C")
            if a.dtype.hasobject:
                raise TypeError("cannot wire-encode object dtype array")
            idx = len(table)
            table.append(("a", _dtype_str(a.dtype), list(a.shape),
                          data_len, a.nbytes))
            segments.append(memoryview(a).cast("B") if a.nbytes else b"")
            data_len += a.nbytes
            return msgpack.ExtType(_EXT_ARRAY, msgpack.packb(idx))
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, (np.floating, np.float16)):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
        raise TypeError(f"cannot serialize {type(o)}")

    meta = msgpack.packb(obj, default=_hook, use_bin_type=True)
    tbl = msgpack.packb(table, use_bin_type=True)
    head_len = 4 + len(tbl) + 4 + len(meta)
    total = head_len + data_len
    out = arena.take(total) if arena is not None else bytearray(total)
    out[0:4] = len(tbl).to_bytes(4, "big")
    out[4:4 + len(tbl)] = tbl
    mo = 4 + len(tbl)
    out[mo:mo + 4] = len(meta).to_bytes(4, "big")
    out[mo + 4:head_len] = meta
    mv = memoryview(out)
    off = head_len
    for seg in segments:
        n = len(seg)
        if n:
            mv[off:off + n] = seg
        off += n
    return out


def decode_body(body) -> Any:
    """Decode an ``encode_body`` buffer; tensor leaves come back as
    zero-copy views (ndarray) / view-holding TensorBundle / TensorStack
    over ``body`` — nothing in the data region is copied."""
    mv = memoryview(body)
    tlen = int.from_bytes(mv[0:4], "big")
    table = msgpack.unpackb(mv[4:4 + tlen], raw=False)
    mo = 4 + tlen
    mlen = int.from_bytes(mv[mo:mo + 4], "big")
    meta = mv[mo + 4:mo + 4 + mlen]
    # read-only data region: an uncompressed single-part frame is SHARED
    # by every subscriber (and the retained-message store) — a writable
    # view would let one receiver silently corrupt the others
    data = mv[mo + 4 + mlen:].toreadonly()

    def _resolve(code, payload):
        idx = msgpack.unpackb(payload)
        ent = table[idx]
        if code == _EXT_ARRAY:
            _k, dstr, shape, off, nb = ent
            dt = np.dtype(dstr)
            n = nb // dt.itemsize if dt.itemsize else 0
            return np.frombuffer(data, dtype=dt, count=n,
                                 offset=off).reshape(shape)
        if code == _EXT_BUNDLE:
            _k, schema, off, nb = ent
            return TensorBundle(schema, data[off:off + nb])
        if code == _EXT_STACK:
            _k, schema, n, off, nb = ent
            return TensorStack(schema, n, data[off:off + nb])
        return msgpack.ExtType(code, payload)

    return msgpack.unpackb(meta, ext_hook=_resolve, raw=False,
                           strict_map_key=False)


def is_wire_payload(obj: Any) -> bool:
    """Does ``obj`` contain tensors that want the TensorBundle format?"""
    if isinstance(obj, (TensorBundle, TensorStack, np.ndarray)):
        return True
    if isinstance(obj, dict):
        return any(is_wire_payload(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(is_wire_payload(v) for v in obj)
    return False
