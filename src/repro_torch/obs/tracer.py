"""Round-lifecycle tracer: structured events in a bounded ring buffer.

Each event is a flat dict ``{"t": <timestamp>, "kind": <str>, ...fields}``.
Timestamps come from a pluggable clock: pass the federation's
:class:`~repro_torch.api.transport.SimClock` to get *virtual* seconds (so traces
from simulated runs line up with ``virtual_time_s`` in reports), or no
clock to fall back to wall time (``time.time()``).

The ring is bounded (``maxlen``): old events are dropped, never the run.
``dropped`` counts what fell off so exports can flag truncation.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Tracer"]

# Noisy data-plane kinds excluded from compact timelines by default.
NOISY_KINDS = ("publish", "deliver")


class Tracer:
    __slots__ = ("_ring", "_clock", "maxlen", "emitted", "dropped")

    def __init__(self, clock: Optional[object] = None, maxlen: int = 4096) -> None:
        self._ring: deque = deque(maxlen=maxlen)
        self._clock = clock
        self.maxlen = maxlen
        self.emitted = 0
        self.dropped = 0

    def now(self) -> float:
        if self._clock is not None:
            return float(self._clock.now)
        return time.time()

    def emit(self, kind: str, **fields: object) -> None:
        if len(self._ring) == self.maxlen:
            self.dropped += 1
        ev: Dict[str, object] = {"t": round(self.now(), 6), "kind": kind}
        ev.update(fields)
        self._ring.append(ev)
        self.emitted += 1

    # -- reads -----------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Dict[str, object]]:
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e["kind"] == kind]

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self._ring:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def clear(self) -> None:
        self._ring.clear()

    def timeline(self, include: Optional[Iterable[str]] = None,
                 exclude: Iterable[str] = NOISY_KINDS) -> List[Tuple[float, str]]:
        """Compact ``(t, label)`` view, sorted by timestamp.

        ``label`` is the event kind followed by its fields as ``k=v`` pairs,
        e.g. ``('partition', ...)`` renders as ``"partition groups=2"``.
        ``include`` (when given) whitelists kinds; otherwise ``exclude``
        drops the noisy data-plane kinds (publish/deliver) so control-plane
        structure — rounds, partitions, heals, mints — stays readable.
        """
        inc = set(include) if include is not None else None
        exc = set(exclude)
        out: List[Tuple[float, str]] = []
        for e in self._ring:
            k = e["kind"]
            if inc is not None:
                if k not in inc:
                    continue
            elif k in exc:
                continue
            extras = " ".join(
                f"{n}={e[n]}" for n in e if n not in ("t", "kind")
            )
            out.append((e["t"], f"{k} {extras}" if extras else str(k)))
        out.sort(key=lambda p: p[0])
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        """Full event dump plus ring metadata, as a JSON document."""
        return json.dumps(
            {
                "emitted": self.emitted,
                "dropped": self.dropped,
                "clock": "virtual" if self._clock is not None else "wall",
                "events": list(self._ring),
            },
            indent=indent,
            default=str,
        )
