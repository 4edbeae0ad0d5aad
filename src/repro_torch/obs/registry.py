"""Metrics registry: counters, gauges, histograms with labels.

Zero-dependency, pull-friendly. Instruments are created through a
:class:`MetricsRegistry` and rendered either as the Prometheus text
exposition format (``render_prom()``) or as a JSON-safe ``snapshot()``.
Registered *collectors* run just before every render/snapshot so that
cheap source-of-truth counters (broker ``$SYS`` dicts, ``wire_stats()``,
accumulator arenas) can be mirrored into the registry lazily instead of
taxing the hot path.

Quick tour (doctested):

>>> from repro_torch.obs.registry import MetricsRegistry
>>> reg = MetricsRegistry()
>>> c = reg.counter("sdflmq_demo_total", "Demo counter", labels=("kind",))
>>> c.labels(kind="publish").inc()
>>> c.labels(kind="publish").inc(2)
>>> c.labels(kind="publish").value
3.0
>>> g = reg.gauge("sdflmq_queue_depth", "Messages waiting")
>>> g.set(7)
>>> h = reg.histogram("sdflmq_lat_seconds", "Latency", buckets=(0.1, 1.0))
>>> h.observe(0.05); h.observe(3.0)
>>> print(reg.render_prom())
# HELP sdflmq_demo_total Demo counter
# TYPE sdflmq_demo_total counter
sdflmq_demo_total{kind="publish"} 3
# HELP sdflmq_queue_depth Messages waiting
# TYPE sdflmq_queue_depth gauge
sdflmq_queue_depth 7
# HELP sdflmq_lat_seconds Latency
# TYPE sdflmq_lat_seconds histogram
sdflmq_lat_seconds_bucket{le="0.1"} 1
sdflmq_lat_seconds_bucket{le="1.0"} 1
sdflmq_lat_seconds_bucket{le="+Inf"} 2
sdflmq_lat_seconds_sum 3.05
sdflmq_lat_seconds_count 2
<BLANKLINE>
>>> reg.series_count()
7
>>> snap = reg.snapshot()
>>> snap["sdflmq_demo_total"]["samples"]['kind="publish"']
3.0

Re-requesting a metric with the same name returns the same family; a
kind or label mismatch raises:

>>> reg.counter("sdflmq_demo_total", labels=("kind",)) is c
True
>>> reg.gauge("sdflmq_demo_total")
Traceback (most recent call last):
    ...
ValueError: metric 'sdflmq_demo_total' already registered as counter
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram"]

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral floats render without '.0'."""
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        return {float("inf"): "+Inf", float("-inf"): "-Inf"}.get(f, "NaN")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotonically increasing sample."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Sample that can go up, down, or be set outright."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative histogram over fixed upper bounds (plus +Inf)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        i = bisect.bisect_left(self.buckets, v)
        if i < len(self.buckets):
            self.counts[i] += 1

    @property
    def value(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.sum,
            "buckets": {_fmt(ub): c for ub, c in zip(self.buckets, self.counts)},
        }


_CHILD_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named metric with a fixed label set; children keyed by label values."""

    __slots__ = ("kind", "name", "help", "label_names", "buckets", "_children", "_lock")

    def __init__(self, kind: str, name: str, help: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = label_names
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **kv: object):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric '{self.name}' takes labels {self.label_names}, got {tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "histogram":
                        child = Histogram(self.buckets or DEFAULT_BUCKETS)
                    else:
                        child = _CHILD_TYPES[self.kind]()
                    self._children[key] = child
        return child

    # Label-less convenience: a family with no labels behaves as its own child.
    def _default(self):
        if self.label_names:
            raise ValueError(
                f"metric '{self.name}' has labels {self.label_names}; call .labels() first"
            )
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self):
        return self._default().value

    # -- rendering -------------------------------------------------------
    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        pairs = ",".join(
            f'{n}="{_escape_label(v)}"' for n, v in zip(self.label_names, key)
        )
        return "{" + pairs + "}"

    def render(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._children):
            child = self._children[key]
            lbl = self._label_str(key)
            if self.kind == "histogram":
                cum = 0
                for ub, c in zip(child.buckets, child.counts):
                    cum += c
                    le = self._bucket_label(key, ub)
                    out.append(f"{self.name}_bucket{le} {cum}")
                le = self._bucket_label(key, float("inf"))
                out.append(f"{self.name}_bucket{le} {child.count}")
                out.append(f"{self.name}_sum{lbl} {_fmt(child.sum)}")
                out.append(f"{self.name}_count{lbl} {child.count}")
            else:
                out.append(f"{self.name}{lbl} {_fmt(child.value)}")

    def _bucket_label(self, key: Tuple[str, ...], ub: float) -> str:
        le = "+Inf" if ub == float("inf") else _fmt(float(ub)) if float(ub) != int(ub) else repr(float(ub))
        pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(self.label_names, key)]
        pairs.append(f'le="{le}"')
        return "{" + ",".join(pairs) + "}"

    def samples(self) -> Dict[str, object]:
        return {
            self._label_str(k).strip("{}"): self._children[k].value
            for k in sorted(self._children)
        }

    def n_series(self) -> int:
        if self.kind == "histogram":
            per = 0
            for child in self._children.values():
                per += len(child.buckets) + 3  # +Inf bucket, _sum, _count
            return per
        return len(self._children)


class MetricsRegistry:
    """Create-or-get instrument factory plus exposition surface.

    See the module docstring for a doctested tour of the public API:
    :meth:`counter`, :meth:`gauge`, :meth:`histogram`,
    :meth:`register_collector`, :meth:`render_prom`, :meth:`snapshot`,
    and :meth:`series_count`.
    """

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- instrument factories -------------------------------------------
    def _family(self, kind: str, name: str, help: str,
                labels: Iterable[str],
                buckets: Optional[Tuple[float, ...]] = None) -> _Family:
        label_names = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric '{name}' already registered as {fam.kind}"
                    )
                if fam.label_names != label_names:
                    raise ValueError(
                        f"metric '{name}' already registered with labels {fam.label_names}"
                    )
                return fam
            fam = _Family(kind, name, help, label_names, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()) -> _Family:
        return self._family("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> _Family:
        return self._family("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> _Family:
        return self._family("histogram", name, help, labels,
                            tuple(sorted(float(b) for b in buckets)))

    # -- collectors ------------------------------------------------------
    def register_collector(self, fn: Callable[[], None]) -> None:
        """Register a zero-arg callable run before every render/snapshot."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    # -- exposition ------------------------------------------------------
    def render_prom(self) -> str:
        """Render the Prometheus text exposition format (version 0.0.4)."""
        self.collect()
        out: List[str] = []
        for name in self._families:  # insertion (registration) order
            self._families[name].render(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-safe dump: {name: {kind, help, samples: {labelstr: value}}}."""
        self.collect()
        return {
            name: {"kind": fam.kind, "help": fam.help, "samples": fam.samples()}
            for name, fam in self._families.items()
        }

    def series_count(self) -> int:
        """Number of exposed sample lines (one per labeled time series)."""
        self.collect()
        return sum(f.n_series() for f in self._families.values())
