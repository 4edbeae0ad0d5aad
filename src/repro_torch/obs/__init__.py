"""repro_torch.obs — zero-dependency telemetry for SDFLMQ federations.

The paper pitches SDFLMQ as a *real-time service at the edge*; this package
turns the repo's scattered per-object counters ($SYS stats, ``wire_stats``,
accumulator arenas, async admission counts, coordinator deadlines) into one
operational surface:

  * :class:`MetricsRegistry` — counters, gauges, and histograms with
    labels, rendered in the Prometheus text exposition format
    (``render_prom()``) or as a JSON-safe ``snapshot()``,
  * :class:`Tracer` — structured round-lifecycle events (publish/deliver/
    train/contribute/flush/mint/partition/heal/...) with virtual-or-wall
    timestamps in a bounded ring buffer, exportable as JSON timelines,
  * :func:`serve_metrics` — a one-liner stdlib-HTTP ``/metrics`` endpoint,
  * :class:`Telemetry` — the facade ``Federation(metrics=...)`` wires
    through the whole stack (pull collectors over every component's
    existing stats surface + push hooks at control-plane event points).

Everything is opt-in: with ``Federation(metrics=None)`` (the default) no
object from this package is ever constructed and the hot paths take the
exact pre-telemetry branches, so the zero-overhead default stays
bit-identical.
"""
from __future__ import annotations

from repro_torch.obs.exporters import (render_prom, serve_metrics, timeline_json,
                                 write_timeline_json)
from repro_torch.obs.instrument import SYS_CORE, Telemetry
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import Tracer

__all__ = [
    "MetricsRegistry",
    "Tracer",
    "Telemetry",
    "SYS_CORE",
    "render_prom",
    "serve_metrics",
    "timeline_json",
    "write_timeline_json",
]
