"""A profiled stretch of rounds, reduced: the device's operations, the
host's ranges, and the window between them.

``Trace.from_profiler`` reads a finished ``torch.profiler.profile`` from
its raw (kineto) events: every device event that is a kernel, a copy or a
fill (the program's ``record_function`` ranges also appear on the device,
as annotations, and are left out there), each with the host time of the
runtime call that launched it; every host range named ``fl/...``,
``train/...`` or ``fedbench/...``; and the ``fedbench/profiled`` range
that the harness opens around the rounds.  A range's device time is that
of the device events launched while it was open.  Times are seconds on the
profiler's clock.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

RANGES = ("fl/", "train/", "fedbench/")
WINDOW = "fedbench/profiled"


def _on_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


@dataclass
class Trace:
    kernels: list = field(default_factory=list)    # (name, start, end, launch)
    ranges: list = field(default_factory=list)     # (name, start, end)
    window: tuple = (0.0, 0.0)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        out = cls()
        events = prof.profiler.kineto_results.events()
        launch, ops = {}, {}
        for ev in events:
            if _on_device(ev):
                continue
            t = ev.start_ns() / 1e9
            name = ev.name()
            if name.startswith(("cuda", "cu")):      # the launch calls
                launch[ev.correlation_id()] = t
            else:
                ops[ev.correlation_id()] = t
            if name.startswith(RANGES):
                out.ranges.append((name, t, ev.end_ns() / 1e9))
        for ev in events:
            if not _on_device(ev) or ev.is_user_annotation() or \
                    ev.name().startswith(RANGES):
                continue
            at = launch.get(ev.correlation_id(),
                            ops.get(ev.linked_correlation_id()))
            out.kernels.append((ev.name(), ev.start_ns() / 1e9,
                                ev.end_ns() / 1e9, at))
        wins = [r for r in out.ranges if r[0] == WINDOW]
        if wins:
            out.window = wins[0][1:]
        elif out.kernels:
            out.window = (min(k[1] for k in out.kernels),
                          max(k[2] for k in out.kernels))
        out.kernels.sort(key=lambda k: k[1])
        return out

    # -- the device ------------------------------------------------------
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device events' intervals inside the window."""
        w0, w1 = self.window
        merged = []
        for _, s, e, _ in self.kernels:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_totals(self) -> dict:
        """{name: (seconds, count)} of the device events in the window."""
        tot = defaultdict(lambda: [0.0, 0])
        w0, w1 = self.window
        for name, s, e, _ in self.kernels:
            if s >= w0 and e <= w1:
                tot[name][0] += e - s
                tot[name][1] += 1
        return {k: tuple(v) for k, v in tot.items()}

    # -- the host --------------------------------------------------------
    def range_totals(self, name: str) -> tuple[float, float, int]:
        """(host seconds, device seconds, count) of the ranges ``name``:
        the device seconds of the events launched inside them."""
        rs = sorted((s, e) for n, s, e in self.ranges if n == name)
        dev = 0.0
        for _, s, e, at in self.kernels:
            if at is not None and any(a <= at <= b for a, b in rs):
                dev += e - s
        return sum(e - s for s, e in rs), dev, len(rs)

    def _open_range(self, t: float) -> str:
        """The innermost program range open on the host at ``t``."""
        best = None
        for name, s, e in self.ranges:
            if name == WINDOW or not (s <= t <= e):
                continue
            if best is None or s >= best[1]:
                best = (name, s)
        return best[0] if best else "outside any range"

    def idle_gaps(self) -> dict:
        """{host range open at the gap's middle: idle device seconds}."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy_intervals() for x in iv] + [w1]
        out = defaultdict(float)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                out[self._open_range((s + e) / 2)] += e - s
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, v[0]) for n, v in self.kernel_totals().items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
