"""Device time from the profiler's raw records of a traced run.

`torch.profiler` with CUDA activity records each kernel, memset and copy on
the device with its own start and end; those records (from `prof.events()`,
not `key_averages()`, which drops the kernels the port launches through
ctypes) are what `busy`, the idle gaps and every per-layer metric read. The
benchmark marks each traced unit (a request, a sweep, a step) with a
`record_function` span named `UNIT`, so a reader can cut the device records
by unit. Times are seconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

__all__ = ["UNIT", "Trace", "collect", "union", "covered", "idle_gaps", "device_ops"]

UNIT = "gpubench.unit"


@dataclass
class Trace:
    units: list[tuple[float, float]]  # each traced unit's host span
    device: list[tuple[float, float, str]]  # each kernel / memset / copy record
    host: list[tuple[float, float, str]] = field(default_factory=list)  # host operators
    counts: dict = field(default_factory=dict)  # what the reference counted on these inputs
    shapes: dict = field(default_factory=dict)  # the cell's sizes

    @property
    def window(self) -> tuple[float, float]:
        return self.units[0][0], self.units[-1][1]

    def in_units(self, pred=lambda name: True) -> list[tuple[float, float, str]]:
        """The device records inside some unit's span whose name passes `pred`."""
        out = []
        spans = self.units
        for s, e, name in self.device:
            if pred(name) and any(a <= s and e <= b for a, b in _near(spans, s)):
                out.append((s, e, name))
        return out


def _near(spans, t):
    """The spans that could hold time t (spans are sorted and disjoint)."""
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][1] < t:
            lo = mid + 1
        else:
            hi = mid
    return spans[lo:lo + 1]


def union(intervals) -> list[tuple[float, float]]:
    merged = []
    for s, e in sorted((iv[0], iv[1]) for iv in intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def covered(intervals, a: float, b: float) -> float:
    """Seconds of [a, b] that some interval covers."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in union(intervals))


def _is_device(ev) -> bool:
    return "CUDA" in str(getattr(ev, "device_type", ""))


def collect(prof) -> Trace:
    """The units, device records and host operators of a finished profile."""
    units, device, host = [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name == UNIT:
            if not _is_device(ev):
                units.append((s, e))
            continue
        if getattr(ev, "is_user_annotation", False):
            continue
        if _is_device(ev):
            device.append((s, e, ev.name))
        else:
            host.append((s, e, ev.name))
    units.sort()
    device.sort()
    host.sort()
    return Trace(units, device, host)


def idle_gaps(trace: Trace, top: int = 10) -> list[list]:
    """The longest idle stretches of the device inside the traced window,
    summed by the innermost host operator running at each one's middle."""
    a, b = trace.window
    busy = [iv for iv in union(trace.device) if iv[1] > a and iv[0] < b]
    gaps, t = [], a
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < b:
        gaps.append((t, b))
    host = trace.host
    starts = [h[0] for h in host]
    by_name: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = "python (no operator)"
        # The innermost operator holding `mid` starts last among those that
        # hold it; operators nest, so it lies among the few just before mid.
        for i in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 400), -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(trace: Trace, top: int = 10) -> list[list]:
    """The device records that took most time inside the window, summed by name."""
    a, b = trace.window
    by_name: dict[str, float] = {}
    for s, e, name in trace.device:
        if s >= a and e <= b:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


# -- what the per-layer readers share ------------------------------------


def host_ms(trace: Trace) -> float:
    """Mean over the traced units of each unit's span less the device's busy
    time inside it, in ms: the host's share of a unit."""
    busy = union(trace.device)
    starts = [b[0] for b in busy]
    total = 0.0
    for a, b in trace.units:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        on = 0.0
        while i < len(busy) and busy[i][0] < b:
            on += max(0.0, min(busy[i][1], b) - max(busy[i][0], a))
            i += 1
        total += (b - a) - on
    return total / len(trace.units) * 1e3


def per_unit(trace: Trace, pred) -> tuple[int, float]:
    """(records, seconds) a traced unit of the device records inside units
    whose name passes `pred`."""
    recs = trace.in_units(pred)
    n = len(trace.units)
    return len(recs) / n, sum(e - s for s, e, _ in recs) / n


def idle_pct(trace: Trace) -> float:
    a, b = trace.window
    return 100.0 * (1.0 - covered(trace.device, a, b) / (b - a))


def roofline_pct(trace: Trace, pred, bound_s: float) -> float | None:
    """bound_s, the least time of one launch's work, against the mean time of
    the launches whose name passes `pred`, in percent; None without one."""
    recs = trace.in_units(pred)
    if not recs:
        return None
    return 100.0 * bound_s * len(recs) / sum(e - s for s, e, _ in recs)
