"""The program's own spans in a traced run: the `rfx.*` spans that
`rfx_torch.utils.profiling` opens, which the profiler records as host
operators on the clock of the device's records (`Trace.host`). A reader takes
those that lie inside a traced unit's span. A program without such spans
gives no events, and its readers return None."""

from __future__ import annotations

import bisect

from gpubench.harness.profile import Trace, union

__all__ = ["PREFIX", "in_units", "seconds"]

PREFIX = "rfx."


def in_units(trace: Trace, prefix: str = PREFIX) -> list[tuple[float, float, str]] | None:
    """The host spans whose name starts with `prefix` and that lie inside some
    traced unit; None where the trace holds no `rfx.*` span at all."""
    mine = [h for h in trace.host if h[2].startswith(PREFIX)]
    if not mine:
        return None
    starts = [u[0] for u in trace.units]
    out = []
    for s, e, name in mine:
        i = bisect.bisect_right(starts, s) - 1
        if name.startswith(prefix) and i >= 0 and e <= trace.units[i][1]:
            out.append((s, e, name))
    return out


def seconds(intervals) -> float:
    """Seconds that the union of the intervals covers."""
    return sum(e - s for s, e in union(intervals))
