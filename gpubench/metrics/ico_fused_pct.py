"""The share, %, of the traced units' rays that the fused kernel walked with
the icosphere receiver, from the program's counters
(`rfx_torch.utils.profiling.counters()`: `rays_fused_ico`, which counts only
while a profiler records: the traced units) over the cell's rays a unit
times the traced units. None without a traced unit or without counters; 0
where the program has no such tally (its icosphere requests take another
path)."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None or not trace.units:
        return None
    rays = trace.shapes.get("rays")
    if not rays:
        return None
    return 100.0 * counters().get("rays_fused_ico", 0) / (rays * len(trace.units))
