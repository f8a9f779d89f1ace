"""The share, %, of the rays the fused kernel walked in the traced units that
it walked in direction-cell order, from the program's counters
(`rfx_torch.utils.profiling.counters()`: `rays_ordered` of `rays_fused`),
which count only while a profiler records: the traced units. None where the
program has no such counters or walked no ray on the card."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None or not trace.units:
        return None
    c = counters()
    if not c.get("rays_fused"):
        return None
    return 100.0 * c.get("rays_ordered", 0) / c["rays_fused"]
