"""The share, %, of the rays the fused kernel walked in the traced units that
it walked nearer child first over the BVH's child-pair table, from the
program's counters (`rfx_torch.utils.profiling.counters()`: `rays_near_first`
of `rays_fused`), which count only while a profiler records: the traced
units. 0 where the program has no such tally (it walks every tree in
preorder); None without a traced unit, without counters, or where the fused
kernel walked no ray on the card."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None or not trace.units:
        return None
    c = counters()
    if not c.get("rays_fused"):
        return None
    return 100.0 * c.get("rays_near_first", 0) / c["rays_fused"]
