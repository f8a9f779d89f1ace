"""K2's share of its roofline, percent: the least time of a sweep's
environment queries (51 f32 operations a live query, the live queries from
the reference's environment trace of the check's direction sets, against
each query's ray in and answer out and the mesh once;
`reference/counts_env.py`) over the device time a sweep of
`closest_hit_kernel`. None where the trace holds none (a sweep whose
environment trace takes another kernel)."""

from gpubench.harness.profile import per_unit
from gpubench.reference.counts_env import k2_work
from gpubench.reference.peaks import bound_s


def read(trace, spec):
    if "live_segments" not in trace.counts:
        return None
    n, seconds = per_unit(trace, lambda name: "closest_hit_kernel" in name)
    if n == 0:
        return None
    n_bytes, flops = k2_work(live_queries=trace.counts["live_segments"],
                             faces=trace.shapes["faces"])
    return 100.0 * bound_s(n_bytes, flops) / seconds
