"""K-F's share of its roofline, percent: the least time of a sweep's phasor
metric (17 f32 operations a live segment and receiver, the live segments from
the reference's environment trace of the check's direction sets, against the
segments in and six f32 sums a receiver out; `reference/counts_phasor.py`)
over the device time a sweep of the forward phasor kernels: the table, the
walk and its reduction, the rewalk of lost lists and the spread. The
backward's kernels are not counted. None where the trace holds none."""

from gpubench.harness.profile import per_unit
from gpubench.reference.counts_phasor import kf_work
from gpubench.reference.peaks import bound_s

KERNELS = ("phasor_table_kernel", "coverage_phasor_kernel", "phasor_reduce_kernel",
           "coverage_phasor_rewalk_kernel", "phasor_spread_kernel")


def read(trace, spec):
    if "live_segments" not in trace.counts:
        return None
    s = trace.shapes
    n, seconds = per_unit(trace, lambda name: any(k in name for k in KERNELS))
    if n == 0:
        return None
    n_bytes, flops = kf_work(live_segments=trace.counts["live_segments"],
                             segments=s["rays"] * s["bounces"], receivers=s["receivers"])
    return 100.0 * bound_s(n_bytes, flops) / seconds
