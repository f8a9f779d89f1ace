"""K3's share of its roofline, percent: the least time of a sweep's
histograms (17 f32 operations a live segment and receiver, the live segments
from the reference's environment trace of the check's direction sets,
against the segments in and the IRs out) over the device time a sweep of
`coverage_hist_kernel` and `coverage_reduce_kernel` together."""

from gpubench.harness.profile import per_unit
from gpubench.reference.counts import k3_work
from gpubench.reference.peaks import bound_s


def read(trace, spec):
    if "live_segments" not in trace.counts:
        return None
    s = trace.shapes
    n, seconds = per_unit(trace, lambda name: "coverage_hist_kernel" in name
                          or "coverage_reduce_kernel" in name)
    if n == 0:
        return None
    n_bytes, flops = k3_work(live_segments=trace.counts["live_segments"],
                             segments=s["rays"] * s["bounces"], receivers=s["receivers"],
                             nbins=s["nbins"])
    return 100.0 * bound_s(n_bytes, flops) / seconds
