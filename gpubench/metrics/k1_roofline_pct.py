"""K1's share of its roofline, percent: the least time of a request's work
(111 f32 operations a ray-bounce the reference's trace makes on the same
inputs, against the directions in, the mesh once and the IR out; the
reference counts the check's direction sets and receivers, and the mean of
those stands for every traced request, i.i.d. draws of one law) over the mean
device time of `fused_trace_kernel`."""

from gpubench.harness.profile import roofline_pct
from gpubench.reference.counts import k1_work
from gpubench.reference.peaks import bound_s


def read(trace, spec):
    if "ray_bounces" not in trace.counts:
        return None
    s = trace.shapes
    n_bytes, flops = k1_work(ray_bounces=trace.counts["ray_bounces"], rays=s["rays"],
                             faces=s["faces"], nbins=s["nbins"])
    return roofline_pct(trace, lambda name: "fused_trace_kernel" in name, bound_s(n_bytes, flops))
