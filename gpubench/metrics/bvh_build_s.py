"""Host seconds of the program's last BVH build, a gauge of set-up
(`rfx_torch.utils.profiling.counters()["bvh_build_s"]`), set whether or not
a profiler records: the native builder's above 100,000 faces, the numpy
builder's below. None where the program has no such gauge."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    value = counters().get("bvh_build_s")
    return None if value is None else float(value)
