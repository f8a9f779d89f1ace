"""The share, %, of a traced unit's bytes through the host that crossed
through page-locked host memory, both ways, from the program's counters
(`rfx_torch.utils.profiling.counters()`: `bytes_pinned_to_host` and
`bytes_pinned_to_device` of `bytes_to_host` and `bytes_to_device`), which
count only while a profiler records: the traced units. None where the
program has no such counters or no unit was traced."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None or not trace.units:
        return None
    c = counters()
    if "bytes_pinned_to_host" not in c or "bytes_pinned_to_device" not in c:
        return None
    total = c["bytes_to_host"] + c["bytes_to_device"]
    if total == 0:
        return None
    return 100.0 * (c["bytes_pinned_to_host"] + c["bytes_pinned_to_device"]) / total
