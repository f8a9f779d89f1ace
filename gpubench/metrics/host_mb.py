"""MB a traced unit through the host: the payload of the program's
`rfx.wait.*` copies, to the host and to the card, from the program's counters
(`rfx_torch.utils.profiling.counters()`), which count only while a profiler
records: the traced units. None where the program has no counters."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None or not trace.units:
        return None
    c = counters()
    return (c["bytes_to_host"] + c["bytes_to_device"]) / len(trace.units) / 1e6
