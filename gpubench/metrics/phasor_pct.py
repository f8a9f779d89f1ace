"""The share, %, of the traced sweeps' receivers whose sums the phasor
kernel's walk computed, from the program's counters
(`rfx_torch.utils.profiling.counters()`: `rx_phasor`, which counts only while
a profiler records: the traced units) over the cell's receivers a unit times
the traced units. None without a traced unit or without counters; 0 where the
program has no such tally (its sweeps take another path, or it does not
count them)."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None or not trace.units:
        return None
    receivers = trace.shapes.get("receivers")
    if not receivers:
        return None
    return 100.0 * counters().get("rx_phasor", 0) / (receivers * len(trace.units))
