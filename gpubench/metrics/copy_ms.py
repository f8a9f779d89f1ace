"""The copies' device time a traced unit, ms: in a coverage sweep, the IRs'
round trip through the host (to the host after the histogram, back for the
RX power) and the answer's."""

from gpubench.harness.profile import per_unit


def read(trace, spec):
    return per_unit(trace, lambda name: name.startswith("Memcpy"))[1] * 1e3
