"""The host's share of a unit: the benchmark's span around each traced unit
less the device's busy time inside it, the mean over the traced units, ms."""

from gpubench.harness.profile import host_ms


def read(trace, spec):
    return host_ms(trace)
