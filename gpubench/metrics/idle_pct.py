"""The device's idle share of the traced window: 1 less the union of its
kernel, memset and copy records over the window, in percent."""

from gpubench.harness.profile import idle_pct


def read(trace, spec):
    return idle_pct(trace)
