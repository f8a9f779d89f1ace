"""The program's `rfx.wait.*` spans a traced unit: the places where the host
blocks on the card."""

from gpubench.harness.program_spans import in_units


def read(trace, spec):
    waits = in_units(trace, "rfx.wait.")
    if waits is None:
        return None
    return len(waits) / len(trace.units)
