"""The host's ms a traced unit inside the program's `rfx.wait.*` spans (their
union): the time the host blocks on the card, at the copies to and from it."""

from gpubench.harness.program_spans import in_units, seconds


def read(trace, spec):
    waits = in_units(trace, "rfx.wait.")
    if waits is None:
        return None
    return seconds(waits) / len(trace.units) * 1e3
