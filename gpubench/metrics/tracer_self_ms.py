"""The tracers' own host time a traced unit, ms: the union of the program's
`rfx.tracer.*` spans less the part that the other `rfx.*` spans nested in
them cover (the kernels' wrappers, the waits). What is left is the tracers'
Python and launches."""

from gpubench.harness.program_spans import in_units, seconds


def read(trace, spec):
    spans = in_units(trace)
    if spans is None:
        return None
    tracers = [s for s in spans if s[2].startswith("rfx.tracer.")]
    nested = [(s, e) for s, e, name in spans if not name.startswith("rfx.tracer.")
              and any(a <= s and e <= b for a, b, _ in tracers)]
    return (seconds(tracers) - seconds(nested)) / len(trace.units) * 1e3
