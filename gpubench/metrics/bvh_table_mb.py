"""MB of the scene's BVH tables on the device: the packed nodes, triangles
and face ids of the program's last packing, a gauge of set-up
(`rfx_torch.utils.profiling.counters()["bvh_table_bytes"]`), set whether or
not a profiler records. None where the program has no such gauge."""

from rfx_torch.utils import profiling


def read(trace, spec):
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    value = counters().get("bvh_table_bytes")
    return None if value is None else value / 1e6
