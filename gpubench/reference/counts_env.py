"""Work counts of K2, the per-query closest hit, under the coverage engine's
environment trace, whose roofline share the benchmark reports: 51 f32
operations a live environment query (the hit face's Moller-Trumbore test,
as K1's count has it); bytes: a live query's ray in (origin and direction,
24 bytes) and its answer out (t, face and normal, 20 bytes), and the mesh
once (9 f32 a face). The live queries are the segments the plain reference's
environment trace makes on the same inputs (`reference/trace.env_trace`),
never the port's own counters, which also count the lanes it parks."""

from __future__ import annotations

from gpubench.reference.counts import F32

__all__ = ["K2_FLOPS_PER_QUERY", "K2_BYTES_IN", "K2_BYTES_OUT", "k2_work"]

K2_FLOPS_PER_QUERY = 51
K2_BYTES_IN = 6 * F32
K2_BYTES_OUT = 5 * F32


def k2_work(*, live_queries: float, faces: int) -> tuple[float, float]:
    """(bytes, flops) of one sweep's environment queries."""
    n_bytes = live_queries * (K2_BYTES_IN + K2_BYTES_OUT) + faces * 9 * F32
    return float(n_bytes), float(live_queries * K2_FLOPS_PER_QUERY)
