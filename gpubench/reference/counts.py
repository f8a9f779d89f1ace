"""Work counts of the kernels whose roofline share the benchmark reports,
frozen from `PERF.md` at commit e4c1a10 (the counts `chip_smoke.py` used).
Each is a function of the cell's shapes and of counts the plain reference
makes on the same inputs, never of the port's own counters, so it reads the
same work whatever implements it.

- K1, the fused bounce loop: 111 f32 operations a ray-bounce the rays make
  (the hit face's Moller-Trumbore test, 51, and the receiver, reflection and
  Fresnel factor, 60); bytes: the directions in, the mesh once and the IR out.
- K3, the coverage histogram with its slab reduction: 17 operations a live
  segment and receiver (the sphere test and the bin); bytes: the segments in
  (origin, direction, t, amplitude, length: 36 bytes and the live flag) and
  the IRs out.
"""

from __future__ import annotations

__all__ = ["K1_FLOPS_PER_RAY_BOUNCE", "K3_FLOPS_PER_SEGMENT_RX", "k1_work", "k3_work"]

K1_FLOPS_PER_RAY_BOUNCE = 51 + 60
K3_FLOPS_PER_SEGMENT_RX = 17
F32 = 4


def k1_work(*, ray_bounces: float, rays: int, faces: int, nbins: int) -> tuple[float, float]:
    """(bytes, flops) of one traced request."""
    n_bytes = rays * 3 * F32 + faces * 9 * F32 + nbins * F32
    return float(n_bytes), float(ray_bounces * K1_FLOPS_PER_RAY_BOUNCE)


def k3_work(*, live_segments: float, segments: int, receivers: int,
            nbins: int) -> tuple[float, float]:
    """(bytes, flops) of one sweep's histograms."""
    n_bytes = segments * (9 * F32 + 1) + receivers * nbins * F32
    return float(n_bytes), float(live_segments * receivers * K3_FLOPS_PER_SEGMENT_RX)
