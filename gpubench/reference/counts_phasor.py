"""Work counts of K-F, the phasor kernel, whose roofline share the benchmark
reports, as `PERF.md` section 6's K-F row counts them: 17 f32 operations a
live segment and receiver (the sphere test and the bin, K3's count: the two
kernels share one capture rule); bytes: the segments in (origin, direction,
t, amplitude, length: 36 bytes and the live flag) and six f32 sums a
receiver out. A function of the cell's shapes and of the count of live
segments the plain reference makes on the same inputs, never of the port's
own counters."""

from __future__ import annotations

from gpubench.reference.counts import F32, K3_FLOPS_PER_SEGMENT_RX

__all__ = ["KF_FLOPS_PER_SEGMENT_RX", "KF_SUMS_PER_RX", "kf_work"]

KF_FLOPS_PER_SEGMENT_RX = K3_FLOPS_PER_SEGMENT_RX
KF_SUMS_PER_RX = 6


def kf_work(*, live_segments: float, segments: int, receivers: int) -> tuple[float, float]:
    """(bytes, flops) of one sweep's phasor metric."""
    n_bytes = segments * (9 * F32 + 1) + receivers * KF_SUMS_PER_RX * F32
    return float(n_bytes), float(live_segments * receivers * KF_FLOPS_PER_SEGMENT_RX)
