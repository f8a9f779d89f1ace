"""Frozen copy of the roofline arithmetic of `chip_smoke.py` at commit
e4c1a10 (`PEAK_BYTES_PER_S`, `PEAK_F32_FLOPS`, `_bound`): one H100 SXM's
published peaks (NVIDIA's data sheet, at the 700 W power limit) and the least
time a kernel could take."""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_FLOPS", "bound_s"]

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores


def bound_s(n_bytes: float, flops: float) -> float:
    """Seconds at the larger of bytes at the memory rate and f32 operations
    at the peak rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)
