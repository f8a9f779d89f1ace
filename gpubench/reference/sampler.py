"""Frozen copy of the uniform sphere sampler, `sphere_directions` of
`rfx_torch/sampler.py` at commit e4c1a10 (the reference's sampler: z and the
azimuth uniform), drawn from an explicit `torch.Generator` on the device."""

from __future__ import annotations

import math

import torch

__all__ = ["sphere_directions"]


def sphere_directions(n: int, *, generator: torch.Generator, device) -> torch.Tensor:
    """(n, 3) float32 directions uniform on the unit sphere (i.i.d., in draw
    order: not sorted)."""
    z = torch.rand(n, generator=generator, device=device) * 2.0 - 1.0
    phi = torch.rand(n, generator=generator, device=device) * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=1)
