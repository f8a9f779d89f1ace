"""RF physics in PyTorch (port of rfx/physics.py): specular reflection, the
bend angle between consecutive segments, and the reference's s-polarised
Fresnel power factor (ref tracer.py:34-61, reproduced as written)."""

from __future__ import annotations

import math

import torch

__all__ = ["reflect", "bend_angle", "fresnel_bounce_amplitude"]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Specular reflection d - 2 (d.n) n; invariant to the sign of n. The dot
    product sums x + y + z in that order, as the fused kernel does, so the
    scan tracer's bounce points round as the kernel's."""
    w = d[..., 0] * n[..., 0] + d[..., 1] * n[..., 1] + d[..., 2] * n[..., 2]
    return d - 2.0 * w[..., None] * n


def bend_angle(d_in: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """Angle between consecutive unit path segments, with the cosine clamped
    1e-6 inside [-1, 1] as in the reference."""
    cosang = torch.sum(d_in * d_out, dim=-1)
    return torch.arccos(torch.clamp(cosang, -1.0 + 1e-6, 1.0 - 1e-6))


def fresnel_bounce_amplitude(angle_between, n1=5.0, n2=1.0) -> torch.Tensor:
    """Fresnel power factor in [0, 1] of a bounce with the given bend angle,
    with the reference's swapped-media convention and NaN -> 0 guards."""
    angle = torch.as_tensor(angle_between, dtype=torch.float32)
    theta = (math.pi / 2.0) - (angle / 2.0)
    sin_ratio = (n2 * torch.sin(theta)) / n1
    valid = torch.abs(sin_ratio) <= 1.0
    theta_i = torch.arcsin(torch.clamp(sin_ratio, -1.0 + 1e-7, 1.0 - 1e-7))
    num = n2 * torch.cos(theta_i) - n1 * torch.cos(theta)
    denom = n2 * torch.cos(theta_i) + n1 * torch.cos(theta)
    amp = -((num / torch.where(denom != 0.0, denom, torch.ones_like(denom))) ** 2)
    amp = torch.clamp_min(amp, -1.0)
    out = -amp
    keep = valid & (denom != 0.0) & ~torch.isnan(angle)
    return torch.where(keep, out, torch.zeros_like(out))
