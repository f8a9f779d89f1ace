"""Ray direction sampling (port of rfx/sampler.py).

Random numbers come from an explicit `torch.Generator` on the device the
directions are made on. They are not JAX's threefry stream: tests that hold
the port against `rfx` inject the same direction arrays into both, and the
samplers themselves are checked for their distribution.
"""

from __future__ import annotations

import math

import torch

from rfx_torch.device import resolve_device

__all__ = [
    "sphere_directions",
    "stratified_sphere_directions",
    "direction_morton_keys",
    "morton_sphere_directions",
    "pad_directions",
]


def _from_z_phi(z: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=1)


def sphere_directions(n: int, *, generator: torch.Generator, device="cuda") -> torch.Tensor:
    """(n, 3) float32 directions uniform on the unit sphere, drawn from
    `generator` (which must live on `device`)."""
    dev = resolve_device(device)
    z = torch.rand(n, generator=generator, device=dev) * 2.0 - 1.0
    phi = torch.rand(n, generator=generator, device=dev) * (2.0 * math.pi)
    return _from_z_phi(z, phi)


def stratified_sphere_directions(n: int, *, generator: torch.Generator,
                                 device="cuda") -> torch.Tensor:
    """Stratified (z, phi) sampling: one jittered sample in each cell of an
    (n_z x n_phi) lattice; the same uniform law as `sphere_directions`."""
    dev = resolve_device(device)
    m = int(n**0.5)
    while m > 1 and n % m:
        m -= 1
    m = max(m, 1)
    nz, nphi = m, n // m
    iz = torch.arange(nz, dtype=torch.float32, device=dev)
    ip = torch.arange(nphi, dtype=torch.float32, device=dev)
    z = (iz[:, None] + torch.rand((nz, nphi), generator=generator, device=dev)) / nz * 2.0 - 1.0
    phi = ((ip[None, :] + torch.rand((nz, nphi), generator=generator, device=dev))
           / nphi * 2.0 * math.pi)
    return _from_z_phi(z.reshape(-1), phi.reshape(-1))


def _spread16(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of int64 `v` to the even bit positions."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def direction_morton_keys(directions: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """int64 Morton code of each direction's (z, phi) cell on a 2^bits
    lattice; sorting by it makes consecutive rays point into one small cone."""
    res = 1 << bits
    z = torch.clamp(directions[:, 2], -1.0, 1.0)
    phi = torch.atan2(directions[:, 1], directions[:, 0])  # [-pi, pi]
    zi = torch.clamp(((z + 1.0) * 0.5 * res).to(torch.int64), 0, res - 1)
    pi_ = torch.clamp(((phi / (2.0 * math.pi) + 0.5) * res).to(torch.int64), 0, res - 1)
    return _spread16(zi) | (_spread16(pi_) << 1)


def morton_sphere_directions(n: int, *, generator: torch.Generator,
                             device="cuda") -> torch.Tensor:
    """Stratified uniform sphere directions in (z, phi) Morton order (stable
    sort), so each run of consecutive rays is a tight direction cone."""
    d = stratified_sphere_directions(n, generator=generator, device=device)
    order = torch.argsort(direction_morton_keys(d), stable=True)
    return d[order]


def pad_directions(directions: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Pad a batch to a multiple of `multiple` with (0, 0, 1) rays, which the
    caller masks out by the returned valid count: (padded, n_valid)."""
    n = directions.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return directions, n
    pad = directions.new_tensor([0.0, 0.0, 1.0]).expand(rem, 3)
    return torch.cat([directions, pad], dim=0), n
