"""Differentiable inverse solve (port of rfx/solver.py): fit the transmitter
position and the material's refractive index (and optionally the scene's
vertices) to a target coverage map of per-receiver IR energies.

The loss runs the coverage engine with soft delay binning, so delay
gradients flow, and autograd differentiates through the env trace, the
receivers' sphere tests and the IR histogram. The optimizer is
`torch.optim.Adam`, whose defaults (betas 0.9 / 0.999, eps 1e-8 added
outside the square root) are `optax.adam`'s.

Not ported yet: the sharded solve over a device mesh (`mesh=`, ROADMAP A11).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rfx_torch.coverage import coverage_irs
from rfx_torch.tracer import Scene

__all__ = ["InverseParams", "coverage_irs_soft", "make_inverse_solver"]


class InverseParams(NamedTuple):
    tx_pos: torch.Tensor  # (3,)
    log_n1: torch.Tensor  # (); n1 = exp(log_n1) keeps the index positive
    vertices: torch.Tensor | None = None  # (V, 3) optional geometry leaf


def coverage_irs_soft(vertices, faces, tx_pos, n1, directions, rx_centers, rx_radius, *,
                      num_rays: int, max_bounces: int, nbins: int, light_speed_mps: float,
                      sample_rate_hz: float, n2=1.0, env_hit=None) -> torch.Tensor:
    """(M, nbins) soft-binned impulse responses normalised by `num_rays`
    (rfx/solver.py:35-63)."""
    return coverage_irs(Scene(vertices, faces), tx_pos, directions, rx_centers, rx_radius,
                        max_bounces=max_bounces, nbins=nbins, num_rays=num_rays,
                        light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                        n1=n1, n2=n2, env_hit=env_hit, soft=True)


def make_inverse_solver(scene: Scene, directions, rx_centers, rx_radius, target_energy, *,
                        max_bounces: int, nbins: int, light_speed_mps: float = 2.998e8,
                        sample_rate_hz: float = 100e9, learning_rate: float = 0.05,
                        mesh=None, env_hit=None):
    """(init_fn, step_fn) of the inverse solve (rfx/solver.py:66-163).

    init_fn(tx0, n1_0=5.0, vertices0=None) -> (params, opt_state): params
    are leaf tensors on the scene's device, opt_state the Adam optimizer over
    them. step_fn(params, opt_state) -> (params, opt_state, loss) takes one
    Adam step on loss = mean((sum(irs^2, axis=1) - target)^2) and returns the
    loss before the step, as the reference does; params are updated in
    place. With geometry as a leaf, use the brute intersector or a
    differentiable-tris kernel intersector so vertex gradients flow."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded inverse solve (mesh=) is not ported yet (ROADMAP A11)")
    dev = scene.vertices.device

    def as_dev(a):
        a = a if torch.is_tensor(a) else np.array(a, np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    dirs, centers, target = as_dev(directions), as_dev(rx_centers), as_dev(target_energy)
    num_rays = int(dirs.shape[0])

    def loss_fn(params: InverseParams) -> torch.Tensor:
        verts = scene.vertices if params.vertices is None else params.vertices
        irs = coverage_irs_soft(
            verts, scene.faces, params.tx_pos, torch.exp(params.log_n1), dirs, centers,
            rx_radius, num_rays=num_rays, max_bounces=max_bounces, nbins=nbins,
            light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz, env_hit=env_hit)
        energy = torch.sum(irs * irs, dim=1)
        return torch.mean((energy - target) ** 2)

    def init_fn(tx0, n1_0=5.0, vertices0=None):
        params = InverseParams(
            tx_pos=as_dev(tx0).clone().requires_grad_(),
            log_n1=torch.log(as_dev(n1_0)).requires_grad_(),
            vertices=None if vertices0 is None else as_dev(vertices0).clone().requires_grad_(),
        )
        leaves = [p for p in params if p is not None]
        return params, torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def step_fn(params: InverseParams, opt_state: torch.optim.Adam):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn
