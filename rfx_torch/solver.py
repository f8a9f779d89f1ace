"""Differentiable inverse solve (port of rfx/solver.py): fit the transmitter
position and the material's refractive index (and optionally the scene's
vertices) to a target coverage map of per-receiver IR energies.

The loss runs the coverage engine with soft delay binning, so delay
gradients flow, and autograd differentiates through the env trace, the
receivers' sphere tests and the IR histogram. The optimizer is
`torch.optim.Adam`, whose defaults (betas 0.9 / 0.999, eps 1e-8 added
outside the square root) are `optax.adam`'s.

With `mesh=` (rfx_torch.parallel.make_mesh, axes 'rays' and 'rx') each rank
traces its block of the rays for its tile of the receivers; the partial IRs
are summed over 'rays' before the energy square, the squared errors over
'rx', and the parameters' gradients over every rank in one all-reduce
(rfx_torch/parallel/dist.py has the autograd of the collectives).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rfx_torch.coverage import coverage_irs
from rfx_torch.parallel.dist import replicated, sum_over
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
    differentiable-tris kernel intersector so vertex gradients flow.

    `mesh`: a rfx_torch.parallel Mesh with axes 'rays' and 'rx'. The
    arguments stay global (all rays, all receivers and their targets); each
    rank takes its blocks, and a step makes three all-reduces: the partial
    IRs of its receiver tile over 'rays', the squared error over 'rx' and
    the gradients over every rank. Every rank returns the same loss and
    holds the same parameters after the step, bit for bit."""
    dev = scene.vertices.device

    def as_dev(a):
        a = a if torch.is_tensor(a) else np.array(a, np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    dirs, centers, target = as_dev(directions), as_dev(rx_centers), as_dev(target_energy)
    num_rays, num_rx = int(dirs.shape[0]), int(centers.shape[0])
    if mesh is not None:
        if num_rays % mesh.shape["rays"]:
            raise ValueError(f"ray count {num_rays} not divisible over 'rays' axis")
        if num_rx % mesh.shape["rx"]:
            raise ValueError(f"receiver count {num_rx} not divisible over 'rx' axis")
        dirs = mesh.block(dirs, "rays")
        centers, target = mesh.block(centers, "rx"), mesh.block(target, "rx")

    def loss_fn(params: InverseParams) -> torch.Tensor:
        if mesh is not None:  # the gradients of the leaves sum over every rank
            params = InverseParams(*replicated(mesh, None, *params))
        verts = scene.vertices if params.vertices is None else params.vertices
        irs = coverage_irs_soft(
            verts, scene.faces, params.tx_pos, torch.exp(params.log_n1), dirs, centers,
            rx_radius, num_rays=num_rays, max_bounces=max_bounces, nbins=nbins,
            light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz, env_hit=env_hit)
        if mesh is None:
            energy = torch.sum(irs * irs, dim=1)
            return torch.mean((energy - target) ** 2)
        irs = sum_over(irs, mesh, "rays")  # complete each receiver of the tile
        energy = torch.sum(irs * irs, dim=1)
        return sum_over(torch.sum((energy - target) ** 2), mesh, "rx") / num_rx

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
