"""Bounce-loop tracer, forward (port of rfx/tracer.py:trace_to_rx).

A plain Python loop over bounces carries per-ray position, direction, alive
mask, amplitude and path length; the environment hit is the brute-force
Moller-Trumbore of rfx_torch.ops.intersect. It serves the facade's `brute`
backend (meshes of at most 2048 triangles) and its `record_paths` branch.
Semantics are the reference's: the receiver wins iff hit and t_env > t_rx,
an env hit advances and reflects specularly, a double miss escapes, and dead
rays are parked at 1e9.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rfx.geometry import icosphere
from rfx_torch import physics
from rfx_torch.device import resolve_device
from rfx_torch.ops.intersect import (
    hit_normal_from_edges,
    is_hit,
    mesh_soa,
    ray_mesh_closest_hit_brute,
    ray_sphere_hit,
)

__all__ = ["Scene", "TraceResult", "trace_to_rx", "extract_paths"]


class Scene(NamedTuple):
    vertices: torch.Tensor  # (V, 3) float32
    faces: torch.Tensor  # (F, 3) int32

    @classmethod
    def from_mesh(cls, mesh, device="cuda") -> "Scene":
        dev = resolve_device(device)
        return cls(torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=dev),
                   torch.as_tensor(np.asarray(mesh.faces, np.int32), device=dev))


class TraceResult(NamedTuple):
    captured: torch.Tensor  # (N,) bool
    amplitude: torch.Tensor  # (N,) product of Fresnel factors at capture
    distance: torch.Tensor  # (N,) path length TX -> receiver-sphere hit
    num_bounces: torch.Tensor  # (N,) int32 env bounces before capture/death
    path_vertices: torch.Tensor | None = None  # (B, N, 3) when record_paths


# Unit icosphere (42 vertices / 80 faces): the reference receiver's
# tessellation (ref tracer.py:27).
_UNIT_ICO_TRI = icosphere(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=1).triangles()


def _rx_query(rx_pos: torch.Tensor, rx_radius, rx_mode: str):
    if rx_mode == "analytic":
        return lambda o, d: ray_sphere_hit(o, d, rx_pos, rx_radius)
    if rx_mode == "icosphere":
        tri = torch.as_tensor(_UNIT_ICO_TRI, dtype=torch.float32, device=rx_pos.device)
        r = torch.as_tensor(rx_radius, dtype=torch.float32, device=rx_pos.device)
        v0 = tri[:, 0] * r + rx_pos[None, :]
        e1 = (tri[:, 1] - tri[:, 0]) * r
        e2 = (tri[:, 2] - tri[:, 0]) * r
        return lambda o, d: ray_mesh_closest_hit_brute(o, d, v0, e1, e2)[0]
    raise ValueError(f"unknown rx_mode: {rx_mode}")


def trace_to_rx(scene: Scene, tx_pos, directions: torch.Tensor, rx_pos, rx_radius, *,
                max_bounces: int, n1=5.0, n2=1.0, rx_mode: str = "icosphere",
                record_paths: bool = False, active: torch.Tensor | None = None,
                warp_quirk_compat: bool = False) -> TraceResult:
    """Trace N rays from tx_pos; per-ray capture, amplitude, distance and
    bounce count, on the device of `directions`. `tx_pos` is (3,) or (N, 3);
    `active` masks out padding rays."""
    if warp_quirk_compat:
        raise NotImplementedError(
            "warp_quirk_compat is not ported yet (ROADMAP A8: the rest of trace_to_rx)")
    dev = directions.device
    f32 = torch.float32
    v0, e1, e2, _ = mesh_soa(scene.vertices, scene.faces)
    rx = torch.as_tensor(rx_pos, dtype=f32, device=dev)
    rx_query = _rx_query(rx, rx_radius, rx_mode)

    d = directions.to(f32)
    n = d.shape[0]
    tx = torch.as_tensor(tx_pos, dtype=f32, device=dev)
    pos = tx.expand(n, 3).clone() if tx.ndim == 2 else tx[None, :].expand(n, 3).clone()
    alive = torch.ones(n, dtype=torch.bool, device=dev) if active is None else active.to(torch.bool)
    amp = torch.ones(n, dtype=f32, device=dev)
    dist = torch.zeros(n, dtype=f32, device=dev)
    captured = torch.zeros(n, dtype=torch.bool, device=dev)
    cap_amp = torch.zeros(n, dtype=f32, device=dev)
    cap_dist = torch.zeros(n, dtype=f32, device=dev)
    nb = torch.zeros(n, dtype=torch.int32, device=dev)
    verts = []
    zero = torch.zeros((), dtype=f32, device=dev)
    parked = torch.full((), 1e9, dtype=f32, device=dev)

    for _ in range(max_bounces):
        t_rx = rx_query(pos, d)
        t_env, face = ray_mesh_closest_hit_brute(pos, d, v0, e1, e2)
        nrm = hit_normal_from_edges(e1, e2, face)
        rx_win = alive & is_hit(t_rx) & (t_env > t_rx)
        env_bounce = alive & ~rx_win & is_hit(t_env)

        captured = captured | rx_win
        cap_amp = torch.where(rx_win, amp, cap_amp)
        cap_dist = torch.where(rx_win, dist + t_rx, cap_dist)

        t_adv = torch.where(env_bounce, t_env, zero)
        new_pos = torch.where(env_bounce[:, None], pos + d * t_adv[:, None], parked)
        nrm_safe = torch.where(env_bounce[:, None], nrm, zero)
        d_out = physics.reflect(d, nrm_safe)
        fres = physics.fresnel_bounce_amplitude(physics.bend_angle(d, d_out), n1, n2)
        if record_paths:
            rx_pt = pos + d * torch.where(is_hit(t_rx), t_rx, zero)[:, None]
            nan = torch.full_like(new_pos, float("nan"))
            verts.append(torch.where(rx_win[:, None], rx_pt,
                                     torch.where(env_bounce[:, None], new_pos, nan)))
        amp = torch.where(env_bounce, amp * fres, amp)
        dist = dist + t_adv
        d = torch.where(env_bounce[:, None], d_out, d)
        nb = nb + env_bounce.to(torch.int32)
        pos = new_pos
        alive = env_bounce

    paths = None
    if record_paths:
        paths = torch.stack(verts) if verts else torch.empty((0, n, 3), dtype=f32, device=dev)
    return TraceResult(captured, cap_amp, cap_dist, nb, paths)


def extract_paths(tx_pos, result: TraceResult, max_paths: int = 10_000) -> list[np.ndarray]:
    """Up to `max_paths` received paths as (k, 3) numpy vertex arrays, TX
    first, in ray order (the reference's cleaned path list)."""
    if result.path_vertices is None:
        raise ValueError("trace was run without record_paths=True")
    idx = torch.nonzero(result.captured).flatten()[:max_paths]
    verts = result.path_vertices[:, idx, :].cpu().numpy()  # (B, K, 3)
    tx = np.asarray(tx_pos, np.float32)
    paths = []
    for k in range(idx.shape[0]):
        col = verts[:, k, :]
        keep = ~np.isnan(col[:, 0])
        stop = np.argmin(keep) if not keep.all() else col.shape[0]
        paths.append(np.concatenate([tx[None, :], col[:stop]], axis=0))
    return paths
