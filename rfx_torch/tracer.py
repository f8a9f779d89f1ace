"""Bounce-loop tracer (port of rfx/tracer.py): `trace_to_rx` and the
coverage engine's env-only `trace_env`.

A plain Python loop over bounces carries per-ray position, direction, alive
mask, amplitude and path length; the environment hit is an `env_hit(o, d,
v0, e1, e2, normals) -> (t, face, nrm)` from
rfx_torch.ops.intersect.make_env_intersector: brute-force Moller-Trumbore by
default, or the per-query BVH kernel. Semantics are the reference's: the
receiver wins iff hit and t_env > t_rx, an env hit advances and reflects
specularly, a double miss escapes, and dead rays are parked at 1e9. Every
step is differentiable PyTorch (the intersectors carry the reference's
custom gradients), so autograd through the loop is the scan tracer's
gradient path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rfx_torch.geometry import icosphere
from rfx_torch import physics
from rfx_torch.device import resolve_device
from rfx_torch.ops.intersect import (
    is_hit,
    make_env_intersector,
    mesh_soa,
    ray_mesh_closest_hit_brute,
    ray_sphere_hit,
)

__all__ = ["Scene", "TraceResult", "EnvSegments", "trace_to_rx", "trace_env", "extract_paths"]


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


class EnvSegments(NamedTuple):
    """Per-bounce segments of an env-only trace (the coverage engine's)."""

    origin: torch.Tensor  # (B, N, 3) segment start
    direction: torch.Tensor  # (B, N, 3) unit direction
    t_env: torch.Tensor  # (B, N) env-hit distance, MISS where the segment escapes
    amplitude: torch.Tensor  # (B, N) amplitude at the segment start
    distance: torch.Tensor  # (B, N) path length at the segment start
    alive: torch.Tensor  # (B, N) bool: the segment exists


# Unit icosphere (42 vertices / 80 faces): the reference receiver's
# tessellation (ref tracer.py:27).
_UNIT_ICO_TRI = icosphere(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=1).triangles()


def icosphere_soa(rx_pos: torch.Tensor, rx_radius):
    """(v0, e1, e2) of the reference's 80-face receiver icosphere at rx_pos."""
    tri = torch.as_tensor(_UNIT_ICO_TRI, dtype=torch.float32, device=rx_pos.device)
    r = torch.as_tensor(rx_radius, dtype=torch.float32, device=rx_pos.device)
    return tri[:, 0] * r + rx_pos[None, :], (tri[:, 1] - tri[:, 0]) * r, (tri[:, 2] - tri[:, 0]) * r


def unit_icosphere_tris(device) -> torch.Tensor:
    """(80, 9) f32: the unit icosphere's faces as rows (v0, e1, e2)."""
    tri = torch.as_tensor(_UNIT_ICO_TRI, dtype=torch.float32, device=device)
    return torch.cat([tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]], dim=1)


def icosphere_tris(centers: torch.Tensor, rx_radius) -> torch.Tensor:
    """(R, 80, 9) f32: the faces (v0, e1, e2) of the icospheres of radius
    rx_radius about the (R, 3) centers, each row the bits of
    `icosphere_soa` of its center (what the map engine's icosphere kernels
    read)."""
    unit = unit_icosphere_tris(centers.device)
    r = torch.as_tensor(rx_radius, dtype=torch.float32, device=centers.device)
    v0 = unit[None, :, 0:3] * r + centers[:, None, :]
    edges = (unit[:, 3:9] * r).expand(centers.shape[0], -1, -1)
    return torch.cat([v0, edges], dim=2)


def _rx_query(rx_pos: torch.Tensor, rx_radius, rx_mode: str):
    """t_rx(o, d) of the analytic or the icosphere receiver (on the card the
    brute closest-hit kernel, with the icosphere's bounding sphere as its
    cull)."""
    if rx_mode == "analytic":
        return lambda o, d: ray_sphere_hit(o, d, rx_pos, rx_radius)
    if rx_mode == "icosphere":
        v0, e1, e2 = icosphere_soa(rx_pos, rx_radius)
        r = torch.as_tensor(rx_radius, dtype=torch.float32, device=rx_pos.device).detach()
        cull = torch.cat([rx_pos.detach().reshape(3), r.reshape(1)])
        return lambda o, d: ray_mesh_closest_hit_brute(o, d, v0, e1, e2, cull=cull)[0]
    raise ValueError(f"unknown rx_mode: {rx_mode}")


def trace_to_rx(scene: Scene, tx_pos, directions: torch.Tensor, rx_pos, rx_radius, *,
                max_bounces: int, n1=5.0, n2=1.0, rx_mode: str = "icosphere",
                env_hit=None, record_paths: bool = False, active: torch.Tensor | None = None,
                warp_quirk_compat: bool = False) -> TraceResult:
    """Trace N rays from tx_pos; per-ray capture, amplitude, distance and
    bounce count, on the device of `directions`. `tx_pos` is (3,) or (N, 3);
    `env_hit` is the closest-hit query (None: brute force); `active` masks
    out padding rays. Differentiable in tx_pos, directions, rx_pos,
    rx_radius, n1, n2 and the scene's vertices (through `env_hit`'s
    gradient).

    `warp_quirk_compat=True` reproduces the reference kernel's per-iteration
    `ray_finished` reset (ref kernel.py:58-59; rfx/tracer.py:130-139): a
    capture does not end the ray. It goes on from the receiver sphere's
    surface in the same direction (as a rule capturing again where it leaves
    the sphere), a later capture overwrites the recorded amplitude and
    distance, and each pass-through vertex folds in the Fresnel factor of a
    bend angle of 0. Escaped rays still die. Matches oracle.OracleTracer's
    flag."""
    if env_hit is None:
        env_hit = make_env_intersector("brute")
    dev = directions.device
    f32 = torch.float32
    v0, e1, e2, normals = mesh_soa(scene.vertices, scene.faces)
    rx = torch.as_tensor(rx_pos, dtype=f32, device=dev)
    t_rx_of = _rx_query(rx, rx_radius, rx_mode)

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
        t_rx = t_rx_of(pos, d)
        t_env, _face, nrm = env_hit(pos, d, v0, e1, e2, normals)
        rx_win = alive & is_hit(t_rx) & (t_env > t_rx)
        env_bounce = alive & ~rx_win & is_hit(t_env)

        captured = captured | rx_win
        cap_amp = torch.where(rx_win, amp, cap_amp)
        cap_dist = torch.where(rx_win, dist + t_rx, cap_dist)

        t_adv = torch.where(env_bounce, t_env, zero)
        new_pos = torch.where(env_bounce[:, None], pos + d * t_adv[:, None], parked)
        # Lanes that do not env-bounce get a zero normal: their Fresnel value
        # is discarded below, but its backward still multiplies a zero
        # cotangent by the branch's derivative, and 0 x inf is NaN
        # (rfx/tracer.py:192-200).
        nrm_safe = torch.where(env_bounce[:, None], nrm, zero)
        d_out = physics.reflect(d, nrm_safe)
        fres = physics.fresnel_bounce_amplitude(physics.bend_angle(d, d_out), n1, n2)
        if record_paths:
            rx_pt = pos + d * torch.where(is_hit(t_rx), t_rx, zero)[:, None]
            nan = torch.full_like(new_pos, float("nan"))
            verts.append(torch.where(rx_win[:, None], rx_pt,
                                     torch.where(env_bounce[:, None], new_pos, nan)))
        amp_next = torch.where(env_bounce, amp * fres, amp)
        dist_next = dist + t_adv
        alive_next = env_bounce
        if warp_quirk_compat:
            f0 = physics.fresnel_bounce_amplitude(zero, n1, n2)
            rx_pt = pos + d * torch.where(rx_win, t_rx, zero)[:, None]
            new_pos = torch.where(rx_win[:, None], rx_pt, new_pos)
            amp_next = torch.where(rx_win, amp * f0, amp_next)
            dist_next = torch.where(rx_win, dist + t_rx, dist_next)
            alive_next = env_bounce | rx_win
        amp, dist, alive = amp_next, dist_next, alive_next
        d = torch.where(env_bounce[:, None], d_out, d)
        nb = nb + env_bounce.to(torch.int32)
        pos = new_pos

    paths = None
    if record_paths:
        paths = torch.stack(verts) if verts else torch.empty((0, n, 3), dtype=f32, device=dev)
    return TraceResult(captured, cap_amp, cap_dist, nb, paths)


def trace_env(scene: Scene, tx_pos, directions: torch.Tensor, *, max_bounces: int, n1=5.0,
              n2=1.0, env_hit=None, active: torch.Tensor | None = None) -> EnvSegments:
    """Environment-only trace recording every bounce's segment
    (rfx/tracer.py:263-336): the coverage engine intersects these with each
    receiver afterwards, since a receiver never alters the environment path
    and capture only truncates that receiver's own view of it."""
    if env_hit is None:
        env_hit = make_env_intersector("brute")
    dev = directions.device
    f32 = torch.float32
    v0, e1, e2, normals = mesh_soa(scene.vertices, scene.faces)
    d = directions.to(f32)
    n = d.shape[0]
    pos = torch.as_tensor(tx_pos, dtype=f32, device=dev)[None, :].expand(n, 3)
    alive = torch.ones(n, dtype=torch.bool, device=dev) if active is None else active.to(torch.bool)
    amp = torch.ones(n, dtype=f32, device=dev)
    dist = torch.zeros(n, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    parked = torch.full((), 1e9, dtype=f32, device=dev)
    segs = []
    for _ in range(max_bounces):
        t_env, _face, nrm = env_hit(pos, d, v0, e1, e2, normals)
        segs.append((pos, d, t_env, amp, dist, alive))
        env_bounce = alive & is_hit(t_env)
        t_adv = torch.where(env_bounce, t_env, zero)
        new_pos = torch.where(env_bounce[:, None], pos + d * t_adv[:, None], parked)
        d_out = physics.reflect(d, nrm)
        fres = physics.fresnel_bounce_amplitude(physics.bend_angle(d, d_out), n1, n2)
        d = torch.where(env_bounce[:, None], d_out, d)
        amp = torch.where(env_bounce, amp * fres, amp)
        dist = dist + t_adv
        pos = new_pos
        alive = env_bounce
    if not segs:
        empty3 = torch.empty((0, n, 3), dtype=f32, device=dev)
        empty = torch.empty((0, n), dtype=f32, device=dev)
        return EnvSegments(empty3, empty3, empty, empty, empty, empty.bool())
    return EnvSegments(*(torch.stack(x) for x in zip(*segs)))


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
