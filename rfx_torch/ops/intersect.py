"""Ray-primitive intersection, forward (port of rfx/ops/intersect.py).

- `ray_mesh_closest_hit_brute`: Moller-Trumbore of every ray against every
  triangle, chunked over rays so the (rays x triangles) intermediates stay
  bounded. The closest-hit path of small meshes (the facade's `brute`
  backend) and of the icosphere receiver.
- `ray_sphere_hit`: closed-form sphere hit of the analytic receiver.

Constants and the finite miss sentinel are the reference's
(`rfx/ops/intersect.py:27-39`). Dot products are written out left to right,
so they round as the fused kernel's do. The autograd of the reference's
custom VJPs is not ported yet.
"""

from __future__ import annotations

import torch

T_MIN_EPS = 1e-4
T_MAX = 1.0e6
MISS = 1e30
MISS_THRESHOLD = 1e29

# Upper bound on rays x triangles per brute-force chunk (each of the ~20
# intermediates is this many f32 values).
_BRUTE_PAIRS = 1 << 22


def is_hit(t: torch.Tensor) -> torch.Tensor:
    """True where a query returned a real intersection (t below the miss
    sentinel)."""
    return t < MISS_THRESHOLD


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.b over the last axis, summed x + y + z in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _unit(n: torch.Tensor) -> torch.Tensor:
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-30)


def hit_normal_from_edges(e1: torch.Tensor, e2: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
    """Unit geometric normal of each ray's hit face, unit(cross(e1[f], e2[f]));
    a miss (face -1) reads face 0 and is masked by the caller."""
    f = face.clamp_min(0)
    return _unit(cross3(e1[f], e2[f]))


def mesh_soa(vertices: torch.Tensor, faces: torch.Tensor):
    """(v0, e1, e2, unit normals) of an indexed mesh, each (F, 3)."""
    faces = faces.long()
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    return v0, e1, e2, _unit(cross3(e1, e2))


def closed_form_t(o, d, v0, e1, e2):
    """Moller-Trumbore t for known (ray, triangle) pairs, all (N, 3)."""
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    det_safe = torch.where(det.abs() > 1e-12, det, torch.ones_like(det))
    qvec = cross3(o - v0, e1)
    return dot3(e2, qvec) / det_safe


def _mt_chunk(o, d, v0, e1, e2, t_min, t_max):
    """(C, 3) rays against (T, 3) triangles -> (t_best (C,), face (C,) i32)."""
    pvec = cross3(d[:, None, :], e2[None, :, :])  # (C, T, 3)
    det = dot3(e1[None, :, :], pvec)
    valid_det = det.abs() > 1e-12
    inv_det = torch.where(valid_det, 1.0 / torch.where(valid_det, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    tvec = o[:, None, :] - v0[None, :, :]
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1[None, :, :])
    v = dot3(d[:, None, :], qvec) * inv_det
    t = dot3(e2[None, :, :], qvec) * inv_det
    ok = valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    t = torch.where(ok, t, torch.full_like(t, MISS))
    face = torch.argmin(t, dim=1)
    t_best = torch.gather(t, 1, face[:, None])[:, 0]
    face = torch.where(is_hit(t_best), face, torch.full_like(face, -1)).to(torch.int32)
    return t_best, face


def ray_mesh_closest_hit_brute(o, d, v0, e1, e2, t_min: float = T_MIN_EPS,
                               t_max: float = T_MAX, ray_chunk: int | None = None):
    """Closest hit of (N, 3) rays against all T triangles: (t (N,), face (N,)
    int32), with t = MISS and face = -1 on a miss and ties going to the lowest
    face index. Rays are processed `ray_chunk` at a time (default: enough to
    keep chunk x T near 4M pairs)."""
    n, n_tris = o.shape[0], v0.shape[0]
    if ray_chunk is None:
        ray_chunk = max(1, _BRUTE_PAIRS // max(n_tris, 1))
    if n_tris == 0:
        return (torch.full((n,), MISS, dtype=o.dtype, device=o.device),
                torch.full((n,), -1, dtype=torch.int32, device=o.device))
    ts, fs = [], []
    for s in range(0, n, ray_chunk):
        t, f = _mt_chunk(o[s:s + ray_chunk], d[s:s + ray_chunk], v0, e1, e2, t_min, t_max)
        ts.append(t)
        fs.append(f)
    if not ts:
        return o.new_empty((0,)), torch.empty((0,), dtype=torch.int32, device=o.device)
    return torch.cat(ts), torch.cat(fs)


def sphere_t(o, d, center, r2):
    """Smallest t > T_MIN_EPS of rays (N, 3) with the sphere |p - center|^2 =
    r2, MISS on a miss; tangent hits (disc == 0) miss. `center` is (3,) and
    `r2` a 0-dim tensor or float, both already f32."""
    oc = o - center
    b = dot3(oc, d)
    c = dot3(oc, oc) - r2
    disc = b * b - c
    hit = disc > 0.0
    s = torch.sqrt(torch.where(hit, disc, torch.ones_like(disc)))
    t0 = -b - s
    t1 = -b + s
    miss = torch.full_like(t0, MISS)
    t = torch.where(t0 > T_MIN_EPS, t0, torch.where(t1 > T_MIN_EPS, t1, miss))
    return torch.where(hit, t, miss)


def ray_sphere_hit(o, d, center, radius):
    """Receiver-sphere hit of unit-direction rays (N, 3): smallest t >
    T_MIN_EPS, MISS on a miss (forward of rfx.ops.intersect.ray_sphere_hit)."""
    center = torch.as_tensor(center, dtype=torch.float32, device=o.device)
    r = torch.as_tensor(radius, dtype=torch.float32, device=o.device)
    return sphere_t(o, d, center, r * r)
